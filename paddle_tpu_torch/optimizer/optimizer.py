"""Optimizers: minimize = append_backward + update ops.

Port of ``paddle_tpu/optimizer/optimizer.py`` (static graph): ``Optimizer``,
``SGD``, ``Momentum``, ``Adagrad``, ``Adam``, ``AdamW``, ``Adamax``,
``RMSProp``, ``Adadelta``, ``Lamb``, ``LarsMomentum``,
``DGCMomentumOptimizer`` and ``state_dict``/``set_state_dict``. The
update rules are op lowerings (``ops/optimizer_ops.py``; Adam and AdamW
run the fused CUDA kernel, the others plain torch, as they are plain
``jnp`` in the JAX package). The learning rate is an auto-feed of the
program: ``Executor.run`` copies the current value to the device each
step, so an LR scheduler adds no ops. Accumulators of bf16/fp16 params
are fp32, under the JAX package's names (``<param>_<name>_<k>``).
``apply_gradients`` first adds the ``weight_decay`` regularizers' terms
(``regularizer.py``), then clips (``grad_clip``, ``nn/clip.py``), as the
JAX package's ``_apply_decay_and_clip`` does.

In dygraph mode (``parameters=`` given, the eager API) ``step`` emits
the same update ops through the tracer (``dygraph/base.py:
_apply_dygraph_update``; ``adam`` runs the fused kernel), the
accumulators are eager Tensors on the parameter's device (fp32 under
bf16/fp16 parameters), and ``state_dict``/``set_state_dict`` read and
write their values.

Not ported yet, and it raises ``errors.Unimplemented``: the
data-parallel comms residuals of the optimizer checkpoint (A10).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..framework import core
from ..framework import errors as _errs
from ..framework import program as framework
from ..framework import unique_name
from ..framework.backward import append_backward
from ..framework.initializer import ConstantInitializer
from ..framework.scope import global_scope
from .lr import LRScheduler


def _unported(what: str, item: str) -> _errs.UnimplementedError:
    return _errs.errors.Unimplemented(
        f"{what} is not ported to paddle_tpu_torch yet (ROADMAP.md queue A, "
        f"item {item})")


class Optimizer:
    _op_type: str = None

    def __init__(self, learning_rate=0.001,
                 parameters: Optional[Sequence] = None, weight_decay=None,
                 grad_clip=None, name: Optional[str] = None):
        self._learning_rate = learning_rate
        self._parameter_list = (list(parameters) if parameters is not None
                                else None)
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._name = name or unique_name.generate(
            self.__class__.__name__.lower())
        self._accumulators: Dict[str, Dict[str, framework.Variable]] = {}
        self._lr_var: Optional[framework.Variable] = None
        self.helper = None

    # -- learning rate -------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value: float):
        self._learning_rate = float(value)

    def _create_global_learning_rate(self, program) -> framework.Variable:
        if self._lr_var is not None and self._lr_var.block.program is program:
            return self._lr_var
        name = unique_name.generate(f"{self._name}_lr")
        block = program.global_block()
        self._lr_var = block.create_var(name=name, shape=(), dtype="float32",
                                        stop_gradient=True)
        # the LR arrives as an auto-feed each step: a scheduler's new
        # value needs no change to the program
        if not hasattr(program, "_extra_feeds"):
            program._extra_feeds = {}
        program._extra_feeds[name] = lambda: np.float32(self.get_lr())
        return self._lr_var

    # -- accumulators --------------------------------------------------
    def _add_accumulator(self, name, param, fill_value=0.0, shape=None,
                         dtype=None):
        if name in self._accumulators and param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        # optimizer state stays fp32 under bf16/fp16 params (the bf16 ulp
        # is far too coarse for the second moment and the beta powers)
        if dtype is None and param.dtype in (torch.bfloat16, torch.float16):
            dtype = "float32"
        if framework.in_dygraph_mode():
            from ..dygraph.varbase import Tensor

            acc = Tensor(torch.full(
                tuple(shape if shape is not None else param.shape),
                fill_value, dtype=core.convert_dtype(dtype or param.dtype),
                device=param.place),
                name=unique_name.generate(f"{param.name}_{name}"),
                persistable=True)
            self._accumulators.setdefault(name, {})[param.name] = acc
            return acc
        block = param.block.program.global_block()
        var = block.create_var(
            name=unique_name.generate(f"{param.name}_{name}"),
            shape=shape if shape is not None else param.shape,
            dtype=dtype or param.dtype, persistable=True, stop_gradient=True)
        ConstantInitializer(fill_value)(var)
        self._accumulators.setdefault(name, {})[param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # -- main entry points ---------------------------------------------
    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params = parameter_list or self._parameter_list
        return append_backward(loss, parameter_list=params,
                               no_grad_set=no_grad_set)

    def apply_gradients(self, params_grads: List[Tuple]):
        params_grads = self._apply_decay_and_clip(params_grads)
        main = params_grads[0][0].block.program
        lr_var = self._create_global_learning_rate(main)
        block = main.global_block()
        for p, g in params_grads:
            self._append_optimize_op(block, (p, g), lr_var)
        return params_grads

    def _apply_decay_and_clip(self, params_grads):
        """The regularizers' decay terms first, then the clip."""
        from ..nn.clip import append_gradient_clip
        from ..regularizer import append_regularization_grads

        params_grads = append_regularization_grads(params_grads,
                                                   self._weight_decay)
        return append_gradient_clip(params_grads, self._grad_clip)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        self.apply_gradients(params_grads)
        return None, params_grads

    # -- dygraph API ----------------------------------------------------
    def step(self):
        from ..dygraph import base as dybase

        params = self._parameter_list
        if params is None:
            raise ValueError("a dygraph optimizer needs `parameters`")
        pg = [(p, p.grad) for p in params
              if p.grad is not None and p.trainable]
        if pg:
            dybase._apply_dygraph_update(self, pg)

    def clear_grad(self):
        for p in self._parameter_list or ():
            p.clear_grad()

    clear_gradients = clear_grad

    def _append_optimize_op(self, block, param_and_grad, lr_var):
        raise NotImplementedError

    # -- state dict -----------------------------------------------------
    def state_dict(self, scope=None) -> Dict[str, np.ndarray]:
        """Every accumulator's value from ``scope`` (the global scope by
        default) as numpy, under its variable name; bf16 widens to fp32."""
        scope = scope or global_scope()
        state = {}
        for per_param in self._accumulators.values():
            for var in per_param.values():
                # an eager accumulator carries its value; a static one
                # lives in the scope
                val = getattr(var, "_value", None)
                if val is None:
                    val = scope.get(var.name)
                if val is None:
                    continue
                if isinstance(val, torch.Tensor):
                    val = core.host_numpy(val)
                state[var.name] = np.asarray(val)
        if isinstance(self._learning_rate, LRScheduler):
            state["LR_Scheduler"] = self._learning_rate.state_dict()
        return state

    def set_state_dict(self, state, scope=None) -> None:
        """Put the accumulators of ``state`` back into ``scope``, on the
        device and in the dtype of the value there (numpy as it is where
        the scope has none yet; the executor places it at its next run)."""
        if "__dp_comms__" in state:
            raise _unported("data-parallel comms residuals", "A10")
        scope = scope or global_scope()
        for per_param in self._accumulators.values():
            for var in per_param.values():
                if var.name not in state:
                    continue
                val = np.asarray(state[var.name])
                cur = getattr(var, "_value", None)
                if cur is None:
                    cur = scope.get(var.name)
                if isinstance(cur, torch.Tensor):
                    cur.copy_(torch.from_numpy(np.ascontiguousarray(val)))
                else:
                    scope.set(var.name, val)
        if (isinstance(self._learning_rate, LRScheduler)
                and "LR_Scheduler" in state):
            self._learning_rate.set_state_dict(state["LR_Scheduler"])


class SGD(Optimizer):
    def _append_optimize_op(self, block, pg, lr_var):
        p, g = pg
        block.append_op("sgd",
                        inputs={"Param": p, "Grad": g, "LearningRate": lr_var},
                        outputs={"ParamOut": p})


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9,
                 use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _append_optimize_op(self, block, pg, lr_var):
        p, g = pg
        vel = self._add_accumulator("velocity", p)
        block.append_op(
            "momentum",
            inputs={"Param": p, "Grad": g, "Velocity": vel,
                    "LearningRate": lr_var},
            outputs={"ParamOut": p, "VelocityOut": vel},
            attrs={"mu": self._momentum,
                   "use_nesterov": self._use_nesterov})


class Adagrad(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6,
                 initial_accumulator_value=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _append_optimize_op(self, block, pg, lr_var):
        p, g = pg
        moment = self._add_accumulator("moment", p,
                                       fill_value=self._init_acc)
        block.append_op(
            "adagrad",
            inputs={"Param": p, "Grad": g, "Moment": moment,
                    "LearningRate": lr_var},
            outputs={"ParamOut": p, "MomentOut": moment},
            attrs={"epsilon": self._epsilon})


class Adam(Optimizer):
    _update_op = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _op_attrs(self):
        return {"beta1": self._beta1, "beta2": self._beta2,
                "epsilon": self._epsilon}

    def _accumulators_of(self, p):
        return (self._add_accumulator("moment1", p),
                self._add_accumulator("moment2", p),
                self._add_accumulator("beta1_pow", p, fill_value=self._beta1,
                                      shape=[1]),
                self._add_accumulator("beta2_pow", p, fill_value=self._beta2,
                                      shape=[1]))

    def _append_update(self, block, p, g, lr_var, attrs):
        m1, m2, b1p, b2p = self._accumulators_of(p)
        block.append_op(
            self._update_op,
            inputs={"Param": p, "Grad": g, "LearningRate": lr_var,
                    "Moment1": m1, "Moment2": m2, "Beta1Pow": b1p,
                    "Beta2Pow": b2p},
            outputs={"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2,
                     "Beta1PowOut": b1p, "Beta2PowOut": b2p},
            attrs=attrs)

    def _append_optimize_op(self, block, pg, lr_var):
        p, g = pg
        self._append_update(block, p, g, lr_var, self._op_attrs())


class AdamW(Adam):
    _update_op = "adamw"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, weight_decay=0.01,
                 apply_decay_param_fun=None, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, **kw)
        self._coeff = weight_decay
        self._decay_fn = apply_decay_param_fun

    def _append_optimize_op(self, block, pg, lr_var):
        p, g = pg
        decay = self._decay_fn is None or self._decay_fn(p.name)
        coeff = self._coeff if decay else 0.0
        self._append_update(block, p, g, lr_var,
                            {**self._op_attrs(), "coeff": coeff,
                             "with_decay": bool(coeff)})


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _append_optimize_op(self, block, pg, lr_var):
        p, g = pg
        m = self._add_accumulator("moment", p)
        inf = self._add_accumulator("inf_norm", p)
        b1p = self._add_accumulator("beta1_pow", p, fill_value=self._beta1,
                                    shape=[1])
        block.append_op(
            "adamax",
            inputs={"Param": p, "Grad": g, "LearningRate": lr_var,
                    "Moment": m, "InfNorm": inf, "Beta1Pow": b1p},
            outputs={"ParamOut": p, "MomentOut": m, "InfNormOut": inf},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})
        block.append_op("scale", inputs={"X": b1p}, outputs={"Out": b1p},
                        attrs={"scale": self._beta1})


class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _append_optimize_op(self, block, pg, lr_var):
        p, g = pg
        ms = self._add_accumulator("mean_square", p)
        mom = self._add_accumulator("momentum_acc", p)
        inputs = {"Param": p, "Grad": g, "LearningRate": lr_var,
                  "MeanSquare": ms, "Moment": mom}
        outputs = {"ParamOut": p, "MeanSquareOut": ms, "MomentOut": mom}
        if self._centered:
            mg = self._add_accumulator("mean_grad", p)
            inputs["MeanGrad"] = mg
            outputs["MeanGradOut"] = mg
        block.append_op(
            "rmsprop", inputs=inputs, outputs=outputs,
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum, "centered": self._centered})


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon = rho, epsilon

    def _append_optimize_op(self, block, pg, lr_var):
        p, g = pg
        sq = self._add_accumulator("avg_squared_grad", p)
        up = self._add_accumulator("avg_squared_update", p)
        block.append_op(
            "adadelta",
            inputs={"Param": p, "Grad": g, "LearningRate": lr_var,
                    "AvgSquaredGrad": sq, "AvgSquaredUpdate": up},
            outputs={"ParamOut": p, "AvgSquaredGradOut": sq,
                     "AvgSquaredUpdateOut": up},
            attrs={"rho": self._rho, "epsilon": self._epsilon})


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6,
                 exclude_from_weight_decay_fn=None, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _append_optimize_op(self, block, pg, lr_var):
        p, g = pg
        wd = 0.0 if (self._exclude_fn and self._exclude_fn(p)) else self._wd
        m1 = self._add_accumulator("moment1", p)
        m2 = self._add_accumulator("moment2", p)
        b1p = self._add_accumulator("beta1_pow", p, fill_value=self._beta1,
                                    shape=[1])
        b2p = self._add_accumulator("beta2_pow", p, fill_value=self._beta2,
                                    shape=[1])
        block.append_op(
            "lamb",
            inputs={"Param": p, "Grad": g, "LearningRate": lr_var,
                    "Moment1": m1, "Moment2": m2, "Beta1Pow": b1p,
                    "Beta2Pow": b2p},
            outputs={"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2,
                     "Beta1PowOut": b1p, "Beta2PowOut": b2p},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "weight_decay": wd})


class LarsMomentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _append_optimize_op(self, block, pg, lr_var):
        p, g = pg
        vel = self._add_accumulator("velocity", p)
        block.append_op(
            "lars_momentum",
            inputs={"Param": p, "Grad": g, "Velocity": vel,
                    "LearningRate": lr_var},
            outputs={"ParamOut": p, "VelocityOut": vel},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay})


class DGCMomentumOptimizer(Optimizer):
    """Deep Gradient Compression momentum: before ``rampup_begin_step``
    plain momentum; from it on, each gradient passes through the ``dgc``
    op (local momentum correction U, accumulation V, top-k sparsification
    with error feedback) and ``dgc_momentum`` applies the sparse gradient
    as SGD. The step counter is a persistable that an ``increment`` op
    advances on the device, and the ops test it with ``torch.where``, so
    a captured step switches at the right replay. As in the JAX package
    the sparse gradient stays a dense masked tensor, and a sparsity ladder
    (``rampup_step`` > 1 with several sparsities) raises."""

    def __init__(self, learning_rate, momentum, rampup_begin_step,
                 rampup_step=1, sparsity=(0.999,), use_nesterov=False,
                 num_trainers=None, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov
        self._rampup_begin_step = float(rampup_begin_step)
        self._sparsity = list(sparsity)
        if rampup_step and int(rampup_step) > 1 and len(self._sparsity) > 1:
            raise NotImplementedError(
                "DGCMomentumOptimizer: the sparsity warm-up schedule "
                "(rampup_step > 1 with a sparsity ladder) is not "
                "implemented; pass a single sparsity value")
        self._step_var = None

    def _get_step_var(self, block):
        if self._step_var is None:
            v = block.create_var(
                name=unique_name.generate("@DGC.current_step"), shape=[1],
                dtype="float32", persistable=True, stop_gradient=True)
            ConstantInitializer(0.0)(v)
            block.append_op("increment", inputs={"X": [v]},
                            outputs={"Out": [v]}, attrs={"step": 1.0})
            self._step_var = v
        return self._step_var

    def _append_optimize_op(self, block, pg, lr_var):
        p, g = pg
        step = self._get_step_var(block)
        u = self._add_accumulator("dgc_u", p)
        v = self._add_accumulator("dgc_v", p)
        vel = self._add_accumulator("velocity", p)
        ratio = 1.0 - self._sparsity[-1]
        sparse_g = block.create_var(
            name=unique_name.generate(g.name + "@DGC"), shape=g.shape,
            dtype=g.dtype, stop_gradient=True)
        gather = block.create_var(
            name=unique_name.generate(g.name + "@DGC.gather"),
            shape=g.shape, dtype=g.dtype, stop_gradient=True)
        kvar = block.create_var(
            name=unique_name.generate(g.name + "@DGC.k"), shape=[],
            dtype="float32", stop_gradient=True)
        block.append_op(
            "dgc",
            inputs={"U": [u], "V": [v], "Grad": [g], "current_step": [step]},
            outputs={"U_out": [u], "V_out": [v], "EncodeGrad": [sparse_g],
                     "Grad_out": [sparse_g], "GatherBuff": [gather],
                     "k": [kvar]},
            attrs={"m": self._momentum, "ratio": ratio,
                   "rampup_begin_step": self._rampup_begin_step})
        block.append_op(
            "dgc_momentum",
            inputs={"Param": [p], "Grad": [sparse_g], "Velocity": [vel],
                    "LearningRate": [lr_var], "current_step": [step]},
            outputs={"ParamOut": [p], "VelocityOut": [vel]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov,
                   "rampup_begin_step": self._rampup_begin_step})
