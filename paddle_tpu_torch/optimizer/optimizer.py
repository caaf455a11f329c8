"""Optimizers: minimize = append_backward + update ops.

Port of ``paddle_tpu/optimizer/optimizer.py`` (static graph): ``Optimizer``,
``SGD``, ``Adam``, ``AdamW`` and ``state_dict``/``set_state_dict``. The
update rules are op lowerings (``ops/optimizer_ops.py``; Adam and AdamW
run the fused CUDA kernel). The learning rate is an auto-feed of the
program: ``Executor.run`` copies the current value to the device each
step, so an LR scheduler adds no ops. Accumulators of bf16/fp16 params
are fp32.

Not ported yet, and each raises ``errors.Unimplemented``: ``grad_clip``,
``weight_decay`` regularizers (AdamW's decoupled ``weight_decay`` is the
update op's own and is ported), the dygraph ``step``, and the
data-parallel comms residuals of the optimizer checkpoint.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

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
        if weight_decay is not None:
            raise _unported("weight_decay regularizers", "A5")
        if grad_clip is not None:
            raise _unported("grad_clip", "A5")
        self._learning_rate = learning_rate
        self._parameter_list = (list(parameters) if parameters is not None
                                else None)
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
        main = params_grads[0][0].block.program
        lr_var = self._create_global_learning_rate(main)
        block = main.global_block()
        for p, g in params_grads:
            self._append_optimize_op(block, (p, g), lr_var)
        return params_grads

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        self.apply_gradients(params_grads)
        return None, params_grads

    def step(self):
        raise _unported("the dygraph optimizer step", "A8")

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
                val = scope.get(var.name)
                if val is None:
                    continue
                if isinstance(val, torch.Tensor):
                    t = val.detach()
                    val = (t.float() if t.dtype == torch.bfloat16 else t
                           ).cpu().numpy()
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
