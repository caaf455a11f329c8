"""Static-graph mixed precision: the program rewrite and the decorated
optimizer.

Port of ``paddle_tpu/static/amp.py``: ``AutoMixedPrecisionLists``,
``rewrite_program`` (a cast before each white-list op's floating inputs
to the compute dtype, before each black-list op's to fp32, one cast a
variable and dtype), ``OptimizerWithMixedPrecision`` (the loss scaled by
the persistable ``@AMP.loss_scaling``; ``check_finite_and_unscale`` over
every gradient; ``update_loss_scaling`` when the scale is dynamic; the
inner optimizer's writes to persistables gated on the found-inf flag, so
an overflow step leaves every parameter and accumulator as it was) and
``decorate``. Parameters stay fp32 in the scope: the casts sit in the
forward program, and the backward differentiates through them, so the
gradients come back fp32.

One difference is kept on purpose. The rewrite rewires an op's inputs by
identity. The JAX package decides whether to rewire with ``new_vs != vs``
on two lists of Variables; with ``import paddle_tpu`` the static
``Variable``'s ``==`` appends an ``equal`` op and returns a Variable,
which is truthy, so the lists compare equal, no input is rewired and its
casts are dead: its white-list ops keep computing in fp32, and each
rewritten op leaves two stray ``equal`` ops in the program. The port's
white-list ops read the casts (bf16 compute), and no ``equal`` op is
added.
"""
from __future__ import annotations

from typing import Dict, Set

from ..amp import BLACK_LIST, WHITE_LIST
from ..framework import core, unique_name
from ..framework.initializer import ConstantInitializer

__all__ = ["AutoMixedPrecisionLists", "OptimizerWithMixedPrecision",
           "decorate", "rewrite_program"]

_FLOATS = ("float32", "float64", "bfloat16", "float16")


class AutoMixedPrecisionLists:
    """The white list (computed in the compute dtype) and the black list
    (computed in fp32), each with the caller's additions."""

    def __init__(self, custom_white_list=None, custom_black_list=None):
        self.white_list: Set[str] = (set(WHITE_LIST)
                                     | set(custom_white_list or ()))
        self.black_list: Set[str] = (set(BLACK_LIST)
                                     | set(custom_black_list or ()))


def _dtype(var) -> str:
    return core.dtype_name(var.dtype)


def rewrite_program(program, amp_lists: AutoMixedPrecisionLists,
                    dest_dtype: str = "bfloat16") -> int:
    """Insert the casts that make white-list ops compute in
    ``dest_dtype`` and black-list ops in fp32. Runs on the forward-only
    program (the backward then differentiates through the casts).
    Returns the number of casts inserted."""
    block = program.global_block()
    n_casts = 0
    # var name -> its cast to the key's dtype (each var is cast once)
    cast_cache: Dict[str, Dict[str, str]] = {"bf16": {}, "fp32": {}}

    def cast_input(i, var, to_dtype, key):
        nonlocal n_casts
        cached = cast_cache[key].get(var.name)
        if cached is not None:
            return block._find_var_recursive(cached), 0
        out = block.create_var(
            name=unique_name.generate(var.name + f".cast_{key}"),
            shape=var.shape, dtype=to_dtype, stop_gradient=var.stop_gradient)
        block._insert_op(i, "cast", inputs={"X": [var]},
                         outputs={"Out": [out]},
                         attrs={"in_dtype": _dtype(var),
                                "out_dtype": to_dtype})
        cast_cache[key][var.name] = out.name
        n_casts += 1
        return out, 1

    i = 0
    while i < len(block.ops):
        op = block.ops[i]
        if op.type in amp_lists.white_list:
            to, key = dest_dtype, "bf16"
        elif op.type in amp_lists.black_list:
            to, key = "float32", "fp32"
        else:
            i += 1
            continue
        inserted = 0
        for slot, vs in list(op._input_vars.items()):
            new_vs = []
            for v in vs:
                if v is not None and _dtype(v) in _FLOATS and _dtype(v) != to:
                    nv, k = cast_input(i, v, to, key)
                    inserted += k
                    new_vs.append(nv)
                else:
                    new_vs.append(v)
            # by identity: Variable's == is an op of its own
            if any(a is not b for a, b in zip(new_vs, vs)):
                op._input_vars[slot] = new_vs
                op.desc.inputs = [
                    (p, [v.name for v in new_vs]) if p == slot else (p, a)
                    for p, a in op.desc.inputs]
        # the op now computes in `to`; retag its float outputs
        for vs in op._output_vars.values():
            for v in vs:
                if _dtype(v) in _FLOATS:
                    v.dtype = to
        i += 1 + inserted
    program._bump_version()
    return n_casts


class OptimizerWithMixedPrecision:
    """``minimize``: (1) the cast rewrite of the forward program, (2) the
    loss times the loss scale, (3) the backward through the scaled loss,
    (4) ``check_finite_and_unscale`` over every gradient, (5)
    ``update_loss_scaling`` (dynamic scaling), (6) the inner optimizer on
    the unscaled gradients, each write to a persistable gated on the
    found-inf flag."""

    def __init__(self, optimizer, amp_lists=None,
                 init_loss_scaling=2.0 ** 15, use_dynamic_loss_scaling=True,
                 incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
                 incr_ratio=2.0, decr_ratio=0.5, dest_dtype="bfloat16"):
        self._inner = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._dest_dtype = dest_dtype
        # bf16 has fp32's exponent range: scaling is fp16's safety net
        self._use_scaling = (use_dynamic_loss_scaling
                             or dest_dtype == "float16")
        self._init_scale = float(init_loss_scaling)
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._state = None

    def __getattr__(self, item):
        return getattr(self._inner, item)

    def rewrite_forward(self, loss):
        """Steps 1-2; returns the scaled loss."""
        program = loss.block.program
        block = program.global_block()
        rewrite_program(program, self._amp_lists, self._dest_dtype)

        def persistable(name, value):
            v = block.create_var(name=name, shape=[1], dtype="float32",
                                 persistable=True, stop_gradient=True)
            ConstantInitializer(value)(v)
            return v

        scaling = persistable("@AMP.loss_scaling", self._init_scale)
        good = persistable("@AMP.good_steps", 0.0)
        bad = persistable("@AMP.bad_steps", 0.0)
        scaled = block.create_var(
            name=unique_name.generate(loss.name + ".scaled"),
            shape=loss.shape, dtype=loss.dtype)
        block.append_op("elementwise_mul",
                        inputs={"X": [loss], "Y": [scaling]},
                        outputs={"Out": [scaled]}, attrs={"axis": -1})
        self._state = (scaled, scaling, good, bad)
        return scaled

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from ..framework.backward import append_backward

        if self._state is None or loss is not self._state[0]:
            loss = self.rewrite_forward(loss)
        return append_backward(loss, parameter_list=parameter_list,
                               no_grad_set=no_grad_set)

    def apply_gradients(self, params_grads):
        """Steps 4-6."""
        scaled, scaling, good, bad = self._state
        return self._apply_gradients_impl(scaled.block, params_grads,
                                          scaling, good, bad)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        return self.apply_gradients(params_grads)

    def _apply_gradients_impl(self, block, params_grads, scaling, good, bad):
        kept = [(p, g) for p, g in params_grads if g is not None]
        grads = [g for _, g in kept]
        found_inf = block.create_var(
            name=unique_name.generate("@AMP.found_inf"), shape=[1],
            dtype="bool", stop_gradient=True)
        unscaled = [block.create_var(
            name=unique_name.generate(g.name + ".unscaled"), shape=g.shape,
            dtype=g.dtype, stop_gradient=True) for g in grads]
        block.append_op("check_finite_and_unscale",
                        inputs={"X": grads, "Scale": [scaling]},
                        outputs={"Out": unscaled,
                                 "FoundInfinite": [found_inf]})
        if self._use_scaling:
            block.append_op(
                "update_loss_scaling",
                inputs={"X": [], "FoundInfinite": [found_inf],
                        "PrevLossScaling": [scaling], "InGoodSteps": [good],
                        "InBadSteps": [bad]},
                outputs={"Out": [], "LossScaling": [scaling],
                         "OutGoodSteps": [good], "OutBadSteps": [bad]},
                attrs={"incr_every_n_steps": self._incr_every,
                       "decr_every_n_nan_or_inf": self._decr_every,
                       "incr_ratio": self._incr_ratio,
                       "decr_ratio": self._decr_ratio})
        new_pg = [(p, u) for (p, _), u in zip(kept, unscaled)]
        n_before = len(block.ops)
        self._inner.apply_gradients(new_pg)

        # gate the optimizer's writes on !found_inf: each persistable an
        # op writes is saved before it and chosen after it (temporaries of
        # clip and decay have no value before their op, and only the
        # persistable state must survive an overflow)
        i = n_before
        while i < len(block.ops):
            op = block.ops[i]
            out_vars = [v for vs in op._output_vars.values() for v in vs
                        if getattr(v, "persistable", False)]
            if not out_vars or op.type == "fill_constant":
                i += 1
                continue
            saves = []
            for v in out_vars:
                old = block.create_var(
                    name=unique_name.generate(v.name + "@AMP.old"),
                    shape=v.shape, dtype=v.dtype, stop_gradient=True)
                block._insert_op(i, "assign", inputs={"X": [v]},
                                 outputs={"Out": [old]})
                saves.append((v, old))
                i += 1
            i += 1  # past the optimizer op
            for v, old in saves:
                block._insert_op(i, "where",
                                 inputs={"Condition": [found_inf],
                                         "X": [old], "Y": [v]},
                                 outputs={"Out": [v]})
                i += 1
        return None, new_pg


def decorate(optimizer, amp_lists=None, init_loss_scaling=2.0 ** 15,
             use_dynamic_loss_scaling=True, dest_dtype="bfloat16", **kw):
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists=amp_lists, init_loss_scaling=init_loss_scaling,
        use_dynamic_loss_scaling=use_dynamic_loss_scaling,
        dest_dtype=dest_dtype, **kw)
