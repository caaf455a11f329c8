"""Desc-level autodiff: append_backward / gradients.

Port of ``paddle_tpu/framework/backward.py``: walks the block's ops in
reverse, emits one ``<op>_grad`` op per differentiated forward op, seeds
the loss gradient with a ``fill_constant(1.0)``, and sums duplicated
gradients (``_GradAccumulator``; the tied ``gpt.wte`` gets one partial
from the embedding lookup and one from the lm head). The op list is the
JAX package's op for op. Grad ops take the generic rule of
``registry.py``, which differentiates the forward op's taped run instead
of recomputing it.

``append_backward_with_checkpoints`` is activation recompute, the JAX
package's op for op: only the checkpoints are kept from the forward;
each segment between two checkpoints is re-emitted (``_clone_segment``:
clones with renamed outputs, every input read through a
``recompute_barrier``) right before that segment's grad ops, which read
the clones. In the port the grad ops take the clones' taped records, so
the original forward ops of a segment run off the tape and the
executor's liveness frees their outputs after their last forward
reader; a grad op whose forward op the clone skips (every output a
checkpoint) runs its forward rule again on the recomputed inputs
(``executor.Executor._forward_of``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import core, registry, unique_name
from .program import Block, Parameter, Variable
from .registry import GRAD_SUFFIX, OUT_PREFIX, grad_var_name


def _is_float_var(var: Variable) -> bool:
    return core.is_floating(var.dtype)


def _create_grad_var(block: Block, ref_var: Variable, name: str) -> Variable:
    return block.create_var(name=name, shape=ref_var.shape,
                            dtype=ref_var.dtype, persistable=False,
                            stop_gradient=True)


def _compute_grad_needed(block: Block, start: Set[str],
                         no_grad: Set[str]) -> Set[str]:
    """Forward-propagate "this var needs a gradient" from the leaves."""
    needed = set(start) - no_grad
    for op in block.ops:
        try:
            opdef = registry.get_op_def(op.type)
        except NotImplementedError:
            continue
        if opdef.stop_gradient:
            continue
        if any(n in needed for n in op.input_arg_names()):
            for n in op.output_arg_names():
                var = block._find_var_recursive(n)
                if (var is not None and not var.stop_gradient
                        and n not in no_grad):
                    needed.add(n)
    return needed


def _diff_input_slots(op, opdef) -> List[str]:
    """Slots eligible for gradients: float-typed and not opted out."""
    slots = []
    for slot, vs in op._input_vars.items():
        if slot in opdef.no_grad_inputs or not vs:
            continue
        if all(_is_float_var(v) for v in vs):
            slots.append(slot)
    return slots


class _GradAccumulator:
    """Collects partial gradients per forward var; emits ``sum`` ops on
    finalization."""

    def __init__(self, block: Block):
        self.block = block
        self.partials: Dict[str, List[Variable]] = {}
        self.final: Dict[str, Variable] = {}

    def add_partial(self, fwd_name: str, grad_var: Variable) -> None:
        self.partials.setdefault(fwd_name, []).append(grad_var)
        self.final.pop(fwd_name, None)

    def has(self, fwd_name: str) -> bool:
        return fwd_name in self.partials or fwd_name in self.final

    def set_final(self, fwd_name: str, grad_var: Variable) -> None:
        self.final[fwd_name] = grad_var
        self.partials.pop(fwd_name, None)

    def finalize(self, fwd_name: str) -> Optional[Variable]:
        if fwd_name in self.final:
            return self.final[fwd_name]
        parts = self.partials.get(fwd_name)
        if not parts:
            return None
        if len(parts) == 1:
            out = parts[0]
        else:
            out = _create_grad_var(self.block, parts[0],
                                   grad_var_name(fwd_name))
            if out.name in (p.name for p in parts):
                out = self.block.create_var(
                    name=unique_name.generate(
                        grad_var_name(fwd_name) + "@SUM"),
                    shape=parts[0].shape, dtype=parts[0].dtype,
                    stop_gradient=True)
            self.block.append_op("sum", inputs={"X": parts},
                                 outputs={"Out": out})
        self.final[fwd_name] = out
        self.partials.pop(fwd_name, None)
        return out


def _resolve_params_and_no_grad(
    loss: Variable, parameter_list: Optional[Sequence],
    no_grad_set: Optional[Set[str]],
) -> Tuple[List[Variable], Set[str]]:
    """The effective no-grad set (explicit + stop_gradient
    non-parameters) and the trainable params."""
    block = loss.block
    program = block.program
    no_grad = set(no_grad_set or ())
    for var in program.list_vars():
        if var.stop_gradient and not isinstance(var, Parameter):
            no_grad.add(var.name)
    if parameter_list is not None:
        params = [p if isinstance(p, Variable) else block.var(str(p))
                  for p in parameter_list]
    else:
        params = [p for p in program.all_parameters()
                  if getattr(p, "trainable", True)]
    params = [p for p in params
              if not p.stop_gradient and p.name not in no_grad]
    return params, no_grad


def _seed_target_grad(block: Block, t: Variable) -> Variable:
    """fill_constant(1.0) seed for a target's gradient."""
    seed = block.create_var(name=unique_name.generate(grad_var_name(t.name)),
                            shape=t.shape, dtype=t.dtype, stop_gradient=True)
    block.append_op("fill_constant", outputs={"Out": seed},
                    attrs={"shape": list(t.shape), "value": 1.0,
                           "dtype": core.dtype_name(t.dtype)})
    return seed


def append_backward(loss: Variable, parameter_list: Optional[Sequence] = None,
                    no_grad_set: Optional[Set[str]] = None,
                    callbacks=None) -> List[Tuple[Parameter, Variable]]:
    """Append grad ops for ``loss`` to its block; return [(param, grad)]."""
    params, no_grad = _resolve_params_and_no_grad(loss, parameter_list,
                                                  no_grad_set)
    grads = calc_gradient(targets=[loss], inputs=params, no_grad_set=no_grad)
    return [(p, g) for p, g in zip(params, grads) if g is not None]


def append_backward_with_checkpoints(loss: Variable, checkpoints: Sequence,
                                     parameter_list: Optional[Sequence] = None,
                                     no_grad_set: Optional[Set[str]] = None
                                     ) -> List[Tuple[Parameter, Variable]]:
    """``append_backward`` with activation recomputation between
    checkpoints (see the module docstring). No checkpoint that the block
    produces means the plain backward."""
    block = loss.block
    params, no_grad = _resolve_params_and_no_grad(loss, parameter_list,
                                                  no_grad_set)
    fwd_ops = list(block.ops)
    produced_at: Dict[str, int] = {}
    for i, op in enumerate(fwd_ops):
        for n in op.output_arg_names():
            produced_at[n] = i
    ck_names = [c.name if isinstance(c, Variable) else str(c)
                for c in checkpoints]
    ck_names = [c for c in ck_names if c in produced_at]
    ck_names.sort(key=lambda c: produced_at[c])
    if not ck_names:
        return append_backward(loss, parameter_list, no_grad_set)
    saved = set(ck_names)

    leaf_names = {p.name for p in params}
    grad_needed = _compute_grad_needed(block, leaf_names, no_grad)
    influencing = {loss.name}
    for op in reversed(fwd_ops):
        if any(n in influencing for n in op.output_arg_names()):
            influencing.update(op.input_arg_names())

    acc = _GradAccumulator(block)
    acc.set_final(loss.name, _seed_target_grad(block, loss))

    # the tail after the last checkpoint: the plain backward
    last = produced_at[ck_names[-1]]
    _backward_over_ops(block, fwd_ops[last + 1:], acc, grad_needed, no_grad,
                       influencing)

    # segment i covers fwd_ops[bounds[i]:bounds[i + 1]]; ck_names[i] is
    # produced by its last op
    bounds = [0] + [produced_at[c] + 1 for c in ck_names]
    for i in reversed(range(len(bounds) - 1)):
        seg_ops = fwd_ops[bounds[i]:bounds[i + 1]]
        dep = acc.finalize(ck_names[i])  # the cotangent entering the segment
        var_subst = _clone_segment(block, seg_ops, saved, dep)
        _backward_over_ops(block, seg_ops, acc, grad_needed, no_grad,
                           influencing, var_subst=var_subst)

    grads = [acc.finalize(p.name) for p in params]
    return [(p, g) for p, g in zip(params, grads) if g is not None]


def _clone_segment(block: Block, seg_ops, saved: Set[str],
                   dep: Optional[Variable]) -> Dict[str, Variable]:
    """Re-emit ``seg_ops`` with renamed outputs, each boundary input read
    through a ``recompute_barrier`` (with ``Dep``, the segment's incoming
    cotangent, unless the input is a parameter or persistable). Returns
    original name -> clone (checkpoints stay on their saved originals: a
    clone's copy of one goes to a throwaway). An op whose every output is
    saved is not cloned. A random op's clone keeps its attrs (its
    ``_rng_id``), so it redraws the forward's numbers."""
    subst: Dict[str, Variable] = {}
    barriered: Dict[str, Variable] = {}
    internal = set()
    for op in seg_ops:
        internal.update(op.output_arg_names())

    def boundary(v: Variable) -> Variable:
        if v.name in barriered:
            return barriered[v.name]
        out = block.create_var(
            name=unique_name.generate(v.name + "@RECOMPUTE.in"),
            shape=v.shape, dtype=v.dtype, stop_gradient=True)
        ins = {"X": [v]}
        if dep is not None and not (isinstance(v, Parameter)
                                    or v.persistable):
            ins["Dep"] = [dep]
        block.append_op("recompute_barrier", inputs=ins,
                        outputs={"Out": [out]})
        barriered[v.name] = out
        return out

    for op in seg_ops:
        if all(n in saved for n in op.output_arg_names()):
            continue
        new_inputs: Dict[str, List[Variable]] = {}
        for slot, vs in op._input_vars.items():
            vals = []
            for v in vs:
                if v.name in subst:
                    vals.append(subst[v.name])
                elif v.name in internal and v.name not in saved:
                    vals.append(v)  # produced later in the segment
                else:
                    vals.append(boundary(v))
            new_inputs[slot] = vals
        new_outputs: Dict[str, List[Variable]] = {}
        for slot, vs in op._output_vars.items():
            vals = []
            for v in vs:
                suffix = "@RECOMPUTE.dup" if v.name in saved else "@RECOMPUTE"
                nv = block.create_var(
                    name=unique_name.generate(v.name + suffix),
                    shape=v.shape, dtype=v.dtype, stop_gradient=True)
                if v.name not in saved:
                    subst[v.name] = nv
                vals.append(nv)
            new_outputs[slot] = vals
        block.append_op(op.type, inputs=new_inputs, outputs=new_outputs,
                        attrs=op.all_attrs())
    return subst


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    return calc_gradient(targets, inputs, target_gradients,
                         set(no_grad_set or ()))


def calc_gradient(targets: Sequence[Variable], inputs: Sequence[Variable],
                  target_gradients: Optional[Sequence[Variable]] = None,
                  no_grad_set: Optional[Set[str]] = None
                  ) -> List[Optional[Variable]]:
    block = targets[0].block
    no_grad = set(no_grad_set or ())
    leaf_names = {v.name for v in inputs}
    grad_needed = _compute_grad_needed(block, leaf_names, no_grad)
    target_names = {t.name for t in targets}

    # vars that actually influence the targets (reverse reachability)
    influencing = set(target_names)
    fwd_ops = list(block.ops)
    for op in reversed(fwd_ops):
        if any(n in influencing for n in op.output_arg_names()):
            influencing.update(op.input_arg_names())

    acc = _GradAccumulator(block)
    for i, t in enumerate(targets):
        if (target_gradients is not None and i < len(target_gradients)
                and target_gradients[i] is not None):
            acc.set_final(t.name, target_gradients[i])
        else:
            acc.set_final(t.name, _seed_target_grad(block, t))

    _backward_over_ops(block, fwd_ops, acc, grad_needed, no_grad,
                       influencing)
    return [acc.finalize(v.name) for v in inputs]


def _backward_over_ops(block: Block, fwd_ops, acc: _GradAccumulator,
                       grad_needed: Set[str], no_grad: Set[str],
                       influencing: Set[str],
                       var_subst: Optional[Dict[str, Variable]] = None
                       ) -> None:
    """Reverse-walk ``fwd_ops`` emitting grad ops into ``block``.
    ``var_subst`` maps forward var names to the Variables the grad ops
    read instead (a recomputed segment's clones), while the gradients
    stay keyed on the original names."""
    sub = var_subst or {}

    def s(v: Variable) -> Variable:
        return sub.get(v.name, v)

    for op in reversed(list(fwd_ops)):
        try:
            opdef = registry.get_op_def(op.type)
        except NotImplementedError:
            continue
        if opdef.stop_gradient:
            continue
        out_names = op.output_arg_names()
        if not any(acc.has(n) for n in out_names):
            continue
        in_names = op.input_arg_names()
        if not any(n in grad_needed for n in in_names):
            continue
        if not any(n in influencing for n in out_names):
            continue

        # wire the generic grad op
        g_inputs: Dict[str, List[Variable]] = {}
        for slot, vs in op._input_vars.items():
            if vs:
                g_inputs[slot] = [s(v) for v in vs]
        for slot, vs in op._output_vars.items():
            if vs:
                g_inputs[OUT_PREFIX + slot] = [s(v) for v in vs]
        any_out_grad = False
        for slot, vs in op._output_vars.items():
            if not all(_is_float_var(v) for v in vs):
                continue  # integer outputs carry no cotangent
            gvars = []
            for v in vs:
                g = acc.finalize(v.name)
                if g is None:
                    g = _create_grad_var(block, v, unique_name.generate(
                        grad_var_name(v.name) + "@ZERO"))
                    block.append_op("fill_zeros_like", inputs={"X": s(v)},
                                    outputs={"Out": g})
                else:
                    any_out_grad = True
                gvars.append(g)
            if gvars:
                g_inputs[slot + GRAD_SUFFIX] = gvars
        if not any_out_grad:
            continue

        g_outputs: Dict[str, List[Variable]] = {}
        record: List[Tuple[str, Variable]] = []
        for slot in _diff_input_slots(op, opdef):
            gvars = []
            for v in op._input_vars[slot]:
                gv = _create_grad_var(block, v, unique_name.generate(
                    grad_var_name(v.name) + "@RENAME"))
                gvars.append(gv)
                if v.name in grad_needed and v.name not in no_grad:
                    record.append((v.name, gv))
            g_outputs[slot + GRAD_SUFFIX] = gvars
        if not g_outputs:
            continue

        block.append_op(op.type + "_grad", inputs=g_inputs,
                        outputs=g_outputs, attrs=op.all_attrs())
        for fwd_name, gv in record:
            acc.add_partial(fwd_name, gv)
