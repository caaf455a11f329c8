"""Dygraph tracer: eager op execution plus a tape for autodiff.

Port of ``paddle_tpu/dygraph/tracer.py`` (the reference imperative
Tracer, tracer.cc TraceOp and basic_engine.cc BasicEngine). Each op runs
as it is issued, through the same registry and lowering rules as a
static program (so ``fused_attention_tpu`` takes the flash kernels and
``adam`` the fused Adam kernel), and an op whose inputs need a gradient
is recorded twice: its desc goes into the tape ``Program``, and its run
goes on torch's autograd tape through ``LoweringContext.record`` (its
differentiable inputs as leaves, the autocast of ``amp`` inside the
record). ``loss.backward()`` runs the port's own ``calc_gradient`` on the
tape and then the appended grad ops through ``executor.lower_op``; each
generic grad op takes its forward op's record, as in the static path.
Autodiff therefore has one implementation (``framework/backward.py`` and
the generic grad of ``registry.py``).

- **No shape inference.** An eager op's outputs exist, so each tape
  variable takes its value's shape and dtype.
- **Memory.** The tape holds every recorded op's inputs and outputs
  (the env) and its autograd record until backward; the backward drops
  each value after its last reader (``executor.liveness``), and the tape
  is reset after it.
- **Random draws** are the counter-based hash of the static path
  (``registry.draw_bits``): the key is the tracer's (seed, step) pair
  and the op's ``_rng_id``, its order among the tape's random ops. The
  step advances at every tape reset (after ``backward``), so each
  training step draws new dropout masks. (The reference keeps one key:
  its eager masks repeat from step to step.)
- **Grad-ready hooks**: ``fn(leaf_name, grad)`` fires during backward
  the moment a leaf's last gradient op has run (the data-parallel comms
  overlap rides them).
- **Recording every op** (``record_all``): ``jit.save`` records one
  forward into the tape whether or not an op needs a gradient, and the
  tape ``Program`` becomes the saved program.
- **Observers** (``observers``): each callable there sees every traced
  op's input Tensors (``jit.StaticFunction`` learns which parameters a
  captured function reads).
- **Profiling**: under an active ``torch.profiler`` each op, forward and
  backward, runs inside the executor's ``paddle_op::<type>`` range.

Nothing touches the device until the first op: the lowering context is
made at a tape's first op.
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, List, Optional

import torch

from .. import amp as _amp
from ..framework import core, registry
from ..framework.backward import calc_gradient
from ..framework.program import Operator, Program, Variable
from ..framework.executor import op_range
from ..framework.registry import OUT_PREFIX, LoweringContext
from .varbase import Parameter, Tensor


def _as_list(v):
    if v is None:
        return []
    return list(v) if isinstance(v, (list, tuple)) else [v]


class Tracer:
    def __init__(self, seed: int = 0):
        self._seed = int(seed)
        self._step = 0
        self.training = True
        self.enable_grad = True
        # record every op into the tape, gradient or not (jit.save)
        self.record_all = False
        self.observers: List = []
        self._grad_ready_hooks: List = []
        # a parameter lives as long as its layer: a dead model's names
        # may be generated again (unique_name.guard)
        self._params: "weakref.WeakValueDictionary[str, Parameter]" = (
            weakref.WeakValueDictionary())
        self._n_params = 0
        self._reset_tape()

    def register_grad_ready_hook(self, fn):
        if fn not in self._grad_ready_hooks:
            self._grad_ready_hooks.append(fn)
        return fn

    def remove_grad_ready_hook(self, fn):
        if fn in self._grad_ready_hooks:
            self._grad_ready_hooks.remove(fn)

    @property
    def seed_step(self):
        """(seed, step): the key of the current tape's random draws."""
        return (self._seed, self._step)

    def seed(self, value: int) -> None:
        """``paddle.seed``: a new seed, draws restart from step 0."""
        self.set_seed_step(value, 0)

    def set_seed_step(self, seed: int, step: int) -> None:
        """Draw from (seed, step) from the next tape on (a checkpoint's
        restore puts a resumed run where the crashed one was)."""
        self._seed, self._step = int(seed), int(step)
        if not self.program.global_block().ops:
            self._ctx = None

    # -- tape ----------------------------------------------------------
    def _reset_tape(self):
        self.program = Program()
        self.env: Dict[str, Any] = {}
        self._leaves: Dict[str, Tensor] = {}
        self._ctx: Optional[LoweringContext] = None

    def _context(self) -> LoweringContext:
        """The tape's lowering context (made at its first op, on the
        default place's device: no card raises there)."""
        if self._ctx is None:
            dev = core.resolve_device(core.default_place())
            self._ctx = LoweringContext(dev, seed_step=self.seed_step)
        return self._ctx

    def _tape_var(self, t: Tensor, stop_gradient=None) -> Variable:
        block = self.program.global_block()
        var = block.vars.get(t.name)
        if var is not None:
            return var
        var = Variable(block, name=t.name, shape=tuple(t._value.shape),
                       dtype=t._value.dtype, persistable=t.persistable,
                       stop_gradient=(t.stop_gradient if stop_gradient is None
                                      else stop_gradient))
        block.vars[t.name] = var
        self.env[t.name] = t._value
        if t.is_leaf and not t.stop_gradient:
            self._leaves[t.name] = t
        return var

    # -- op dispatch (reference tracer.cc TraceOp) -----------------------
    def trace_op(self, type: str, inputs: Dict[str, Any],
                 outputs: Optional[Dict[str, Any]] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        opdef = registry.get_op_def(type)
        attrs = dict(attrs or {})
        in_tensors = {k: ts for k, ts in
                      ((k, _as_list(v)) for k, v in inputs.items()) if ts}
        ins = {k: [t._value for t in ts] for k, ts in in_tensors.items()}
        for observe in self.observers:
            observe(in_tensors)
        if opdef.uses_rng and "_rng_id" not in attrs:
            attrs["_rng_id"] = self.program._rng_op_count
            self.program._rng_op_count += 1
        requires_grad = (self.enable_grad and not opdef.stop_gradient
                         and any(not t.stop_gradient
                                 for ts in in_tensors.values() for t in ts))
        ctx = self._context()
        with op_range(type):
            if requires_grad:
                diff = [slot for slot, ts in in_tensors.items()
                        if slot not in opdef.no_grad_inputs
                        and any(not t.stop_gradient for t in ts)]
                idx = len(self.program.global_block().ops)
                out_vals = ctx.record(
                    idx, opdef, ins, attrs, diff,
                    prepare=lambda i: _amp.amp_cast_inputs(type, i))
            else:
                out_vals = registry.run_lowering(
                    opdef, ctx, _amp.amp_cast_inputs(type, ins), attrs)

        out_tensors: Dict[str, List[Tensor]] = {}
        for slot, vals in out_vals.items():
            provided = _as_list(outputs.get(slot)) if outputs else []
            ts = []
            for i, val in enumerate(vals):
                if i < len(provided) and provided[i] is not None:
                    t = provided[i]
                    t._value = val
                    if requires_grad and not t.persistable:
                        t.stop_gradient = False
                        t.is_leaf = False
                else:
                    t = Tensor._wrap(val, stop_gradient=not requires_grad)
                    t.is_leaf = not requires_grad
                ts.append(t)
            out_tensors[slot] = ts
        if requires_grad or self.record_all:
            self._record(type, in_tensors, out_tensors, attrs)
        return out_tensors

    def _record(self, type, in_tensors, out_tensors, attrs):
        block = self.program.global_block()
        in_vars = {k: [self._tape_var(t) for t in ts]
                   for k, ts in in_tensors.items()}
        out_vars = {}
        for k, ts in out_tensors.items():
            vs = []
            for t in ts:
                v = self._tape_var(t, stop_gradient=t.stop_gradient)
                v.shape = tuple(t._value.shape)
                v.dtype = t._value.dtype
                self.env[t.name] = t._value
                vs.append(v)
            out_vars[k] = vs
        op = Operator(block, type, inputs=in_vars, outputs=out_vars,
                      attrs=attrs, do_infer=False)
        block.ops.append(op)

    # -- parameters ----------------------------------------------------
    def create_parameter(self, name, shape, dtype, initializer,
                         trainable=True, regularizer=None, need_clip=True):
        p = self._params.get(name)
        if p is not None:
            return p
        from .base import eval_initializer

        value = eval_initializer(initializer, shape, dtype,
                                 (self._seed, 7919 + self._n_params))
        self._n_params += 1
        p = Parameter(value, name=name, trainable=trainable)
        p.regularizer = regularizer
        p.need_clip = need_clip
        self._params[name] = p
        return p

    # -- backward engine (reference basic_engine.cc) ---------------------
    def run_backward(self, loss: Tensor, grad_tensor: Optional[Tensor] = None,
                     retain_graph: bool = False):
        from ..framework.executor import liveness, lower_op

        block = self.program.global_block()
        if loss.name not in block.vars:
            raise RuntimeError(
                "loss has no recorded graph (all inputs had "
                "stop_gradient=True?)")
        n_fwd = len(block.ops)
        leaf_items = list(self._leaves.items())
        leaf_vars = [block.vars[n] for n, _ in leaf_items]
        target_grads = None
        if grad_tensor is not None:
            target_grads = [self._tape_var(grad_tensor, stop_gradient=True)]
        no_grad = {n for n, v in block.vars.items() if v.stop_gradient}
        grads = calc_gradient([block.vars[loss.name]], leaf_vars,
                              target_gradients=target_grads,
                              no_grad_set=no_grad)

        # each generic grad op takes the record of the forward op that
        # produced its __out__ values
        producer: Dict[str, int] = {}
        for i, op in enumerate(block.ops[:n_fwd]):
            for n in op.output_arg_names():
                producer[n] = i
        ctx = self._context()
        ctx.grad_of = {}
        for i in range(n_fwd, len(block.ops)):
            outs = [n for slot, args in block.ops[i].desc.inputs
                    if slot.startswith(OUT_PREFIX) for n in args]
            if outs and outs[0] in producer:
                ctx.grad_of[i] = producer[outs[0]]

        # a leaf gradient is final when its last writer has run: the
        # grad-ready hooks may ship it while the backward still runs
        hooks = list(self._grad_ready_hooks)
        grad_leaf = {g.name: name for (name, _), g in zip(leaf_items, grads)
                     if g is not None}
        ready_at: Dict[int, List[str]] = {}
        if hooks:
            last: Dict[str, int] = {}
            for i in range(n_fwd, len(block.ops)):
                for n in block.ops[i].output_arg_names():
                    if n in grad_leaf:
                        last[n] = i
            for gname, i in last.items():
                ready_at.setdefault(i, []).append(gname)

        env = self.env
        drop = {} if retain_graph else liveness(
            block, set(grad_leaf) | {loss.name})
        for i in range(n_fwd):
            for name in drop.get(i, ()):
                env.pop(name, None)
        with torch.no_grad():
            for i in range(n_fwd, len(block.ops)):
                with op_range(block.ops[i].type):
                    lower_op(ctx, block.ops[i], env, op_idx=i)
                for gname in ready_at.get(i, ()):
                    if gname in env:
                        for hook in hooks:
                            hook(grad_leaf[gname], env[gname])
                for name in drop.get(i, ()):
                    env.pop(name, None)

        for (name, leaf), gvar in zip(leaf_items, grads):
            if gvar is None or gvar.name not in env:
                continue
            gval = env[gvar.name]
            if leaf.grad is None:
                leaf.grad = Tensor._wrap(gval, stop_gradient=True)
            else:
                leaf.grad._value = leaf.grad._value + gval
        if not retain_graph:
            self._reset_tape()
            self._step += 1
