"""Op registry and lowering rules.

Port of ``paddle_tpu/framework/registry.py``. An op registers one
*lowering rule*: a function ``fn(ctx, ins, attrs) -> {slot: tensor}``
on torch tensors. The executor runs the rules of a block in program
order: eagerly, or once while a CUDA graph records them, which later
steps replay (``replay.py``).

Two subsystems of the JAX package change shape here:

* **Shape inference.** ``jax.eval_shape`` over the rule becomes a run of
  the rule on ``device="meta"`` tensors (shapes and dtypes, no data). An
  op whose rule launches a kernel (``fused_lm_head_ce``) registers an
  ``infer=`` rule instead, so a kernel wrapper never sees a meta tensor.
* **Generic ``<op>_grad``.** The contract is the JAX package's: the grad
  op's inputs are the forward inputs, the forward outputs under
  ``__out__<slot>`` and the ``<slot>@GRAD`` cotangents; its outputs are
  ``<slot>@GRAD`` of the differentiable forward inputs. The JAX rule is
  ``jax.vjp`` of the forward rule, which recomputes the forward inside
  the fused program. The port does not recompute: the executor runs
  every forward op that a later grad op needs on the autograd tape (its
  differentiable inputs as fresh leaves that require grad, see
  :meth:`LoweringContext.record`), keeps that record for the step, and
  the generic ``<op>_grad`` rule takes it back and calls
  ``torch.autograd.grad`` on it. The executor pairs each grad op with its
  forward op through the ``__out__<slot>`` wiring that
  ``backward.py`` emits. A kernel with its own backward enters the tape
  as a ``torch.autograd.Function`` (``ops/lmhead_ce.py``), written with a
  ``setup_context`` staticmethod so that ``torch.func`` can also
  transform it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from . import errors as _errs

# stands in for a dynamic (-1) dim during builder-time inference; an
# inferred dim >= _DYN maps back to -1
_DYN = 1 << 22

GRAD_SUFFIX = "@GRAD"
OUT_PREFIX = "__out__"


class _Record:
    """One forward op's autograd record for the step: its leaf inputs
    per slot (``None`` where a slot is not differentiated) and its
    graph-attached outputs per slot."""

    __slots__ = ("leaves", "outs")

    def __init__(self, leaves, outs):
        self.leaves = leaves
        self.outs = outs


_M32 = 0xFFFF_FFFF


def _signed32(c: int) -> int:
    """A 32-bit constant as the signed value with the same low 32 bits,
    so that its product with a value below 2^32 stays inside int64."""
    return c - (1 << 32) if c >= (1 << 31) else c


_MIX1, _MIX2 = _signed32(0x7FEB352D), _signed32(0x846CA68B)


def mix32(x):
    """A 32-bit integer hash (the "lowbias32" xorshift-multiply mix) of
    ``x``, a Python int or an int64 tensor holding values in [0, 2^32).
    Every product is of a value below 2^32 and a constant below 2^31 in
    magnitude, so nothing overflows int64, and ``& 0xFFFFFFFF`` keeps the
    low 32 bits (two's complement for a negative product): the same bits
    on the CPU and the card, with no unsigned arithmetic."""
    x = x ^ (x >> 16)
    x = (x * _MIX1) & _M32
    x = x ^ (x >> 15)
    x = (x * _MIX2) & _M32
    return x ^ (x >> 16)


def step_key(seed_step):
    """The hash chain over the four 32-bit halves of seed and step:
    ``seed_step`` is an int64 tensor of two values (the result is a 0-dim
    tensor beside it: no host read) or a pair of ints (an int)."""
    if isinstance(seed_step, torch.Tensor):
        halves = [seed_step[0] & _M32, (seed_step[0] >> 32) & _M32,
                  seed_step[1] & _M32, (seed_step[1] >> 32) & _M32]
    else:
        seed, step = (int(v) for v in seed_step)
        halves = [seed & _M32, (seed >> 32) & _M32, step & _M32,
                  (step >> 32) & _M32]
    h = 0x9E3779B9
    for word in halves:
        h = mix32(h ^ word)
    return h


def draw_bits(key, rng_id: int, shape, device) -> torch.Tensor:
    """32 random bits per element of ``shape`` (an int64 tensor of values
    in [0, 2^32)), a pure function of the step's ``key`` (``step_key``),
    the op's ``rng_id`` and the element's index: a counter-based
    generator. Element i draws ``mix32((i * (a | 1) + b) mod 2^32)`` for
    the two words a, b that the key and the rng id hash to. Draws of one
    op at one step are the same wherever they are made (the op, its grad,
    a recomputed clone), and differ across steps and ops."""
    h = mix32(key ^ (int(rng_id) & _M32))
    # Python constants only: a host tensor would be a copy to the device,
    # which a capture refuses
    a, b = mix32(h ^ 0x85EBCA6B) | 1, mix32(h ^ 0xC2B2AE35)
    a = a - ((a >> 31) << 32)  # signed, so i * a stays inside int64
    n = 1
    for d in shape:
        n *= int(d)
    if n > (1 << 32):
        raise _errs.errors.InvalidArgument(
            f"a random draw of {n} elements: the counter covers 2^32")
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return mix32((idx * a + b) & _M32).reshape(tuple(shape))


class LoweringContext:
    """Per-run state handed to lowering rules: the device; ``seed_step``,
    the run's (program seed, step) pair as an int64 tensor of two values
    on the device (the executor's, which each run's body advances in
    place; see :meth:`uniform`); and the step's autograd plan and
    records: ``tape`` maps a forward op's index to the input slots to
    differentiate, ``grad_of`` a generic grad op's index to its forward
    op's, ``regrad`` a generic grad op's index to the input slots of a
    forward op that the grad op runs again on its own inputs (a forward op
    whose outputs a recomputed segment keeps, while its grad op reads the
    recomputed inputs; all three built by the executor). ``replayed``
    marks a run that is captured for replay as a CUDA graph
    (``replay.py``)."""

    def __init__(self, device: Any = "cpu",
                 seed_step: Optional[torch.Tensor] = None,
                 tape: Optional[Dict[int, Sequence[str]]] = None,
                 grad_of: Optional[Dict[int, int]] = None,
                 regrad: Optional[Dict[int, Sequence[str]]] = None,
                 replayed: bool = False):
        self.device = torch.device(device)
        self.seed_step = seed_step
        self.tape = tape or {}
        self.grad_of = grad_of or {}
        self.regrad = regrad or {}
        self.replayed = bool(replayed)
        self._records: Dict[int, _Record] = {}
        self._pending: Optional[_Record] = None
        self._key = None  # step_key(seed_step), made at the run's first draw

    def uniform(self, rng_id: int, shape, seed: int = 0) -> torch.Tensor:
        """fp32 numbers in [0, 1) of ``shape``: the top 24 of 32 random
        bits an element (``draw_bits``), each exactly representable; from
        ``(seed, 0)`` where the op fixes a seed (the same numbers at every
        step and in every op of that seed), else from the run's (program
        seed, step) tensor and the op's ``rng_id``. Made on the device
        from device values, so a captured step draws anew at every replay
        (the executor advances the step inside the graph), and an eager
        run and a replay of the same step draw the same numbers. A meta
        tensor on the meta device (shape inference draws nothing)."""
        if self.device.type == "meta":
            return torch.empty(tuple(shape), dtype=torch.float32,
                               device="meta")
        if seed:
            key, rng_id = step_key((int(seed), 0)), 0
        else:
            if self._key is None:
                if self.seed_step is None:
                    self.seed_step = torch.zeros(2, dtype=torch.int64,
                                                 device=self.device)
                self._key = step_key(self.seed_step)
            key = self._key
        bits = draw_bits(key, rng_id, shape, self.device)
        return (bits >> 8).to(torch.float32) * (2.0 ** -24)

    # -- autograd records (the generic grad's tape) ---------------------
    def record(self, fwd_idx: int, opdef: "OpDef", ins, attrs,
               diff_slots: Sequence[str], prepare=None):
        """Run a forward rule on the tape: each differentiable input of
        ``diff_slots`` enters as a detached leaf that requires grad, the
        rule runs with grad enabled, and the record is kept under
        ``fwd_idx`` until its grad op takes it. ``prepare`` (the eager
        API's autocast) maps the inputs to the ones the rule runs on,
        inside the record, so a leaf's gradient comes back through the
        cast in the leaf's own dtype. Returns the outputs, detached, for
        the rest of the program."""
        leaves: Dict[str, List[Optional[torch.Tensor]]] = {}
        run_ins = dict(ins)
        for slot in diff_slots:
            vals = ins.get(slot)
            if not vals:
                continue
            lv = [v.detach().requires_grad_(True)
                  if v.dtype.is_floating_point else None for v in vals]
            leaves[slot] = lv
            run_ins[slot] = [l if l is not None else v
                             for l, v in zip(lv, vals)]
        with torch.enable_grad():
            if prepare is not None:
                run_ins = prepare(run_ins)
            outs = run_lowering(opdef, self, run_ins, attrs)
        self._records[fwd_idx] = _Record(leaves, outs)
        return {k: [o.detach() if isinstance(o, torch.Tensor) else o
                    for o in vs] for k, vs in outs.items()}

    def use_record(self, grad_idx: int) -> None:
        """Hand the generic grad op ``grad_idx`` its forward op's record
        (taken out of the step's records: each is differentiated once)."""
        self._pending = self._records.pop(self.grad_of.get(grad_idx), None)

    def rerecord(self, grad_idx: int, fwd: "OpDef", ins, attrs) -> None:
        """Run the forward rule ``fwd`` of the generic grad op ``grad_idx``
        again, on the tape, on the forward inputs the grad op reads (its
        ``regrad`` entry names the slots to differentiate), and hand the
        grad op that record: the JAX package's generic grad, which takes
        the VJP of the forward rule on the grad op's own inputs. A random
        op draws the same numbers again (same ``_rng_id``, same step)."""
        fwd_ins = {slot: vals for slot, vals in ins.items()
                   if not slot.startswith(OUT_PREFIX)
                   and not slot.endswith(GRAD_SUFFIX)}
        self.record(-1 - grad_idx, fwd, fwd_ins, attrs,
                    self.regrad[grad_idx])
        self._pending = self._records.pop(-1 - grad_idx)


InsDict = Dict[str, List[Any]]
LowerFn = Callable[[LoweringContext, InsDict, Dict[str, Any]], Dict[str, Any]]


@dataclass
class OpDef:
    type: str
    lower: LowerFn
    # custom builder-time inference: fn(op) -> None, sets output var shapes
    infer: Optional[Callable] = None
    # input slots that never receive gradient (e.g. integer indices)
    no_grad_inputs: frozenset = field(default_factory=frozenset)
    # ops with no gradient at all (optimizers, initializers)
    stop_gradient: bool = False
    # does the rule draw random numbers? (needs a stable _rng_id attr)
    uses_rng: bool = False
    # skip inference entirely
    skip_infer: bool = False
    # the generic <op>_grad: its rule consumes the forward's record
    is_generic_grad: bool = False
    # runs on the host with concrete values (a data-dependent loop or
    # output shape): a block holding one is never captured
    host: bool = False


_REGISTRY: Dict[str, OpDef] = {}


def register_op(type: str, *, infer: Optional[Callable] = None,
                no_grad_inputs: Sequence[str] = (),
                stop_gradient: bool = False, uses_rng: bool = False,
                skip_infer: bool = False, host: bool = False):
    """Decorator: register ``fn(ctx, ins, attrs) -> {slot: tensor|list}``
    as the lowering rule of op ``type``."""

    def deco(fn: LowerFn):
        _REGISTRY[type] = OpDef(
            type=type, lower=fn, infer=infer,
            no_grad_inputs=frozenset(no_grad_inputs),
            stop_gradient=stop_gradient, uses_rng=uses_rng,
            skip_infer=skip_infer, host=host)
        return fn

    return deco


def get_op_def(type: str) -> OpDef:
    _ensure_ops_loaded()
    if type in _REGISTRY:
        return _REGISTRY[type]
    if type.endswith("_grad"):
        fwd = _REGISTRY.get(type[: -len("_grad")])
        if fwd is not None:
            gdef = _make_generic_grad_def(fwd)
            _REGISTRY[type] = gdef
            return gdef
    raise _errs.errors.Unimplemented(
        f"no lowering registered for op {type!r} in paddle_tpu_torch (the "
        f"port registers the ops of the GPT training program, of the "
        f"eager API's layers and of the vision and fluid paths; this one "
        f"waits in ROADMAP queue A, item "
        f"{_queue_item(type)})")


# the collective ops come with the multi-device item (A10); every other
# unregistered op belongs to the remaining op families (A11)
_COLLECTIVE_OPS = frozenset((
    "allreduce", "mp_allreduce_sum", "barrier", "alltoall",
    "collective_permute", "broadcast", "gen_nccl_id"))


def _queue_item(type: str) -> str:
    base = type[: -len("_grad")] if type.endswith("_grad") else type
    return ("A10" if base.startswith("c_") or base in _COLLECTIVE_OPS
            else "A11")


_ops_loaded = False


def _ensure_ops_loaded():
    global _ops_loaded
    if not _ops_loaded:
        _ops_loaded = True
        from .. import ops as _ops  # noqa: F401  (registers everything)


def normalize_outs(out) -> Dict[str, List[Any]]:
    """A rule may return {slot: tensor} or {slot: [tensors]}."""
    norm = {}
    for k, v in out.items():
        if v is None:
            norm[k] = []
        elif isinstance(v, (list, tuple)):
            norm[k] = list(v)
        else:
            norm[k] = [v]
    return norm


def run_lowering(opdef: OpDef, ctx: LoweringContext, ins: InsDict,
                 attrs) -> Dict[str, List[Any]]:
    return normalize_outs(opdef.lower(ctx, ins, attrs))


# ---------------------------------------------------------------------------
# builder-time shape/dtype inference
# ---------------------------------------------------------------------------


def _meta(var) -> torch.Tensor:
    shape = tuple(_DYN if d == -1 else int(d) for d in var.shape)
    return torch.empty(shape, dtype=var.dtype, device="meta")


def _apply_meta(var, t: torch.Tensor) -> None:
    var.shape = tuple(-1 if d >= _DYN else int(d) for d in t.shape)
    var.dtype = t.dtype


def assign_rng_id(op) -> None:
    """Give random ops a stable per-program id (set once at op creation,
    as in the JAX package, so that the op attrs of both packages agree)."""
    try:
        opdef = get_op_def(op.type)
    except NotImplementedError:
        return
    if opdef.uses_rng and not op.has_attr("_rng_id"):
        prog = op.block.program
        op._set_attr("_rng_id", prog._rng_op_count)
        prog._rng_op_count += 1


def infer_op(op) -> None:
    """Infer output shapes/dtypes of a freshly built Operator by running
    its rule on meta tensors."""
    if op.type in ("feed", "fetch"):
        return
    try:
        opdef = get_op_def(op.type)
    except NotImplementedError as e:
        raise _errs.attach_op_provenance(e, op)
    if opdef.skip_infer:
        return
    if opdef.infer is not None:
        opdef.infer(op)
        return
    ins = {slot: [_meta(v) for v in vs]
           for slot, vs in op._input_vars.items() if vs}
    attrs = op.all_attrs()
    try:
        with torch.no_grad():
            outs = run_lowering(opdef, LoweringContext(device="meta"), ins,
                                attrs)
    except NotImplementedError as e:
        raise _errs.attach_op_provenance(e, op)
    except Exception as e:
        shown = {k: v for k, v in attrs.items() if k != "op_callstack"}
        shapes = {k: [tuple(v.shape) for v in vs]
                  for k, vs in op._input_vars.items()}
        err = _errs.errors.InvalidArgument(
            f"shape inference failed for op {op.type!r} (inputs={shapes}, "
            f"attrs={shown}): {e}")
        err.__cause__ = e
        raise _errs.attach_op_provenance(err, op)
    for slot, out_vars in op._output_vars.items():
        for var, t in zip(out_vars, outs.get(slot, [])):
            _apply_meta(var, t)


# ---------------------------------------------------------------------------
# generic gradient
# ---------------------------------------------------------------------------


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


def _make_generic_grad_def(fwd: OpDef) -> OpDef:
    """``<op>_grad`` whose rule is the VJP of the forward op's taped run
    (see the module docstring). Cotangents missing for an output are
    zeros; an input the outputs do not depend on gets a zero gradient."""

    def glower(ctx: LoweringContext, ins: InsDict, attrs) -> Dict[str, Any]:
        rec = ctx._pending
        ctx._pending = None
        if rec is None:
            raise _errs.errors.PreconditionNotMet(
                f"{fwd.type}_grad ran without its forward op's record: a "
                f"generic grad op runs inside Executor.run, after the "
                f"forward op it differentiates")
        outs, cots = [], []
        for slot, vals in rec.outs.items():
            gs = ins.get(slot + GRAD_SUFFIX)
            if gs is None:
                continue
            for o, g in zip(vals, gs):
                if (isinstance(o, torch.Tensor) and o.requires_grad
                        and g is not None):
                    outs.append(o)
                    cots.append(g.to(o.dtype))
        flat = [(slot, i, leaf) for slot, lv in rec.leaves.items()
                for i, leaf in enumerate(lv) if leaf is not None]
        leaves = [leaf for _, _, leaf in flat]
        grads = (torch.autograd.grad(outs, leaves, cots, allow_unused=True)
                 if outs and leaves else [None] * len(leaves))
        res: Dict[str, List[torch.Tensor]] = {}
        for (slot, i, leaf), g in zip(flat, grads):
            lst = res.setdefault(slot + GRAD_SUFFIX,
                                 [None] * len(rec.leaves[slot]))
            lst[i] = torch.zeros_like(leaf) if g is None else g
        return res

    def ginfer(op) -> None:
        # d(input) has the shape and dtype of the input itself
        for slot, out_vars in op._output_vars.items():
            if not slot.endswith(GRAD_SUFFIX):
                continue
            src = op._input_vars.get(slot[: -len(GRAD_SUFFIX)], [])
            for var, s in zip(out_vars, src):
                if s is not None:
                    var.shape = s.shape
                    var.dtype = s.dtype

    return OpDef(type=fwd.type + "_grad", lower=glower, infer=ginfer,
                 stop_gradient=True, uses_rng=fwd.uses_rng,
                 is_generic_grad=True)
