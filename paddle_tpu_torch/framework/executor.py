"""Executor: runs a program block on one device.

Port of ``paddle_tpu/framework/executor.py`` for one device. The JAX
executor traces every op's lowering into one function and jit-compiles
it (``_CompiledBlock``, ``_get_compiled``); the port runs the same
lowerings in program order (:func:`lower_block` / :func:`lower_op`), on
torch tensors that stay on the device between ops, and on the card
captures a steady step as a CUDA graph and replays it
(:class:`_CompiledStep`, through ``replay.Captured``).

- **Cache.** One entry per (program, version, feed spec, fetch list,
  scope) holds the analysed block: which scope vars the block reads
  (:meth:`Executor._analyze_block`), which persistables it writes, and
  the autograd plan of the generic grad ops (which forward op each grad
  op differentiates, and which input slots of that forward op enter the
  tape; see ``registry.py``). On the compiled route it also holds the
  entry's one compiled step.
- **Eager step** (the CPU; the card with ``PADDLE_TPU_EAGER=1``, the
  counterpart of ``jax.disable_jit``). Feeds and the program's
  ``_extra_feeds`` (the optimizer's learning rate, a host scalar read
  each run) are copied to the device; the ops run under
  ``torch.no_grad()``, and only the forward ops that a grad op will
  differentiate run on the autograd tape; each updated persistable is
  written back to the scope. An op that updates in place (the fused
  Adam kernel, the beta powers) returns the scope's own tensor, so
  nothing is copied. ``return_numpy=False`` returns the fetched tensors.
- **Compiled step** (the card's default). The entry's first run is an
  eager warm-up, the second is captured as a CUDA graph and replayed
  once, every later run replays it. Before each run the feeds and the
  learning rate are copied into the step's static buffers (so an LR
  schedule reaches the graph); the persistables the block reads are
  bound by address, and a scope value replaced since the capture (by
  ``scope.set``, a checkpoint load, ``weights.scope_from_numpy``) makes
  the step capture again on the new tensors; a persistable written out
  of place is copied back into its bound tensor inside the graph;
  fetches and persistables the block only writes are cloned out of the
  graph's pool, so a later step never changes what a run returned. A
  random draw refuses to be captured (``LoweringContext.generator``):
  such a program raises ``errors.Unimplemented`` at its capture unless
  ``PADDLE_TPU_EAGER`` is set. ``Executor.staged`` takes this route on
  the CPU, with the body called directly (tests).
- **Observability.** Each run is an ``executor/run`` span of the ported
  ``profiler`` and counts on the ported ``monitor``
  (``executor_run_total``, ``executor_run_seconds``,
  ``executor_cache_lookups_total``, ``executor_cache_size``, and per
  capture ``executor_compile_total`` and ``executor_compile_seconds``).
  Under ``torch.profiler`` an op that runs on the host runs inside a
  ``paddle_op::<type>`` range (a replayed step has no host ops to
  mark); with no profiler on, a run pays one check.

Not ported, and each raises ``errors.Unimplemented`` naming its
``ROADMAP.md`` item: mesh and sharding-recipe programs and the pipeline
(A10), compiled-program insight (xla_insight), the numerics sentinel,
goodput and memwatch (A9). There is no per-op garbage-collection plan:
a step holds its values until it ends.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import flags as _flags
from .. import monitor as _monitor
from .. import profiler as _profiler
from . import core, registry
from . import errors as _errs
from . import replay as _replay
from .program import Program, Variable, default_main_program
from .registry import GRAD_SUFFIX, OUT_PREFIX, LoweringContext
from .scope import Scope, global_scope

_STRUCTURAL_OPS = frozenset({"feed", "fetch"})

_M_CACHE = _monitor.counter(
    "executor_cache_lookups_total",
    "analysed-program cache lookups by outcome", labelnames=("result",))
_M_CACHE_HIT = _M_CACHE.labels(result="hit")
_M_CACHE_MISS = _M_CACHE.labels(result="miss")
_M_RUN = _monitor.counter("executor_run_total", "Executor.run calls")
_M_RUN_T = _monitor.histogram(
    "executor_run_seconds",
    "Executor.run wall time (eager: the host's dispatch of every op; a "
    "run on the card returns before the device finishes unless it "
    "fetches to numpy)")
_M_CACHE_SIZE = _monitor.gauge(
    "executor_cache_size", "analysed programs resident in the run cache")
_M_COMPILE = _monitor.counter(
    "executor_compile_total",
    "program block compiles: captures of a step as a CUDA graph")
_M_COMPILE_T = _monitor.histogram(
    "executor_compile_seconds",
    "latency of the run that captures a block (capture + first replay)",
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0))


def _unported(what: str, item: str) -> _errs.UnimplementedError:
    return _errs.errors.Unimplemented(
        f"{what} is not ported to paddle_tpu_torch yet (ROADMAP.md queue "
        f"A, item {item})")


def lower_op(ctx: LoweringContext, op, env: Dict[str, Any],
             op_idx: Optional[int] = None) -> None:
    """Run one op's lowering on the values in ``env`` and store its
    outputs there. A forward op in ``ctx.tape`` runs on the autograd
    tape; a generic grad op first takes its forward op's record."""
    try:
        opdef = registry.get_op_def(op.type)
    except NotImplementedError as e:
        raise _errs.attach_op_provenance(e, op, op_idx=op_idx)
    ins = _gather(op, env, op_idx)
    try:
        if op_idx in ctx.tape:
            outs = ctx.record(op_idx, opdef, ins, op.desc.attrs,
                              ctx.tape[op_idx])
        else:
            if opdef.is_generic_grad:
                ctx.use_record(op_idx)
            outs = registry.run_lowering(opdef, ctx, ins, op.desc.attrs)
    except _errs.EnforceError as e:
        raise _errs.attach_op_provenance(e, op, op_idx=op_idx)
    except Exception as e:
        raise _errs.attach_op_provenance(e, op, op_idx=op_idx) from e
    for slot, args in op.desc.outputs:
        for name, val in zip(args, outs.get(slot, [])):
            env[name] = val


# the torch.profiler range each op runs in while a profiler is on
OP_RANGE = "paddle_op::"


def lower_block(ctx: LoweringContext, block, env: Dict[str, Any]
                ) -> Dict[str, Any]:
    """Run every op of ``block`` in program order through ``env``. Under
    an active ``torch.profiler`` each op runs inside a range named
    ``OP_RANGE + op.type``, so a trace attributes device time to ops."""
    traced = torch.autograd._profiler_enabled()
    for i, op in enumerate(block.ops):
        if op.type in _STRUCTURAL_OPS:
            continue
        if traced:
            with torch.profiler.record_function(OP_RANGE + op.type):
                lower_op(ctx, op, env, op_idx=i)
        else:
            lower_op(ctx, op, env, op_idx=i)
    return env


def _gather(op, env, op_idx) -> Dict[str, List[Any]]:
    ins: Dict[str, List[Any]] = {}
    for slot, args in op.desc.inputs:
        vals = []
        for name in args:
            if name not in env:
                raise _errs.attach_op_provenance(
                    _errs.errors.PreconditionNotMet(
                        f"op {op.type!r} reads uninitialized variable "
                        f"{name!r}"), op, op_idx=op_idx)
            vals.append(env[name])
        if vals:
            ins[slot] = vals
    return ins


class _Analysed:
    """A cache entry: the block's scope reads and persistable writes,
    the autograd plan of its generic grad ops, and, on the compiled
    route, its compiled step."""

    def __init__(self, param_names, updated_names, tape, grad_of):
        self.param_names = param_names
        self.updated_names = updated_names
        self.tape = tape  # forward op idx -> input slots to differentiate
        self.grad_of = grad_of  # generic grad op idx -> forward op idx
        self.compiled: Optional[_CompiledStep] = None


class _CompiledStep:
    """The counterpart of the reference's ``_CompiledBlock``: one
    analysed block's step as a body over static buffers, run through
    ``replay.Captured`` (warm-up, capture, replay).

    ``feeds`` are the static buffers of the feeds and the learning rate;
    ``bound`` the persistables the block reads, at the addresses the
    graph was captured on; ``outputs`` the persistables the block writes
    without reading them. :meth:`body` runs the block on them, copies an
    out-of-place write of a bound persistable back into it, and returns
    the fetches and the outputs."""

    def __init__(self, exe: "Executor", program: Program, entry: _Analysed,
                 feed_vals, fetch_names, scope: Scope, warmup: int):
        self.block = program.global_block()
        self.seed = (program.random_seed if program.random_seed is not None
                     else 0)
        self.entry = entry
        self.device = exe.device
        self.step = 0  # the executor's step count, set before each run
        self.feeds = {n: torch.empty(v.shape, dtype=v.dtype,
                                     device=exe.device)
                      for n, v in feed_vals.items()}
        self.bound = {n: exe._scope_value(scope, n)
                      for n in entry.param_names}
        self.ptrs = {n: t.data_ptr() for n, t in self.bound.items()}
        self.fetch_names = list(fetch_names)
        self.outputs = [n for n in entry.updated_names
                        if n not in self.bound]
        self.run = _replay.Captured(self.body, exe.device, warmup=warmup)

    def bound_to(self, scope: Scope) -> bool:
        """Whether every persistable the block reads is still the tensor,
        at the address, that this step was captured on."""
        return all(scope.get(n) is t and t.data_ptr() == self.ptrs[n]
                   for n, t in self.bound.items())

    def body(self, replayed: bool):
        env: Dict[str, Any] = dict(self.bound)
        env.update(self.feeds)
        ctx = LoweringContext(device=self.device, seed=self.seed,
                              step=self.step, tape=self.entry.tape,
                              grad_of=self.entry.grad_of, replayed=replayed)
        with torch.no_grad():
            lower_block(ctx, self.block, env)
            for n in self.entry.updated_names:
                dst = self.bound.get(n)
                if dst is not None and env[n] is not dst:
                    dst.copy_(env[n])
        return ([env[n] for n in self.fetch_names],
                [env[n] for n in self.outputs])


class Executor:
    """``Executor(place)`` with the ``run(program, feed, fetch_list)``
    contract. No place means ``CUDAPlace(0)``; with no card that raises
    ``errors.Unavailable`` here, at construction. Tests pass
    ``CPUPlace()``."""

    def __init__(self, place: Optional[core.Place] = None):
        self.place = place or core.default_place()
        self.device = core.resolve_device(self.place)
        self._cache: Dict[Tuple, _Analysed] = {}
        self._step = 0
        # take the compiled route on the CPU too, with the captured body
        # called directly (tests); the card takes it unless
        # PADDLE_TPU_EAGER is set
        self.staged = False
        # runs by phase of the compiled route: "eager" (warm-ups),
        # "capture" (each ran the body once on the host, then replayed
        # it) and "replay" (the host launched nothing but the graph)
        self.phases = {"eager": 0, "capture": 0, "replay": 0}

    # -- public API ----------------------------------------------------
    def run(self, program: Optional[Program] = None,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence] = None,
            scope: Optional[Scope] = None, return_numpy: bool = True,
            use_prune: bool = False):
        t0 = time.perf_counter()
        _profiler.set_step(self._step)
        with _profiler.span("executor/run", cat="step"):
            out = self._run_impl(program, feed, fetch_list, scope,
                                 return_numpy)
        _monitor.note_progress()
        _M_RUN.inc()
        _M_RUN_T.observe(time.perf_counter() - t0)
        return out

    def compiled_insights(self) -> List[dict]:
        raise _unported("compiled-program insight (xla_insight)", "A9")

    # -- one run -------------------------------------------------------
    def _run_impl(self, program, feed, fetch_list, scope, return_numpy):
        program = program or default_main_program()
        self._refuse_unported(program)
        feed = feed or {}
        scope = scope or global_scope()
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]
        compiled = _replay.replays(self.device, self.staged)
        # the compiled route copies host values into its static buffers
        # straight from the host
        place = _host_tensor if compiled else self._to_device
        feed_vals = {k: place(v) for k, v in feed.items()}
        for n, fn in (getattr(program, "_extra_feeds", None) or {}).items():
            if n not in feed_vals:
                feed_vals[n] = place(np.asarray(fn()))

        entry = self._get_analysed(program, feed_vals, fetch_names, scope)
        if compiled:
            return self._run_compiled(program, entry, feed_vals,
                                      fetch_names, scope, return_numpy)
        env: Dict[str, Any] = {n: self._scope_value(scope, n)
                               for n in entry.param_names}
        env.update(feed_vals)
        seed = program.random_seed if program.random_seed is not None else 0
        ctx = LoweringContext(device=self.device, seed=seed, step=self._step,
                              tape=entry.tape, grad_of=entry.grad_of)
        with torch.no_grad():
            lower_block(ctx, program.global_block(), env)
        self._step += 1
        for n in entry.updated_names:
            scope.set(n, env[n])
        fetches = [env[n] for n in fetch_names]
        if return_numpy:
            return [_to_numpy(t) for t in fetches]
        return fetches

    def _run_compiled(self, program, entry: _Analysed, feed_vals,
                      fetch_names, scope: Scope, return_numpy: bool):
        step = entry.compiled
        if step is None or not step.bound_to(scope):
            # a scope value replaced since the capture: capture again on
            # the new tensors (the warm-up was this entry's first run)
            step = entry.compiled = _CompiledStep(
                self, program, entry, feed_vals, fetch_names, scope,
                warmup=1 if step is None else 0)
        for n, v in feed_vals.items():
            step.feeds[n].copy_(v)
        step.step = self._step
        t0 = time.perf_counter()
        (fetches, outputs), phase = step.run()
        if phase == "capture":
            _M_COMPILE.inc()
            _M_COMPILE_T.observe(time.perf_counter() - t0)
        self.phases[phase] += 1
        self._step += 1
        for n, t in zip(step.outputs, outputs):
            scope.set(n, t.clone())
        if return_numpy:
            return [_to_numpy(t) for t in fetches]
        return [t.clone() for t in fetches]

    def _refuse_unported(self, program) -> None:
        if getattr(program, "_pipeline_meta", None) is not None:
            raise _unported("pipeline-parallel programs", "A10")
        if (getattr(program, "_mesh", None) is not None
                or getattr(program, "_sharding_recipe", None) is not None):
            raise _unported("mesh and sharding-recipe programs", "A10")
        if _flags.env_flag("PADDLE_TPU_CHECK_NUMERICS"):
            raise _unported("the numerics sentinel "
                            "(PADDLE_TPU_CHECK_NUMERICS)", "A9")
        if os.environ.get("PADDLE_TPU_XLA_DUMP_DIR"):
            raise _unported("compiled-program dumps "
                            "(PADDLE_TPU_XLA_DUMP_DIR)", "A9")
        for var in ("PADDLE_TPU_GOODPUT_DIR", "PADDLE_TPU_MEMWATCH_DIR"):
            if os.environ.get(var):
                raise _unported(f"goodput and memwatch journals ({var})",
                                "A9")

    # -- helpers -------------------------------------------------------
    def _to_device(self, value: Any) -> torch.Tensor:
        return _host_tensor(value).to(self.device)

    def _scope_value(self, scope: Scope, name: str) -> torch.Tensor:
        val = scope.get(name)
        if not isinstance(val, torch.Tensor):
            val = self._to_device(val)
            scope.set(name, val)
        elif val.device != self.device:
            raise _errs.errors.InvalidArgument(
                f"scope variable {name!r} lives on {val.device}, but this "
                f"executor runs on {self.device}")
        return val

    def _get_analysed(self, program: Program, feed_vals, fetch_names,
                      scope: Scope) -> _Analysed:
        feed_spec = tuple((k, tuple(v.shape), str(v.dtype))
                          for k, v in sorted(feed_vals.items()))
        key = (id(program), program._version, feed_spec, tuple(fetch_names),
               id(scope))
        cached = self._cache.get(key)
        if cached is not None and all(scope.has(n)
                                      for n in cached.param_names):
            _M_CACHE_HIT.inc()
            return cached
        _M_CACHE_MISS.inc()
        block = program.global_block()
        param_names, updated = self._analyze_block(block, sorted(feed_vals),
                                                   scope)
        tape: Dict[int, Tuple[str, ...]] = {}
        grad_of: Dict[int, int] = {}
        producer: Dict[str, int] = {}
        for i, op in enumerate(block.ops):
            if op.type in _STRUCTURAL_OPS:
                continue
            try:
                opdef = registry.get_op_def(op.type)
            except NotImplementedError as e:
                raise _errs.attach_op_provenance(e, op, op_idx=i)
            if opdef.is_generic_grad:
                outs = [n for slot, args in op.desc.inputs
                        if slot.startswith(OUT_PREFIX) for n in args]
                fwd = producer.get(outs[0]) if outs else None
                if fwd is None or fwd in tape:
                    raise _errs.attach_op_provenance(
                        _errs.errors.PreconditionNotMet(
                            f"grad op {op.type!r} finds no forward op "
                            f"producing {outs[:1]} earlier in the block "
                            f"that no other grad op differentiates"),
                        op, op_idx=i)
                grad_of[i] = fwd
                tape[fwd] = tuple(slot[: -len(GRAD_SUFFIX)]
                                  for slot, _ in op.desc.outputs
                                  if slot.endswith(GRAD_SUFFIX))
            for n in op.output_arg_names():
                producer[n] = i
        entry = _Analysed(param_names, updated, tape, grad_of)
        self._cache[key] = entry
        _M_CACHE_SIZE.set(len(self._cache))
        return entry

    @staticmethod
    def _analyze_block(block, feed_names: Sequence[str], scope: Scope):
        """Scope vars the block reads before writing (inputs) and the
        persistables it writes (stored back)."""
        written = set(feed_names)
        param_names: List[str] = []
        updated: List[str] = []
        seen = set()
        for op in block.ops:
            if op.type in _STRUCTURAL_OPS:
                continue
            for name in op.input_arg_names():
                if name in written or name in seen:
                    continue
                if scope.has(name):
                    seen.add(name)
                    param_names.append(name)
                else:
                    var = block._find_var_recursive(name)
                    pers = var.persistable if var is not None else False
                    raise _errs.attach_op_provenance(
                        _errs.errors.PreconditionNotMet(
                            f"op {op.type!r} reads variable {name!r} which "
                            f"is neither fed, produced earlier in the "
                            f"block, nor present in the scope "
                            f"(persistable={pers}). Run the startup "
                            f"program first."), op)
            for name in op.output_arg_names():
                written.add(name)
                var = block._find_var_recursive(name)
                if var is not None and var.persistable and name not in updated:
                    updated.append(name)
        return param_names, updated


def _host_tensor(value: Any) -> torch.Tensor:
    """A fed value as a tensor: a tensor as it is, an array as a CPU
    tensor of its values (ml_dtypes bfloat16 widened exactly and cast
    back)."""
    if isinstance(value, torch.Tensor):
        return value
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr, order="C"))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A fetched tensor as numpy; bfloat16 widens exactly to float32
    (numpy has no bfloat16)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()
