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
  (``executor_run_total``, ``executor_cache_lookups_total``,
  ``executor_cache_size``, ``executor_compile_total`` per capture,
  ``executor_compile_seconds`` for a run that builds (a cache miss of
  the eager route, the compiled route's warm-up and capture) and
  ``executor_run_seconds`` for the others). Under ``torch.profiler`` an
  op that runs on the host runs inside a ``paddle_op::<type>`` range (a
  replayed step has no host ops to mark); with no profiler on, a run
  pays one check. The JAX executor's step-side hooks, as there:

  - *goodput*: a building run adds its wall time to the ``compile``
    bucket of ``goodput.py``, any other run to ``device_compute``;
  - *memwatch*: ``memwatch.sample`` on every building run and every
    ``PADDLE_TPU_MEMWATCH_SAMPLE_RUNS`` runs; an allocation failure at
    the run, the capture or the readback raises ``memwatch.oom_error``
    (typed ``ResourceExhausted``, the op that raised named, a
    post-mortem);
  - *numerics sentinel* (``PADDLE_TPU_CHECK_NUMERICS``) and
    ``FLAGS_check_nan_inf`` (``flags.set_flags``): every float output of
    every non-structural op is probed right after its op (persistables
    are updated in place, so a later look would see other values), each
    probe writing the output's largest magnitude into one slot of a
    device vector preallocated on the entry's first run (:class:`Probes`),
    inside the captured graph on the card; the vector is read back once
    after the run, and the first non-finite slot's op raises a typed
    ``InvalidArgument`` with its provenance (the sentinel) or a
    ``FloatingPointError`` (the legacy flag). Both flags are part of the
    cache key; with both off nothing is probed and the captured graph is
    the one without probes;
  - *insight* (``framework/xla_insight.py``): an entry's first run, which
    is eager on either route, is counted once (FLOPs, allocator peak),
    never a capture; :meth:`Executor.compiled_insights` returns the
    records, and ``PADDLE_TPU_XLA_DUMP_DIR`` receives each program's
    artifacts under a hash of its structure.

Not ported, and each raises ``errors.Unimplemented`` naming its
``ROADMAP.md`` item: mesh and sharding-recipe programs and the pipeline
(A10). There is no per-op garbage-collection plan: a step holds its
values until it ends.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import flags as _flags
from .. import goodput as _goodput
from .. import memwatch as _memwatch
from .. import monitor as _monitor
from .. import profiler as _profiler
from . import core, registry
from . import errors as _errs
from . import replay as _replay
from . import xla_insight as _insight
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
    "steady-state Executor.run wall time (eager: the host's dispatch of "
    "every op; a run on the card returns before the device finishes "
    "unless it fetches to numpy)")
_M_CACHE_SIZE = _monitor.gauge(
    "executor_cache_size", "analysed programs resident in the run cache")
_M_COMPILE = _monitor.counter(
    "executor_compile_total",
    "program block compiles: captures of a step as a CUDA graph")
_M_COMPILE_T = _monitor.histogram(
    "executor_compile_seconds",
    "latency of a run that builds: a cache miss of the eager route, the "
    "compiled route's warm-up and its capture (+ first replay)",
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0))
_M_NONFINITE = _monitor.counter(
    "executor_nonfinite_total",
    "numerics-sentinel / FLAGS_check_nan_inf probe failures")


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


def lower_block(ctx: LoweringContext, block, env: Dict[str, Any],
                probes: Optional["Probes"] = None) -> Dict[str, Any]:
    """Run every op of ``block`` in program order through ``env``. Under
    an active ``torch.profiler`` each op runs inside a range named
    ``OP_RANGE + op.type``, so a trace attributes device time to ops.
    ``probes`` checks each op's float outputs right after it."""
    traced = torch.autograd._profiler_enabled()
    if probes is not None:
        probes.begin()
    for i, op in enumerate(block.ops):
        if op.type in _STRUCTURAL_OPS:
            continue
        if traced:
            with torch.profiler.record_function(OP_RANGE + op.type):
                lower_op(ctx, op, env, op_idx=i)
        else:
            lower_op(ctx, op, env, op_idx=i)
        if probes is not None:
            probes.after(i, op, env)
    if probes is not None:
        probes.end()
    return env


class Probes:
    """The numerics probes of one cache entry. ``sites`` lists (op index,
    op type, variable) of every non-empty float output of every
    non-structural op in program order, found on the entry's first run,
    which also allocates ``maxabs``: one device vector per output dtype,
    one slot a site. Each later run writes each slot in place right after
    its op: the output's largest magnitude (``linalg.vector_norm`` at
    order inf, one reduction in the output's own dtype that reads it once
    and writes nothing else), non-finite exactly where the output holds a
    nan or an inf. No host read: it runs inside a capture, and every
    replay writes it again; the owner reads the vectors back in one
    transfer after the run (:meth:`first_bad`)."""

    def __init__(self):
        self.sites: List[Tuple[int, str, str]] = []
        self.maxabs: Optional[Dict[torch.dtype, torch.Tensor]] = None
        self._slots: List[Tuple[torch.dtype, int]] = []  # one a site
        self._first: Dict[torch.dtype, List[torch.Tensor]] = {}
        self._k = 0

    def begin(self) -> None:
        self._k = 0

    def after(self, op_idx: int, op, env: Dict[str, Any]) -> None:
        for name in op.output_arg_names():
            val = env.get(name)
            if not (isinstance(val, torch.Tensor)
                    and val.is_floating_point() and val.numel()):
                continue
            if self.maxabs is None:
                first = self._first.setdefault(val.dtype, [])
                self.sites.append((op_idx, op.type, name))
                self._slots.append((val.dtype, len(first)))
                first.append(torch.linalg.vector_norm(val, float("inf")))
            else:
                dtype, i = self._slots[self._k]
                torch.linalg.vector_norm(val, float("inf"),
                                         out=self.maxabs[dtype][i])
            self._k += 1

    def end(self) -> None:
        if self.maxabs is None:
            self.maxabs = {dt: torch.stack(v) for dt, v in
                           self._first.items()}
            self._first = {}

    def first_bad(self) -> Optional[Tuple[int, str, str]]:
        """The first site whose output held a nan or an inf."""
        if not self.sites:
            return None
        dtypes = list(self.maxabs)
        host = torch.cat([self.maxabs[dt].double() for dt in dtypes]).cpu()
        offset, at = 0, {}
        for dt in dtypes:
            at[dt] = offset
            offset += len(self.maxabs[dt])
        bad = ~torch.isfinite(host)
        if not bool(bad.any()):
            return None
        for site, (dt, i) in zip(self.sites, self._slots):
            if bad[at[dt] + i]:
                return site
        return None


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
        self.runs = 0  # runs of this entry
        # the numerics probes (either check flag on), the legacy flag's
        # FloatingPointError instead of the sentinel's typed error
        self.probes: Optional[Probes] = None
        self.check_numerics = False
        # compiler-observability slots (xla_insight.py): the structure
        # hash, and the record of the entry's first run
        self.key_hash = ""
        self.fetch_names: Tuple[str, ...] = ()
        self.insight: Optional[_insight.ProgramInsight] = None


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
            lower_block(ctx, self.block, env, self.entry.probes)
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
        self._last_run_compiled = False  # telemetry: the last run built
        self._runs_since_sample = 0  # memwatch allocator-query cadence
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
        self._last_run_compiled = False
        _profiler.set_step(self._step)
        with _profiler.span("executor/run", cat="step"):
            out = self._run_impl(program, feed, fetch_list, scope,
                                 return_numpy)
        dt = time.perf_counter() - t0
        _monitor.note_progress()
        _M_RUN.inc()
        if self._last_run_compiled:
            # a run that built (a fresh entry's first run, a warm-up, a
            # capture): binned apart so steady-state latency stays clean
            _M_COMPILE_T.observe(dt)
            _goodput.add("compile", dt)
        else:
            _M_RUN_T.observe(dt)
            # the steady run's wall is the step's device-compute window
            # (a loop closing the step with goodput.end_step accounts
            # what lies outside it as other buckets or host_other)
            _goodput.add("device_compute", dt)
        return out

    def compiled_insights(self) -> List[dict]:
        """Cost records (``ProgramInsight.to_dict``) of every counted
        entry resident in this executor's cache."""
        return [e.insight.to_dict() for e in self._cache.values()
                if e.insight is not None]

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
        try:
            if compiled:
                fetches = self._run_compiled(program, entry, feed_vals,
                                             fetch_names, scope)
            else:
                fetches = self._run_eager(program, entry, feed_vals,
                                          fetch_names, scope)
            entry.runs += 1
            self._after_run(program, entry)
            if return_numpy:
                return [_to_numpy(t) for t in fetches]
            return fetches
        except Exception as e:
            # an allocation failure at the run, the capture or the
            # readback (an op's provenance may wrap it) -> the typed
            # error with a post-mortem (memwatch.py)
            if _memwatch.is_oom_error(e):
                raise _memwatch.oom_error(
                    e, program=program, scope=scope,
                    insights=self.compiled_insights()) from e
            raise

    def _run_eager(self, program, entry: _Analysed, feed_vals,
                   fetch_names, scope: Scope) -> List[torch.Tensor]:
        env: Dict[str, Any] = {n: self._scope_value(scope, n)
                               for n in entry.param_names}
        env.update(feed_vals)
        seed = program.random_seed if program.random_seed is not None else 0
        ctx = LoweringContext(device=self.device, seed=seed, step=self._step,
                              tape=entry.tape, grad_of=entry.grad_of)
        if entry.runs == 0:
            self._last_run_compiled = True
        with self._counted(program, entry, env) as outs:
            with torch.no_grad():
                lower_block(ctx, program.global_block(), env, entry.probes)
            fetches = [env[n] for n in fetch_names]
            outs.extend(fetches + [env[n] for n in entry.updated_names])
        self._step += 1
        for n in entry.updated_names:
            scope.set(n, env[n])
        return fetches

    def _run_compiled(self, program, entry: _Analysed, feed_vals,
                      fetch_names, scope: Scope) -> List[torch.Tensor]:
        step = entry.compiled
        if step is None or not step.bound_to(scope):
            # a scope value replaced since the capture: capture again on
            # the new tensors (the warm-up was this entry's first run)
            step = entry.compiled = _CompiledStep(
                self, program, entry, feed_vals, fetch_names, scope,
                warmup=1 if step is None else 0)
            self._dot_at_capture(entry, step)
        for n, v in feed_vals.items():
            step.feeds[n].copy_(v)
        step.step = self._step
        warm = step.run.calls["eager"] < step.run.warmup
        with self._counted(program, entry, dict(step.bound, **step.feeds),
                           on=warm) as outs:
            (fetches, outputs), phase = step.run()
            outs.extend(list(fetches) + list(outputs))
        if warm:
            self._dot_at_capture(entry, step)
        if phase == "capture":
            _M_COMPILE.inc()
            dot = step.run.dump_dot
            if dot and entry.insight is not None and os.path.exists(dot):
                # the DOT is written: the cost record goes after it again
                entry.insight.artifacts["dot"] = dot
                _insight.dump_artifacts(entry.insight, os.path.dirname(dot))
        if phase != "replay":
            self._last_run_compiled = True
        self.phases[phase] += 1
        self._step += 1
        for n, t in zip(step.outputs, outputs):
            scope.set(n, t.clone())
        return [t.clone() for t in fetches]

    def _dot_at_capture(self, entry: _Analysed, step: "_CompiledStep"):
        """Under ``PADDLE_TPU_XLA_DUMP_DIR``, the card's capture of a
        recorded entry writes the graph's DOT beside its cost record."""
        out_dir = _insight.dump_dir()
        if (out_dir and entry.insight is not None
                and self.device.type == "cuda"):
            step.run.dump_dot = _insight.dot_path(entry.insight, out_dir)

    @contextlib.contextmanager
    def _counted(self, program, entry: _Analysed, inputs: Dict[str, Any],
                 on: bool = True):
        """The insight of an entry's first run: counted once (eager on
        either route; never a capture), stored on the entry and dumped
        under ``PADDLE_TPU_XLA_DUMP_DIR``. ``inputs`` are the values the
        run reads; the body puts what it returns and writes into the list
        this yields."""
        outs: List[torch.Tensor] = []
        if not on or entry.runs or not _insight.enabled():
            yield outs
            return
        inputs = list(inputs.values())  # the run adds its values to env
        with _insight.recording(self.device) as rec:
            yield outs
        block = program.global_block()
        entry.insight = _insight.record(
            rec, key_hash=entry.key_hash,
            label=",".join(entry.fetch_names) or "program",
            fetch_names=entry.fetch_names,
            n_ops=sum(op.type not in _STRUCTURAL_OPS for op in block.ops),
            argument_bytes=_bytes(inputs),
            output_bytes=_bytes(t for t in outs
                                if not any(t is v for v in inputs)))
        out_dir = _insight.dump_dir()
        if out_dir:
            try:
                _insight.dump_artifacts(entry.insight, out_dir,
                                        ops_text=_op_list(program))
            except OSError:
                pass  # a dump must not take down a run that works

    def _after_run(self, program, entry: _Analysed) -> None:
        """memwatch's sample (building runs, then every
        PADDLE_TPU_MEMWATCH_SAMPLE_RUNS runs) and the numerics verdict."""
        self._runs_since_sample += 1
        if self._last_run_compiled or self._runs_since_sample >= max(
                1, int(_flags.env_flag("PADDLE_TPU_MEMWATCH_SAMPLE_RUNS"))):
            self._runs_since_sample = 0
            _memwatch.sample(self.device)
        bad = entry.probes.first_bad() if entry.probes else None
        if bad is None:
            return
        op_idx, op_type, var = bad
        _M_NONFINITE.inc()
        if entry.check_numerics:
            # numerics sentinel: a typed error carrying the producing
            # op's provenance (type, block/op idx, build callstack)
            op = program.global_block().ops[op_idx]
            raise _errs.attach_op_provenance(
                _errs.errors.InvalidArgument(
                    f"check_numerics: op #{op_idx} {op_type!r} produced "
                    f"non-finite values in output {var!r}"),
                op, op_idx=op_idx)
        raise FloatingPointError(
            f"FLAGS_check_nan_inf: op #{op_idx} {op_type!r} produced "
            f"nan/inf in output {var!r}")

    def _refuse_unported(self, program) -> None:
        if getattr(program, "_pipeline_meta", None) is not None:
            raise _unported("pipeline-parallel programs", "A10")
        if (getattr(program, "_mesh", None) is not None
                or getattr(program, "_sharding_recipe", None) is not None):
            raise _unported("mesh and sharding-recipe programs", "A10")

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
        # the check flags change what a run does, so they are part of the
        # key (flipping either after a first run builds a new entry)
        check_numerics = bool(_flags.env_flag("PADDLE_TPU_CHECK_NUMERICS"))
        check_nan = (bool(_flags.get_flags("FLAGS_check_nan_inf"))
                     or check_numerics)
        key = (id(program), program._version, feed_spec, tuple(fetch_names),
               id(scope), check_nan, check_numerics)
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
        entry.fetch_names = tuple(fetch_names)
        if check_nan:
            entry.probes = Probes()
            entry.check_numerics = check_numerics
        # the insight/dump label hashes program STRUCTURE, not the cache
        # key (whose ids change every process), so a reused dump dir
        # overwrites a program's artifacts instead of duplicating them
        entry.key_hash = _insight.key_hash((
            tuple(op.type for b in program.blocks for op in b.ops),
            feed_spec, tuple(fetch_names), check_nan, check_numerics))
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


def _bytes(values) -> int:
    """Bytes of the distinct tensors among ``values``."""
    seen, total = set(), 0
    for t in values:
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


def _op_list(program) -> str:
    """The program's ops, one a line, in place of the JAX package's
    jaxpr: block, index, type, inputs and outputs."""
    lines = []
    for b in program.blocks:
        for i, op in enumerate(b.ops):
            ins = ", ".join(f"{slot}={args}" for slot, args in op.desc.inputs)
            outs = ", ".join(f"{slot}={args}"
                             for slot, args in op.desc.outputs)
            lines.append(f"{b.idx}:{i} {op.type}({ins}) -> {outs}")
    return "\n".join(lines) + "\n"


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
