"""Profiler: trace-context host spans + device tracing.

Port of ``paddle_tpu/profiler.py``: the host spans are unchanged, and
the device trace that the JAX package delegated to ``jax.profiler``
runs through ``torch.profiler`` (CUPTI kernel activity on the card,
exported as a chrome trace into the profile directory).

Counterpart of Paddle's paddle/fluid/platform/profiler.{h,cc}
(RecordEvent:126, EnableProfiler/DisableProfiler:208 with sorted op
tables) + device_tracer.cc (CUPTI kernel correlation) + tools/timeline.py,
and the Python wrapper python/paddle/fluid/profiler.py.

Distributed tracing layer on top of the reference design:

- every span carries ``step``/``rank`` plus a propagatable
  ``trace_id``/``span_id``/``parent_span_id``, so per-rank chrome-trace
  files merge into one multi-process timeline (tools/timeline.py, the
  reference counterpart);
- span timestamps are anchored to unix time (perf_counter epoch +
  offset), so traces from different processes share a clock.

Env knobs:
  PADDLE_TPU_TRACE=1          enable tracing at import
  PADDLE_TPU_TRACE_DIR=d      flush the trace to d/trace.rank<k>.json at
                              exit (and enable the monitor.py flight
                              recorder)
  PADDLE_TPU_TRACE_SAMPLE=r   always-on tracing at step-sampled rate r
                              (0 < r <= 1; record ~every 1/r-th step)
"""
from __future__ import annotations

import atexit
import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

from . import flags as _flags
from . import monitor as _monitor

_lock = threading.Lock()
# module-level (NOT thread-local) profiler state: the profiler may be
# stopped from a different thread than the one that started it, and the
# device trace / enabled flag must still be visible there
_enabled = False
# the running torch.profiler.profile (None = no device trace) and the
# directory its chrome trace is exported into
_device_trace = None
_device_trace_dir: Optional[str] = None
_events: List[dict] = []
_dropped = 0
_MAX_EVENTS = int(_flags.env_flag("PADDLE_TPU_TRACE_MAX_EVENTS"))
_tls = threading.local()  # per-thread span stack only

# perf_counter epoch -> unix-time anchor: per-rank trace files come from
# different processes and must share a clock for the timeline merge
_EPOCH_US = (time.time_ns() - time.perf_counter_ns()) / 1000.0


def span_clock_unix() -> float:
    """Unix seconds on THE span clock (perf_counter + the epoch anchor
    every exported span timestamp uses). Event producers that want their
    wall-clock stamps to line up with spans in a merged timeline (the
    serving router's health/attempt events) read this instead of
    time.time(): same monotonic source, same anchor, no drift between a
    span's exported ts and the event recorded next to it."""
    return (time.perf_counter_ns() / 1000.0 + _EPOCH_US) / 1e6


# ---------------------------------------------------------------------------
# trace identity: rank / step / trace id / sampling
# ---------------------------------------------------------------------------

_rank: Optional[int] = None
_step = 0
_step_sampled = True
_sample_rate = 1.0
_trace_id: Optional[str] = None
_trace_dir: Optional[str] = None
_span_ids = itertools.count(1)
_flush_registered = False


def current_rank() -> int:
    """This process's trainer rank (launch.py env protocol; 0 standalone).
    Backed by monitor.trainer_rank(), the shared resolver."""
    global _rank
    if _rank is None:
        _rank = _monitor.trainer_rank()
    return _rank


def set_rank(rank: int) -> None:
    global _rank
    _rank = int(rank)
    # one identity everywhere: goodput journals, flight dumps and the
    # status endpoints must follow a custom rank wiring too
    _monitor.set_trainer_rank(rank)


def current_step() -> int:
    return _step


def set_step(step: int) -> None:
    """Declare the current training step; spans record it, and with
    PADDLE_TPU_TRACE_SAMPLE only sampled steps record at all."""
    global _step, _step_sampled
    _step = int(step)
    if _sample_rate >= 1.0:
        _step_sampled = True
    elif _sample_rate <= 0.0:
        _step_sampled = False
    else:
        period = max(1, int(round(1.0 / _sample_rate)))
        _step_sampled = (_step % period == 0)


def set_sample_rate(rate: float) -> None:
    global _sample_rate
    _sample_rate = float(rate)
    set_step(_step)  # re-evaluate the current step under the new rate


def current_trace_id() -> str:
    """Process-wide trace id (one logical job run). RPC servers adopt the
    caller's trace id for the handled span instead."""
    global _trace_id
    if _trace_id is None:
        import uuid

        _trace_id = uuid.uuid4().hex[:16]
    return _trace_id


def _new_span_id() -> str:
    # rank+pid prefix keeps ids unique across the merged multi-rank trace
    return f"{current_rank()}.{os.getpid():x}.{next(_span_ids):x}"


def new_span_id() -> str:
    """Mint a globally-unique span id WITHOUT recording a span — for
    producers that must hand the id to a peer before the span's duration
    is known (the serving router pre-mints each dispatch-attempt id,
    ships it in ``__trace__``, and emits the attempt span on completion
    via emit_span(span_id=...))."""
    return _new_span_id()


def tracing_active() -> bool:
    """True when spans should record right now (enabled AND the current
    step is sampled)."""
    return _enabled and _step_sampled


class RecordEvent:
    """RAII span (reference profiler.h:126). Usable as context manager or
    decorator; nests via a per-thread stack; carries step/rank and a
    propagatable trace context.

    `remote` is a "trace_id:span_id" header from a peer process (the PS
    RPC client injects it); when given, the span parents onto the remote
    caller instead of the local stack."""

    def __init__(self, name: str, event_type: str = "op",
                 cat: Optional[str] = None, remote: Optional[str] = None):
        self.name = name
        self.event_type = event_type
        self.cat = cat or event_type
        self.remote = remote
        self._t0 = None
        self._pushed = False
        self.span_id: Optional[str] = None
        self.trace_id: Optional[str] = None
        self.parent_span_id: Optional[str] = None

    def __enter__(self):
        self.begin()
        return self

    def begin(self):
        if not tracing_active():
            return
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        if self.remote:
            tid, _, pid = str(self.remote).partition(":")
            self.trace_id = tid or current_trace_id()
            self.parent_span_id = pid or None
        else:
            self.trace_id = current_trace_id()
            self.parent_span_id = stack[-1][1] if stack else None
        self.span_id = _new_span_id()
        stack.append((self.name, self.span_id))
        self._pushed = True
        self._t0 = time.perf_counter_ns()

    def end(self):
        global _dropped
        if not self._pushed:
            return
        t1 = time.perf_counter_ns()
        stack = _tls.stack
        full = "/".join(n for n, _ in stack)
        stack.pop()
        self._pushed = False
        if self._t0 is None:
            return
        dur_us = (t1 - self._t0) / 1000.0
        event = {
            "name": full,
            "cat": self.cat,
            "ts": self._t0 / 1000.0,  # us, chrome tracing unit
            "dur": dur_us,
            "tid": threading.get_ident() % 10**6,
            "step": _step,
            "rank": current_rank(),
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
        }
        with _lock:
            if _enabled:
                if len(_events) < _MAX_EVENTS:
                    _events.append(event)
                else:
                    _dropped += 1
        # the flight recorder keeps the last-N spans even after the trace
        # buffer is exported/cleared (hang diagnosis)
        _monitor.flight_record("span", full, dur_us=round(dur_us, 1),
                               step=_step, cat=self.cat)

    def __exit__(self, *exc):
        self.end()
        return False


record_event = RecordEvent  # 2.0-style alias


def emit_span(name: str, cat: str = "op",
              t0_ns: Optional[int] = None, dur_ns: int = 0,
              meta: Optional[dict] = None,
              span_id: Optional[str] = None,
              parent_span_id: Optional[str] = None,
              step: Optional[int] = None,
              trace_id: Optional[str] = None) -> Optional[str]:
    """Append a COMPLETED span with explicit timestamps — for producers
    whose units of work interleave across requests (the serving engine's
    per-request lifecycle) and therefore cannot ride the per-thread
    RAII nesting stack. ``meta`` lands in the exported chrome args
    (request_id, tick, ...), and the returned span_id lets the caller
    chain lifecycles via ``parent_span_id``. Timestamps are
    perf_counter_ns (the RecordEvent clock), so emitted spans merge
    seamlessly with RAII spans in tools/timeline.py. ``trace_id``
    overrides the process-wide id — a replica parenting its lifecycle
    under an inbound ``__trace__`` context adopts the caller's trace id
    so the whole request shares one trace across processes."""
    global _dropped
    if not tracing_active():
        return None
    t0 = time.perf_counter_ns() if t0_ns is None else int(t0_ns)
    sid = span_id or _new_span_id()
    event = {
        "name": name,
        "cat": cat,
        "ts": t0 / 1000.0,
        "dur": max(0, int(dur_ns)) / 1000.0,
        "tid": threading.get_ident() % 10**6,
        "step": _step if step is None else int(step),
        "rank": current_rank(),
        "trace_id": trace_id or current_trace_id(),
        "span_id": sid,
        "parent_span_id": parent_span_id,
    }
    if meta:
        event["meta"] = dict(meta)
    with _lock:
        if _enabled:
            if len(_events) < _MAX_EVENTS:
                _events.append(event)
            else:
                _dropped += 1
    _monitor.flight_record("span", name, dur_us=round(event["dur"], 1),
                           step=event["step"], cat=cat)
    return sid


def emit_instant(name: str, cat: str = "op",
                 t0_ns: Optional[int] = None,
                 meta: Optional[dict] = None) -> Optional[str]:
    """Append an INSTANT event (chrome ph "i", process scope) — a
    zero-duration marker for point-in-time actions like the
    autoscaler's scale decisions, rendered as a vertical tick on the
    owning track so it can be eyeballed against the spans around it."""
    sid = emit_span(name, cat=cat, t0_ns=t0_ns, dur_ns=0, meta=meta)
    if sid is not None:
        with _lock:
            for e in reversed(_events):
                if e.get("span_id") == sid:
                    e["phase"] = "i"
                    break
    return sid


def span(name: str, cat: str = "op",
         remote: Optional[str] = None) -> RecordEvent:
    """A RecordEvent that no-ops cheaply when tracing is off — the helper
    every instrumentation site uses."""
    return RecordEvent(name, cat=cat, remote=remote)


def remote_context(sp: Optional[RecordEvent] = None) -> Optional[str]:
    """Serializable "trace_id:span_id" header for cross-process
    propagation; None when tracing is off. With `sp` (an open span), that
    span becomes the remote parent; otherwise the thread's current top."""
    if not tracing_active():
        return None
    if sp is not None and sp.span_id is not None:
        return f"{sp.trace_id}:{sp.span_id}"
    stack = getattr(_tls, "stack", None)
    if stack:
        return f"{current_trace_id()}:{stack[-1][1]}"
    return f"{current_trace_id()}:"


# ---------------------------------------------------------------------------
# start/stop + export
# ---------------------------------------------------------------------------


def enable_tracing(trace_dir: Optional[str] = None,
                   sample_rate: Optional[float] = None) -> None:
    """Turn span recording on (the PADDLE_TPU_TRACE=1 path). With a
    trace_dir, the trace is flushed to trace.rank<k>.json at exit."""
    global _enabled, _trace_dir, _flush_registered
    with _lock:
        _enabled = True
    if sample_rate is not None:
        set_sample_rate(sample_rate)
    if trace_dir:
        _trace_dir = trace_dir
        if not _flush_registered:
            _flush_registered = True
            atexit.register(flush_trace)


def start_profiler(state: str = "All", tracer_option: str = "Default",
                   profile_dir: Optional[str] = None):
    """Reference EnableProfiler (profiler.py start_profiler). Also starts
    the torch.profiler device trace (CPU + CUDA activity) when a
    directory is given."""
    global _enabled, _device_trace, _device_trace_dir, _dropped
    with _lock:
        _events.clear()
        _dropped = 0
        _enabled = True
    if profile_dir:
        import torch

        os.makedirs(profile_dir, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
        with _lock:
            _device_trace = prof
            _device_trace_dir = profile_dir


def get_events() -> List[dict]:
    """Snapshot of the recorded host spans (name/ts/dur(us)/tid plus
    step/rank/trace context) — the programmatic view tools/obs_report.py
    merges with the metrics snapshot."""
    with _lock:
        return list(_events)


def summarize_events(events: Optional[List[dict]] = None,
                     sorted_key: str = "total"):
    """Aggregate spans per name into (name, calls, total_us, min, max,
    avg) rows — the reference's sorted op table, reusable on either live
    events or a parsed chrome-trace file."""
    if events is None:
        events = get_events()
    agg: Dict[str, List[float]] = defaultdict(list)
    for e in events:
        agg[e["name"]].append(e["dur"])
    rows = [
        (name, len(ds), sum(ds), min(ds), max(ds), sum(ds) / len(ds))
        for name, ds in agg.items()
    ]
    key_idx = {"calls": 1, "total": 2, "min": 3, "max": 4, "ave": 5,
               "avg": 5}.get(sorted_key, 2)
    rows.sort(key=lambda r: -r[key_idx])
    return rows


def _chrome_trace(events: List[dict]) -> dict:
    """Events -> chrome://tracing doc. Short display names, but args
    always carry full_name/step/rank (+ span ids), so same-named ops
    under different parents stay disambiguable in merged timelines."""
    rank = current_rank()
    trace_events: List[dict] = [
        {"name": "process_name", "ph": "M", "pid": rank,
         "args": {"name": f"rank{rank}"}},
    ]
    for e in events:
        args = {
            "full_name": e["name"],
            "step": e.get("step", 0),
            "rank": e.get("rank", rank),
        }
        for key in ("trace_id", "span_id", "parent_span_id"):
            if e.get(key):
                args[key] = e[key]
        # explicit-timestamp spans (emit_span) carry producer metadata —
        # request_id, tick, outcome — into the chrome args verbatim
        if e.get("meta"):
            args.update(e["meta"])
        ev = {
            "name": e["name"].rsplit("/", 1)[-1],
            "cat": e.get("cat", "host"),
            "ph": e.get("phase", "X"),
            "ts": e["ts"] + _EPOCH_US,  # unix-anchored: cross-rank merge
            "dur": e["dur"],
            "pid": e.get("rank", rank),
            "tid": e["tid"],
            "args": args,
        }
        if ev["ph"] == "i":
            ev.pop("dur", None)
            ev["s"] = "p"  # instant scope: the whole process track
        trace_events.append(ev)
    doc = {"traceEvents": trace_events}
    if _dropped:
        doc["metadata"] = {"dropped_events": _dropped}
    return doc


def _write_chrome_trace(events: List[dict], path: str) -> str:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(_chrome_trace(events), f)
    return path


_own_flush_path: Optional[str] = None


def flush_trace(path: Optional[str] = None) -> Optional[str]:
    """Write the current span buffer as this rank's chrome-trace file
    (PADDLE_TPU_TRACE_DIR/trace.rank<k>.json unless a path is given);
    the input tools/timeline.py merges. No-op without events or a dir.

    If another process already owns trace.rank<k>.json (a respawned
    worker inherits the dead rank's trainer id), fall back to a
    pid-suffixed name so the hung attempt's trace — the artifact the
    hang-debug recipe needs — survives; timeline.py globs both."""
    global _own_flush_path
    with _lock:
        events = list(_events)
    if path is None:
        if not _trace_dir or not events:
            return None
        path = os.path.join(_trace_dir, f"trace.rank{current_rank()}.json")
        if os.path.exists(path) and _own_flush_path != path:
            path = os.path.join(
                _trace_dir,
                f"trace.rank{current_rank()}.pid{os.getpid()}.json")
        _own_flush_path = path
    return _write_chrome_trace(events, path)


def clear_events() -> None:
    """Drop the recorded spans (e.g. between separately-exported runs, so
    the env-registered atexit flush doesn't re-export stale events)."""
    global _dropped
    with _lock:
        _events.clear()
        _dropped = 0


def stop_profiler(sorted_key: str = "total",
                  profile_path: Optional[str] = None,
                  print_table: bool = True):
    """Reference DisableProfiler: prints the sorted span table; writes a
    chrome://tracing JSON when profile_path is given; stops the device
    trace if one is running — from ANY thread (module-level state) — and
    exports it as <profile_dir>/device_trace.rank<k>.json."""
    global _enabled, _device_trace
    with _lock:
        _enabled = False
        prof = _device_trace
        _device_trace = None
        events = list(_events)
    if prof is not None:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(
            _device_trace_dir, f"device_trace.rank{current_rank()}.json"))

    rows = summarize_events(events, sorted_key)
    if rows and print_table:
        print(f"{'Event':<48}{'Calls':>8}{'Total(us)':>14}{'Min':>10}{'Max':>10}{'Avg':>10}")
        for name, calls, tot, mn, mx, avg in rows[:50]:
            print(f"{name:<48}{calls:>8}{tot:>14.1f}{mn:>10.1f}{mx:>10.1f}{avg:>10.1f}")

    if profile_path:
        _write_chrome_trace(events, profile_path)
    return rows


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: str = "total", profile_path: Optional[str] = None):
    """Reference fluid.profiler.profiler context manager."""
    start_profiler(state)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


def is_profiler_enabled() -> bool:
    return _enabled


# env-driven auto-enable: under `distributed.launch --trace_dir`, every
# rank imports with PADDLE_TPU_TRACE(+_DIR) set and traces itself
# (all three knobs declared in paddle_tpu/flags.py)
_env_sample = float(_flags.env_flag("PADDLE_TPU_TRACE_SAMPLE"))
if _flags.env_flag("PADDLE_TPU_TRACE") or _env_sample > 0:
    enable_tracing(
        trace_dir=_flags.env_flag("PADDLE_TPU_TRACE_DIR") or None,
        sample_rate=_env_sample if _env_sample > 0 else None,
    )
