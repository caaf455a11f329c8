"""Goodput accounting: where does each training second actually go.

Port of ``paddle_tpu/goodput.py``. It holds no device code, so the
ledger, its journal and its views are the JAX package's; the port
differs in its producers. The port's executor feeds it as the JAX
package's does: a run that builds a fresh program (a cache miss, the
compiled route's eager warm-up and its capture) adds its wall time to
``compile``, a replayed or steady eager run to ``device_compute``. The
fit loop, DataLoader and collectives that also feed it there are not
ported (ROADMAP A8, A10); a step loop of the port's own calls
``add``/``end_step`` directly. ``end_step`` closes the memory and
training-dynamics ledgers (``memwatch.py``, ``dynamics.py``) beside the
goodput step, as there; the interconnect ledger (commswatch) waits for
A12.

The ledger decomposes each step's wall time into typed buckets and
keeps a cumulative **goodput ledger** (productive seconds vs. badput by
bucket):

  device_compute   the step's device execution window (productive time)
  collective       host-blocking collective wait (eager cross-process ops)
  input_wait       DataLoader consumer blocking / synchronous produce
  compile          trace + compile of a fresh program (cache miss)
  host_other       unattributed remainder of the step (framework overhead,
                   metric host transfers, callbacks)

Per-step accounting is two-phase: subsystems `add()` into the OPEN
step; the step loop calls `end_step(wall_seconds)` which assigns the
unattributed remainder to ``host_other`` and folds the step into the
cumulative ledger — so the bucket seconds of a closed step sum to its
wall clock by construction. Nested windows stay consistent via
`mark()`: a step loop records ``window_wall - (attributed inside the
window)`` as device compute, so a compile or collective inside the
window is never double-counted.

The ledger persists via a small per-rank journal
(``PADDLE_TPU_GOODPUT_DIR/goodput.rank<k>.json``, atomic
write-temp-then-rename): a restarted rank resumes its cumulative totals
from the journal, and `load_journals()` sums the per-rank files into the
job-level view. The live per-step view (throughput EMA, goodput %,
bucket breakdown, flight-recorder tail) is served by ``status.py`` on
``PADDLE_TPU_STATUS_PORT``; the ``goodput_*`` series ride ``/metrics``.

Env knobs (declared in ``flags.py``):
  PADDLE_TPU_GOODPUT_DIR          journal directory (enables persistence)
  PADDLE_TPU_GOODPUT_FLUSH_STEPS  journal flush cadence in steps (50)
  PADDLE_TPU_STATUS_PORT          per-process live status HTTP endpoint
"""
from __future__ import annotations

import atexit
import glob
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from . import flags as _flags
from . import monitor as _monitor

__all__ = [
    "BUCKETS", "PRODUCTIVE_BUCKETS", "GoodputLedger",
    "add", "mark", "discard_open", "end_step", "totals", "summary",
    "status", "reset",
    "configure", "disable_persistence", "flush", "journal_path",
    "load_journal", "load_journals", "merge_ledgers",
    "top_badput", "render_summary", "classify_span", "attribute_events",
]

SCHEMA = "paddle_tpu.goodput/1"

BUCKETS = ("device_compute", "collective", "input_wait", "compile",
           "host_other")
PRODUCTIVE_BUCKETS = ("device_compute",)

# EMA smoothing for step time / throughput (~ last 10 steps dominate)
_EMA_ALPHA = 0.1

# goodput rides the metrics registry too, so the Prometheus endpoint and
# the JSON snapshot both carry the attribution
_M_BUCKET_S = _monitor.counter(
    "goodput_bucket_seconds_total",
    "cumulative attributed step seconds by bucket", ("bucket",))
_M_FRACTION = _monitor.gauge(
    "goodput_fraction",
    "productive fraction of closed-step wall time (device compute / wall)")
_M_STEP_EMA = _monitor.gauge(
    "goodput_step_seconds_ema", "EMA of closed-step wall time")


def _zero_buckets() -> Dict[str, float]:
    return {b: 0.0 for b in BUCKETS}


def _finalize(doc: Dict[str, Any], buckets: Dict[str, float],
              wall: float,
              open_part: Optional[Dict[str, float]] = None
              ) -> Dict[str, Any]:
    """Attach the derived fields (productive/badput seconds, goodput
    fraction) to a ledger doc — the ONE place the fraction is defined.
    Step-accounted when closed-step wall exists (an open tail cannot
    push the fraction past 1.0); attributed-sums otherwise."""
    if wall > 0:
        productive = sum(buckets[b] - (open_part or {}).get(b, 0.0)
                         for b in PRODUCTIVE_BUCKETS)
        denom = wall
    else:
        productive = sum(buckets[b] for b in PRODUCTIVE_BUCKETS)
        denom = sum(buckets.values())
    doc.update({
        "buckets": buckets,
        "productive_seconds": productive,
        "badput_seconds": max(0.0, denom - productive),
        "goodput_fraction": (productive / denom) if denom > 0 else None,
        # the comms headline tools/perf_gate.py gates (lower is better):
        # fraction of wall the host spent blocked on collectives
        "collective_fraction": (buckets["collective"] / denom
                                if denom > 0 else None),
    })
    return doc


def _invalid(msg: str):
    from .framework import errors as _errors

    return _errors.errors.InvalidArgument(msg)


class GoodputLedger:
    """Cumulative step-time attribution for one process.

    Thread-safe; `add()` feeds the open step, `end_step()` closes it.
    `base` holds totals resumed from a prior incarnation's journal so the
    cumulative view survives restarts."""

    def __init__(self):
        self._lock = threading.RLock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.buckets = _zero_buckets()   # closed steps, this process
            self.open = _zero_buckets()      # the in-flight step
            self.steps = 0
            self.wall_seconds = 0.0
            self.samples = 0.0
            self.current_step: Optional[int] = None
            self.last_step: Optional[dict] = None
            self.step_seconds_ema: Optional[float] = None
            self.samples_per_sec_ema: Optional[float] = None
            self.base: Optional[dict] = None
            self.started_unix = time.time()

    # -- recording ------------------------------------------------------
    def add(self, bucket: str, seconds: float) -> None:
        if bucket not in self.open:
            raise _invalid(
                f"goodput bucket {bucket!r} is not one of {BUCKETS}")
        if seconds <= 0.0:
            return
        with self._lock:
            self.open[bucket] += float(seconds)

    def mark(self) -> float:
        """Attributed seconds of the OPEN step so far. A caller timing a
        nested window records `window_wall - (mark() - mark_before)` to
        avoid double-counting contributions made inside the window."""
        with self._lock:
            return sum(self.open.values())

    def discard_open(self) -> None:
        """Drop the open step's attribution without closing a step. Step
        loops call this when (re)opening their step window so work
        that ran OUTSIDE any window (an eval pass between epochs, a
        predict call) cannot fold into the next step and inflate its
        buckets past its wall clock."""
        with self._lock:
            self.open = _zero_buckets()

    def end_step(self, wall_seconds: float, samples: Optional[float] = None,
                 step: Optional[int] = None) -> dict:
        """Close the in-flight step: assign the unattributed remainder of
        `wall_seconds` to host_other and fold into the cumulative ledger.
        Returns the closed step's bucket dict (summing to wall_seconds,
        unless the step was over-attributed, in which case host_other
        clamps at zero)."""
        wall = max(0.0, float(wall_seconds))
        with self._lock:
            attributed = sum(self.open.values())
            self.open["host_other"] += max(0.0, wall - attributed)
            closed = dict(self.open)
            for b, v in closed.items():
                self.buckets[b] += v
            self.open = _zero_buckets()
            self.steps += 1
            self.wall_seconds += wall
            if samples:
                self.samples += float(samples)
            if self.step_seconds_ema is None:
                self.step_seconds_ema = wall
            else:
                self.step_seconds_ema += _EMA_ALPHA * (
                    wall - self.step_seconds_ema)
            if samples and wall > 0:
                sps = float(samples) / wall
                if self.samples_per_sec_ema is None:
                    self.samples_per_sec_ema = sps
                else:
                    self.samples_per_sec_ema += _EMA_ALPHA * (
                        sps - self.samples_per_sec_ema)
            self.current_step = (int(step) if step is not None
                                 else (self.current_step or 0) + 1)
            self.last_step = {
                "step": self.current_step,
                "wall_seconds": wall,
                "buckets": closed,
            }
            return closed

    # -- views ----------------------------------------------------------
    def totals(self, include_open: bool = True) -> Dict[str, Any]:
        """Cumulative ledger: resumed base + closed steps (+ the open
        step's contributions by default, so executor-driven flows that
        never call end_step still expose their attributed seconds).
        ``include_open=False`` yields the closed-only view the journal
        persists — buckets and wall_seconds stay mutually consistent, so
        merged summaries can never exceed 100%."""
        with self._lock:
            open_part = dict(self.open) if include_open else _zero_buckets()
            buckets = {b: self.buckets[b] + open_part[b] for b in BUCKETS}
            steps = self.steps
            wall = self.wall_seconds
            samples = self.samples
            base = self.base
            doc: Dict[str, Any] = {
                "schema": SCHEMA,
                "rank": _monitor.trainer_rank(),
                "pid": os.getpid(),
                "time_unix": time.time(),
                "current_step": self.current_step,
                "last_step": self.last_step,
                "step_seconds_ema": self.step_seconds_ema,
                "samples_per_sec_ema": self.samples_per_sec_ema,
            }
        if base:
            for b in BUCKETS:
                buckets[b] += float(base.get("buckets", {}).get(b, 0.0))
            steps += int(base.get("steps", 0))
            wall += float(base.get("wall_seconds", 0.0))
            samples += float(base.get("samples", 0.0))
            doc["resumed_from_journal"] = True
        doc.update({"steps": steps, "wall_seconds": wall,
                    "samples": samples})
        return _finalize(doc, buckets, wall, open_part)


_LEDGER = GoodputLedger()
_JOURNAL_DIR: Optional[str] = None
_FLUSH_STEPS = max(1, int(_flags.env_flag("PADDLE_TPU_GOODPUT_FLUSH_STEPS")))
_steps_since_flush = 0
_atexit_registered = False


def ledger() -> GoodputLedger:
    return _LEDGER


def reset() -> None:
    """Drop all recorded attribution (journal base included); tests."""
    global _steps_since_flush
    _LEDGER.reset()
    _steps_since_flush = 0


def add(bucket: str, seconds: float) -> None:
    """Attribute `seconds` of the open step to `bucket`. No-op when the
    metrics layer is disabled (PADDLE_TPU_METRICS=0)."""
    if not _monitor.enabled():
        return
    _LEDGER.add(bucket, seconds)


def mark() -> float:
    return _LEDGER.mark()


def discard_open() -> None:
    _LEDGER.discard_open()


def end_step(wall_seconds: float, samples: Optional[float] = None,
             step: Optional[int] = None) -> Optional[dict]:
    """Close the current step (callers: step loops).
    Feeds the goodput metric series and the journal flush cadence."""
    global _steps_since_flush
    if not _monitor.enabled():
        return None
    closed = _LEDGER.end_step(wall_seconds, samples=samples, step=step)
    # the memory and dynamics ledgers share the step boundary: every
    # loop that closes a goodput step closes the memory watermark and the
    # training-dynamics record too, with no second hook to forget (the
    # JAX package's comms ledger waits for ROADMAP A12)
    try:
        from . import memwatch as _memwatch

        _memwatch.end_step(step=step)
    except Exception:
        pass  # memory accounting must never take down a step loop
    try:
        from . import dynamics as _dynamics

        _dynamics.end_step(step=step)
    except Exception:
        pass  # dynamics accounting must never take down a step loop
    for b, v in closed.items():
        if v > 0:
            _M_BUCKET_S.labels(bucket=b).inc(v)
    t = _LEDGER.totals()
    if t["goodput_fraction"] is not None:
        _M_FRACTION.set(t["goodput_fraction"])
    if t["step_seconds_ema"] is not None:
        _M_STEP_EMA.set(t["step_seconds_ema"])
    if _JOURNAL_DIR is not None:
        _steps_since_flush += 1
        if _steps_since_flush >= _FLUSH_STEPS:
            _steps_since_flush = 0
            try:
                flush()
            except OSError:
                pass  # a full disk must not kill the training loop
    return closed


def totals(include_open: bool = True) -> Dict[str, Any]:
    return _LEDGER.totals(include_open=include_open)


def top_badput(doc: Optional[Dict[str, Any]] = None
               ) -> Optional[Dict[str, Any]]:
    """The non-productive bucket holding the most seconds — the 'why is
    my step slow' headline. None when nothing has been attributed."""
    doc = doc or totals()
    worst, worst_s = None, 0.0
    for b, v in doc.get("buckets", {}).items():
        if b in PRODUCTIVE_BUCKETS:
            continue
        if v > worst_s:
            worst, worst_s = b, v
    if worst is None:
        return None
    return {"bucket": worst, "seconds": worst_s}


def summary() -> Dict[str, Any]:
    doc = totals()
    doc["top_badput"] = top_badput(doc)
    return doc


def status() -> Dict[str, Any]:
    """The /status document: ledger summary + liveness context + the
    flight-recorder tail (the last spans/progress marks this rank saw)."""
    doc = summary()
    doc["progress_count"] = _monitor.progress_count()
    doc["uptime_seconds"] = time.time() - _LEDGER.started_unix
    fr = _monitor.flight_recorder()
    doc["flight_tail"] = fr.events()[-20:] if fr is not None else []
    return doc


# ---------------------------------------------------------------------------
# journal persistence
# ---------------------------------------------------------------------------


def journal_path(dir: Optional[str] = None) -> str:
    base = dir or _JOURNAL_DIR or "."
    return os.path.join(base,
                        f"goodput.rank{_monitor.trainer_rank()}.json")


def configure(dir: Optional[str] = None,
              flush_steps: Optional[int] = None,
              resume: bool = True) -> None:
    """Set up journal persistence: totals flush to
    `<dir>/goodput.rank<k>.json` every `flush_steps` closed steps and at
    exit. With `resume`, an existing journal seeds the cumulative base so
    a restarted rank keeps its lifetime totals — but only while the
    in-process ledger is still pristine: once steps have been recorded
    (and possibly flushed), re-loading the journal as base would count
    them twice."""
    global _JOURNAL_DIR, _FLUSH_STEPS, _atexit_registered
    if dir:
        _JOURNAL_DIR = dir
        pristine = (_LEDGER.base is None and _LEDGER.steps == 0
                    and _LEDGER.mark() == 0.0)
        if resume and pristine:
            path = journal_path(dir)
            if os.path.exists(path):
                try:
                    _LEDGER.base = load_journal(path)
                except (OSError, ValueError):
                    _LEDGER.base = None  # torn/alien file: start fresh
        if not _atexit_registered:
            _atexit_registered = True
            atexit.register(_flush_at_exit)
    if flush_steps is not None:
        _FLUSH_STEPS = max(1, int(flush_steps))


def disable_persistence() -> None:
    """Drop journal persistence for THIS process (the atexit flush
    becomes a no-op). A supervisor that imports the package with the
    rank-observability env inherited (a launcher) calls
    this so its own exit can never clobber a real rank's journal."""
    global _JOURNAL_DIR
    _JOURNAL_DIR = None


def _rank_changed() -> None:
    """monitor.set_trainer_rank() notification: the resumed base (if
    any) belongs to the OLD rank's journal — drop it, and re-resume
    against the new identity while the ledger is still pristine. Keeps
    custom rank wiring (profiler.set_rank after import) from counting
    another rank's lifetime totals as this rank's."""
    if _JOURNAL_DIR is None:
        return
    _LEDGER.base = None
    if _LEDGER.steps == 0 and _LEDGER.mark() == 0.0:
        path = journal_path()
        if os.path.exists(path):
            try:
                _LEDGER.base = load_journal(path)
            except (OSError, ValueError):
                _LEDGER.base = None

def _flush_at_exit() -> None:
    try:
        flush()
    except OSError:
        pass


def flush(path: Optional[str] = None) -> Optional[str]:
    """Write the cumulative ledger journal (atomic: temp + os.replace —
    the status server and external readers can never observe a torn
    file). Journals persist the CLOSED-step view only, so their buckets
    and wall_seconds agree and cross-rank merges stay bounded at 100%.
    No-op when persistence is unconfigured and no path given."""
    if path is None:
        if _JOURNAL_DIR is None:
            return None
        path = journal_path()
    return _monitor.atomic_write_text(
        path, json.dumps(totals(include_open=False), indent=1))


def load_journal(path: str) -> Dict[str, Any]:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != SCHEMA:
        raise ValueError(f"{path}: not a goodput journal (schema "
                         f"{doc.get('schema')!r})")
    return doc


def load_journals(dir: str,
                  ranks: Optional[Sequence[int]] = None
                  ) -> Optional[Dict[str, Any]]:
    """Merge per-rank journals in `dir` into the job-level ledger
    (a launcher's teardown summary, a report). `ranks` limits
    the merge to this job's membership, so stale journals from an
    earlier, larger run sharing the directory don't skew the summary."""
    want = set(int(r) for r in ranks) if ranks is not None else None
    docs = []
    for path in sorted(glob.glob(os.path.join(dir, "goodput.rank*.json"))):
        try:
            doc = load_journal(path)
        except (OSError, ValueError):
            continue  # a torn file cannot happen (atomic), an alien can
        if want is None or int(doc.get("rank", -1)) in want:
            docs.append(doc)
    return merge_ledgers(docs) if docs else None


def merge_ledgers(docs: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Sum per-rank ledgers: bucket seconds, steps, wall and samples add;
    goodput fraction is recomputed over the summed denominators."""
    buckets = _zero_buckets()
    steps = 0
    wall = 0.0
    samples = 0.0
    ranks: List[int] = []
    for d in docs:
        for b in BUCKETS:
            buckets[b] += float(d.get("buckets", {}).get(b, 0.0))
        steps += int(d.get("steps", 0))
        wall += float(d.get("wall_seconds", 0.0))
        samples += float(d.get("samples", 0.0))
        if d.get("rank") is not None:
            ranks.append(int(d["rank"]))
    out = _finalize({
        "schema": SCHEMA,
        "ranks": sorted(ranks),
        "steps": steps,
        "wall_seconds": wall,
        "samples": samples,
    }, buckets, wall)
    out["top_badput"] = top_badput(out)
    return out


def render_summary(doc: Dict[str, Any], title: str = "goodput") -> str:
    """Human-readable ledger table (a teardown summary, a report)."""
    denom = doc.get("wall_seconds") or sum(
        doc.get("buckets", {}).values()) or 0.0
    frac = doc.get("goodput_fraction")
    head = f"== {title}: "
    head += (f"{frac * 100.0:.1f}% productive" if frac is not None
             else "no attributed time")
    head += (f" over {doc.get('steps', 0)} step(s), "
             f"{denom:.2f}s wall ==")
    lines = [head]
    for b in BUCKETS:
        v = float(doc.get("buckets", {}).get(b, 0.0))
        pct = (v / denom * 100.0) if denom > 0 else 0.0
        marker = "*" if b in PRODUCTIVE_BUCKETS else " "
        lines.append(f"  {marker}{b:<16} {v:>10.3f}s  {pct:>5.1f}%")
    worst = doc.get("top_badput") or top_badput(doc)
    if worst:
        lines.append(f"  top badput: {worst['bucket']} "
                     f"({worst['seconds']:.3f}s)")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# span-stream attribution (offline: rebuild buckets from recorded traces)
# ---------------------------------------------------------------------------

# span category / name-prefix -> bucket, for attributing a recorded trace
# the same way the live hooks do (reports, tests)
_SPAN_BUCKETS = (
    ("collective", "collective"),
    ("dataloader", "input_wait"),
)


def classify_span(name: str, cat: str = "") -> Optional[str]:
    """Bucket for a recorded span, by category first, name prefix second.
    Returns None for spans that are containers (executor/run, fit/step)
    rather than attributable waits."""
    for needle, bucket in _SPAN_BUCKETS:
        if cat == needle or name.startswith(needle + "/") or needle in name:
            return bucket
    return None


def attribute_events(events: List[dict]) -> Dict[str, float]:
    """Sum a profiler event list (name/cat/dur in us) into bucket seconds
    — the offline counterpart of the live hooks, for traces recorded
    before the goodput layer existed."""
    out = _zero_buckets()
    for e in events:
        b = classify_span(e.get("name", ""), e.get("cat", ""))
        if b is not None:
            out[b] += float(e.get("dur", 0.0)) / 1e6
    return out


# env-driven wiring: under a launcher (or a user export) every rank
# persists its ledger with no code change
_env_dir = _flags.env_flag("PADDLE_TPU_GOODPUT_DIR")
if _env_dir:
    try:
        os.makedirs(_env_dir, exist_ok=True)
        configure(dir=_env_dir)
    except OSError:
        pass  # unwritable dir: accounting stays in-process only
