"""Live device-memory observability: watermarks, leaks, OOM blame.

Port of ``paddle_tpu/memwatch.py``. The ledger, its leak detector, the
per-rank journal, the cross-rank merge, the reconciliation and the
post-mortem are the JAX package's text; what differs is where the
numbers come from and what an OOM looks like:

- **sampling**: :func:`sample` reads the normalized allocator stats
  (``device.memory_stats()``: the CUDA caching allocator on the card,
  the storages of live CPU tensors on the CPU, ``source`` "synthetic")
  at the sites that mark step boundaries: ``Executor.run`` on every
  compiling run and every ``PADDLE_TPU_MEMWATCH_SAMPLE_RUNS`` runs, and
  :func:`end_step`. Each sample feeds the ``hbm_bytes_in_use`` /
  ``hbm_peak_bytes`` gauges (the JAX package's series names, so one
  dashboard reads either) and the open step's high-water mark. The
  card's peak is the allocator's ``allocated_bytes.all.peak``, which
  sees every allocation between samples, a CUDA graph's private pool
  included.
- **per-step ledger**: :func:`end_step` (riding ``goodput.end_step``)
  freezes the step's watermark, the step-over-step delta
  (``hbm_step_delta_bytes``) and the lifetime peak into a per-rank
  ledger with goodput's journal contract
  (``PADDLE_TPU_MEMWATCH_DIR/memwatch.rank<k>.json``, atomic writes,
  restart resume, rank re-anchor via ``monitor.set_trainer_rank``).
- **leak detector**: N consecutive closed steps of monotonic
  bytes_in_use growth (default 30, total growth over a minimum) emit a
  flight-recorder event and one warning per episode. A replayed step
  allocates nothing (its graph's pool was filled at capture), so the
  capture's one-time growth is one delta, not an episode.
- **reconciliation**: :func:`reconcile` compares the measured peak
  against the ``program_peak_bytes`` records of
  ``framework/xla_insight.py`` (the allocator's peak around each
  program's first run), with an explicit bound.
- **OOM post-mortem**: the executor routes an allocation failure
  (``torch.cuda.OutOfMemoryError``, bare or wrapped with an op's
  provenance) at a run, a capture or a readback through
  :func:`oom_error`, which returns the typed ``errors.ResourceExhausted``
  carrying the provenance of the op that was running when the allocator
  failed (the JAX package, which cannot know it, blames the op with the
  largest static output; so does the port when no op is named), a
  memory report (model/optimizer footprint by layer prefix, top
  programs by peak bytes, last live stats, remediation hints), and
  dumps the report as JSON next to the program dumps.

Env knobs (declared in ``flags.py``):
  PADDLE_TPU_MEMWATCH                sampling + ledger on/off (default on)
  PADDLE_TPU_MEMWATCH_DIR            journal directory (enables persistence)
  PADDLE_TPU_MEMWATCH_FLUSH_STEPS    journal flush cadence in steps (50)
  PADDLE_TPU_MEMWATCH_LEAK_STEPS     monotonic-growth window (30 steps)
  PADDLE_TPU_MEMWATCH_LEAK_MIN_MB    minimum growth across the window (8)
  PADDLE_TPU_MEMWATCH_SAMPLE_RUNS    executor sampling cadence (10 runs)
"""
from __future__ import annotations

import atexit
import collections
import glob
import json
import os
import re
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from . import flags as _flags
from . import monitor as _monitor

__all__ = [
    "MemLedger", "enabled", "ledger", "reset",
    "sample", "end_step", "totals", "status", "summary",
    "reset_window", "window_peak",
    "configure", "disable_persistence", "flush", "journal_path",
    "load_journal", "load_journals", "merge_ledgers",
    "reconcile", "is_oom_error", "oom_error", "build_postmortem",
    "dump_postmortem", "render_summary",
    "SCHEMA", "POSTMORTEM_SCHEMA",
]

SCHEMA = "paddle_tpu.memwatch/1"
POSTMORTEM_SCHEMA = "paddle_tpu.oom_postmortem/1"

# recent closed steps kept for /status and the timeline counter track
_SERIES_CAP = 256

# the live device-memory metric series (mirror of the goodput gauges: one
# snapshot answers "how much memory" the way it already answers "how
# much time")
_M_IN_USE = _monitor.gauge(
    "hbm_bytes_in_use",
    "device bytes in use at the last memwatch sample")
_M_PEAK = _monitor.gauge(
    "hbm_peak_bytes",
    "lifetime peak device bytes observed (max of allocator peak and "
    "sampled watermarks)")
_M_STEP_DELTA = _monitor.gauge(
    "hbm_step_delta_bytes",
    "bytes_in_use change across the last closed step (steady state ~0; "
    "sustained positive deltas are the leak signature)")
_M_LEAK = _monitor.counter(
    "hbm_leak_suspects_total",
    "leak-detector episodes (N consecutive growing steps)")


def enabled() -> bool:
    return _monitor.enabled() and bool(_flags.env_flag("PADDLE_TPU_MEMWATCH"))


def _leak_window_steps() -> int:
    return max(2, int(_flags.env_flag("PADDLE_TPU_MEMWATCH_LEAK_STEPS")))


def _leak_min_bytes() -> float:
    return float(_flags.env_flag("PADDLE_TPU_MEMWATCH_LEAK_MIN_MB")) * 1e6


class MemLedger:
    """Per-process device-memory ledger: open-step watermark, per-step
    deltas, lifetime peak, leak window. Thread-safe; `base` holds the
    journal a restarted rank resumed from (lifetime peak and step count
    survive, live samples obviously don't)."""

    def __init__(self):
        self._lock = threading.RLock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.samples = 0
            self.open_samples = 0     # samples since the last end_step
            self.steps = 0
            self.current_step: Optional[int] = None
            self.last_in_use = 0
            self.lifetime_peak = 0        # max over samples + allocator peak
            self.open_watermark = 0       # high-water mark of the open step
            self.window_watermark = 0     # bench window (reset_window())
            self.prev_step_end: Optional[int] = None
            self.last_step: Optional[dict] = None
            self.step_series: collections.deque = collections.deque(
                maxlen=_SERIES_CAP)
            self.leak_run = 0             # consecutive growing steps
            self.leak_growth = 0          # bytes grown across the run
            self.leak_events = 0
            self._leak_flagged = False    # one event per episode
            self.bytes_limit: Optional[int] = None
            self.source: Optional[str] = None
            self.base: Optional[dict] = None
            self.started_unix = time.time()

    # -- recording ------------------------------------------------------
    def observe(self, stats: Dict[str, Any]) -> None:
        """Fold one normalized memory_stats() reading into the ledger."""
        in_use = int(stats.get("bytes_in_use") or 0)
        peak = int(stats.get("peak_bytes_in_use") or 0)
        with self._lock:
            self.samples += 1
            self.open_samples += 1
            self.last_in_use = in_use
            self.lifetime_peak = max(self.lifetime_peak, in_use, peak)
            self.open_watermark = max(self.open_watermark, in_use)
            self.window_watermark = max(self.window_watermark, in_use)
            if stats.get("bytes_limit") is not None:
                self.bytes_limit = int(stats["bytes_limit"])
            if stats.get("source"):
                self.source = stats["source"]

    def end_step(self, step: Optional[int] = None,
                 leak_steps: Optional[int] = None,
                 leak_min_bytes: Optional[float] = None) -> Optional[dict]:
        """Close the in-flight step: freeze its watermark, compute the
        step-over-step bytes_in_use delta, advance the leak window.
        Returns the closed step record, or None when no sample landed in
        the step (nothing to account)."""
        leak_steps = leak_steps or _leak_window_steps()
        leak_min = (_leak_min_bytes() if leak_min_bytes is None
                    else float(leak_min_bytes))
        with self._lock:
            if self.open_samples == 0:
                return None
            self.open_samples = 0
            watermark = max(self.open_watermark, self.last_in_use)
            delta = (self.last_in_use - self.prev_step_end
                     if self.prev_step_end is not None else 0)
            self.steps += 1
            self.current_step = (int(step) if step is not None
                                 else (self.current_step or 0) + 1)
            closed = {
                "step": self.current_step,
                "t": time.time(),
                "watermark_bytes": watermark,
                "bytes_in_use": self.last_in_use,
                "delta_bytes": delta,
            }
            self.last_step = closed
            self.step_series.append(closed)
            self.prev_step_end = self.last_in_use
            self.open_watermark = self.last_in_use
            # leak window: monotonic growth over N steps, above the noise
            # floor, flags once; any non-growing step closes the episode
            leak = None
            if delta > 0:
                self.leak_run += 1
                self.leak_growth += delta
                if (not self._leak_flagged and self.leak_run >= leak_steps
                        and self.leak_growth >= leak_min):
                    self._leak_flagged = True
                    self.leak_events += 1
                    leak = {
                        "steps": self.leak_run,
                        "growth_bytes": self.leak_growth,
                        "bytes_in_use": self.last_in_use,
                    }
            else:
                self.leak_run = 0
                self.leak_growth = 0
                self._leak_flagged = False
            closed["leak"] = leak
            return closed

    # -- views ----------------------------------------------------------
    def totals(self) -> Dict[str, Any]:
        with self._lock:
            steps = self.steps
            peak = self.lifetime_peak
            doc: Dict[str, Any] = {
                "schema": SCHEMA,
                "rank": _monitor.trainer_rank(),
                "pid": os.getpid(),
                "time_unix": time.time(),
                "source": self.source,
                "samples": self.samples,
                "current_step": self.current_step,
                "last_step": dict(self.last_step) if self.last_step else None,
                "bytes_in_use": self.last_in_use,
                "bytes_limit": self.bytes_limit,
                "leak_events": self.leak_events,
                "leak_run_steps": self.leak_run,
                "leak_run_growth_bytes": self.leak_growth,
                "step_series": [dict(s) for s in self.step_series],
            }
        if self.base:
            steps += int(self.base.get("steps", 0))
            peak = max(peak, int(self.base.get("lifetime_peak_bytes", 0)))
            doc["resumed_from_journal"] = True
        doc["steps"] = steps
        doc["lifetime_peak_bytes"] = peak
        if doc["bytes_limit"]:
            doc["peak_fraction_of_limit"] = peak / doc["bytes_limit"]
        return doc


_LEDGER = MemLedger()
_JOURNAL_DIR: Optional[str] = None
_FLUSH_STEPS = max(1, int(_flags.env_flag("PADDLE_TPU_MEMWATCH_FLUSH_STEPS")))
_steps_since_flush = 0
_atexit_registered = False
_LAST_DEVICE = None  # the device the executor last sampled


def ledger() -> MemLedger:
    return _LEDGER


def reset() -> None:
    """Drop everything recorded (journal base included); tests."""
    global _steps_since_flush, _LAST_DEVICE
    _LEDGER.reset()
    _steps_since_flush = 0
    _LAST_DEVICE = None


def sample(device=None, stats: Optional[Dict[str, Any]] = None
           ) -> Optional[Dict[str, Any]]:
    """Read the device allocator (or fold in a caller-provided normalized
    `stats` dict) and update gauges + the open step's watermark. The
    card's cost is one allocator query; no ``device`` reads the device of
    the last sample that named one (the executor names its own), else
    ``device.memory_stats``'s default. Returns the normalized stats, or
    None when memwatch is disabled or the read failed."""
    global _LAST_DEVICE
    if not enabled():
        return None
    if stats is None:
        if device is None:
            device = _LAST_DEVICE
        else:
            _LAST_DEVICE = device
        try:
            from . import device as _device

            stats = _device.memory_stats(device)
        except Exception:
            return None  # a failed allocator read must never kill a run
    _LEDGER.observe(stats)
    _M_IN_USE.set(_LEDGER.last_in_use)
    _M_PEAK.set(_LEDGER.lifetime_peak)
    return stats


def end_step(step: Optional[int] = None) -> Optional[dict]:
    """Close the memory step (called by goodput.end_step, so every step
    loop participates for free).
    When no sample landed in the open step (a loop that never touched
    the executor), one fresh sample is taken so the step still records
    a real watermark; samples fed explicitly are never overwritten."""
    global _steps_since_flush
    if not enabled():
        return None
    if _LEDGER.open_samples == 0:
        sample()
    closed = _LEDGER.end_step(step=step)
    if closed is None:
        return None
    _M_STEP_DELTA.set(closed["delta_bytes"])
    if closed.get("leak"):
        _M_LEAK.inc()
        leak = closed["leak"]
        _monitor.flight_record(
            "memwatch", "leak_suspect", step=closed["step"],
            steps=leak["steps"], growth_bytes=leak["growth_bytes"],
            bytes_in_use=leak["bytes_in_use"])
        print(f"[paddle_tpu_torch.memwatch] leak suspect: bytes_in_use grew "
              f"{leak['growth_bytes'] / 1e6:.1f}MB over {leak['steps']} "
              f"consecutive steps (now {leak['bytes_in_use'] / 1e6:.1f}MB)",
              file=sys.stderr)
    if _JOURNAL_DIR is not None:
        _steps_since_flush += 1
        if _steps_since_flush >= _FLUSH_STEPS:
            _steps_since_flush = 0
            try:
                flush()
            except OSError:
                pass  # a full disk must not kill the training loop
    return closed


def totals() -> Dict[str, Any]:
    return _LEDGER.totals()


def reset_window() -> None:
    """Open a measurement window (a benchmark's config): window_peak() then
    reports the high-water mark seen since. A fresh sample re-anchors
    the floor first — the previous window's buffers may have been freed
    since the last sample, and a stale last_in_use would floor this
    window's peak at the prior config's footprint."""
    sample()
    with _LEDGER._lock:
        _LEDGER.window_watermark = _LEDGER.last_in_use


def window_peak() -> int:
    return _LEDGER.window_watermark


def summary() -> Dict[str, Any]:
    doc = totals()
    doc.pop("step_series", None)
    return doc


def status() -> Dict[str, Any]:
    """The /status `memory` section: live totals + the recent per-step
    watermark tail (bounded — the full series stays in the journal)."""
    doc = totals()
    doc["step_tail"] = doc.pop("step_series", [])[-20:]
    return doc


# ---------------------------------------------------------------------------
# journal persistence (the goodput.py contract, memory-shaped)
# ---------------------------------------------------------------------------


def journal_path(dir: Optional[str] = None) -> str:
    base = dir or _JOURNAL_DIR or "."
    return os.path.join(base,
                        f"memwatch.rank{_monitor.trainer_rank()}.json")


def configure(dir: Optional[str] = None,
              flush_steps: Optional[int] = None,
              resume: bool = True) -> None:
    """Set up journal persistence; with `resume`, an existing journal
    seeds the lifetime peak/step base — but only while the in-process
    ledger is still pristine (same double-count guard as goodput)."""
    global _JOURNAL_DIR, _FLUSH_STEPS, _atexit_registered
    if dir:
        _JOURNAL_DIR = dir
        pristine = _LEDGER.base is None and _LEDGER.steps == 0 \
            and _LEDGER.samples == 0
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
    """Supervisor hook (a launcher): its own exit must never clobber a
    real rank's journal."""
    global _JOURNAL_DIR
    _JOURNAL_DIR = None


def _rank_changed() -> None:
    """monitor.set_trainer_rank() notification — mirror of
    goodput._rank_changed: drop the old identity's base, re-resume
    against the new rank's journal while still pristine."""
    if _JOURNAL_DIR is None:
        return
    _LEDGER.base = None
    if _LEDGER.steps == 0 and _LEDGER.samples == 0:
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
    """Write the ledger journal (atomic temp + os.replace). No-op when
    persistence is unconfigured and no path given."""
    if path is None:
        if _JOURNAL_DIR is None:
            return None
        path = journal_path()
    return _monitor.atomic_write_text(path, json.dumps(totals(), indent=1))


def load_journal(path: str) -> Dict[str, Any]:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != SCHEMA:
        raise ValueError(f"{path}: not a memwatch journal (schema "
                         f"{doc.get('schema')!r})")
    return doc


def load_journals(dir: str,
                  ranks: Optional[Sequence[int]] = None
                  ) -> Optional[Dict[str, Any]]:
    """Merge per-rank memwatch journals in `dir` (obs_report --memwatch,
    launch teardown). `ranks` limits to this job's membership."""
    want = set(int(r) for r in ranks) if ranks is not None else None
    docs = []
    for path in sorted(glob.glob(os.path.join(dir, "memwatch.rank*.json"))):
        try:
            doc = load_journal(path)
        except (OSError, ValueError):
            continue
        if want is None or int(doc.get("rank", -1)) in want:
            docs.append(doc)
    return merge_ledgers(docs) if docs else None


def merge_ledgers(docs: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Cross-rank view: per-rank peaks listed individually (device memory is a
    per-chip resource — summing peaks would be meaningless), job peak =
    max, leak events summed."""
    per_rank: Dict[str, dict] = {}
    peak = 0
    leaks = 0
    steps = 0
    for d in docs:
        r = str(d.get("rank", len(per_rank)))
        per_rank[r] = {
            "lifetime_peak_bytes": int(d.get("lifetime_peak_bytes", 0)),
            "bytes_in_use": int(d.get("bytes_in_use", 0)),
            "bytes_limit": d.get("bytes_limit"),
            "steps": int(d.get("steps", 0)),
            "leak_events": int(d.get("leak_events", 0)),
            "source": d.get("source"),
        }
        peak = max(peak, per_rank[r]["lifetime_peak_bytes"])
        leaks += per_rank[r]["leak_events"]
        steps = max(steps, per_rank[r]["steps"])
    # top-level headline fields so multi-rank consumers (launch
    # teardown, obs_report) keep the %-of-limit view: the tightest
    # per-chip limit and the fullest chip are what the headline answers
    limits = [r["bytes_limit"] for r in per_rank.values()
              if r["bytes_limit"]]
    sources = sorted({r["source"] for r in per_rank.values()
                      if r["source"]})
    return {
        "schema": SCHEMA,
        "ranks": sorted(per_rank, key=int),
        "steps": steps,
        "lifetime_peak_bytes": peak,
        "bytes_in_use": max(
            (r["bytes_in_use"] for r in per_rank.values()), default=0),
        "bytes_limit": min(limits) if limits else None,
        "source": ",".join(sources) if sources else None,
        "leak_events": leaks,
        "per_rank": dict(sorted(per_rank.items(), key=lambda kv: int(kv[0]))),
    }


def _fmt_bytes(n: float) -> str:
    """Adaptive unit so a 4KB test journal doesn't render as 0.00MB."""
    n = float(n or 0)
    for bound, div, unit in ((1e9, 1e9, "GB"), (1e6, 1e6, "MB"),
                             (1e3, 1e3, "KB")):
        if n >= bound:
            return f"{n / div:.2f}{unit}"
    return f"{n:.0f}B"


def render_summary(doc: Dict[str, Any], title: str = "memory") -> str:
    """Human-readable one-glance memory table (obs_report text mode)."""
    peak = float(doc.get("lifetime_peak_bytes") or 0)
    lines = [f"== {title}: peak {_fmt_bytes(peak)} over "
             f"{doc.get('steps', 0)} step(s) =="]
    if doc.get("bytes_limit"):
        lines[0] = lines[0][:-3] + (
            f", {peak / doc['bytes_limit'] * 100.0:.1f}% of "
            f"{_fmt_bytes(doc['bytes_limit'])} limit ==")
    if doc.get("per_rank"):
        for r, row in doc["per_rank"].items():
            lines.append(
                f"  rank{r}: peak={_fmt_bytes(row['lifetime_peak_bytes'])} "
                f"in_use={_fmt_bytes(row['bytes_in_use'])} "
                f"leaks={row['leak_events']}")
    elif doc.get("bytes_in_use") is not None:
        lines.append(f"  in_use={_fmt_bytes(doc['bytes_in_use'])} "
                     f"leaks={doc.get('leak_events', 0)}")
    rec = doc.get("reconciliation")
    if rec and rec.get("available"):
        lines.append(
            f"  estimate-vs-actual: static={_fmt_bytes(rec['static_peak_bytes'])} "
            f"measured={_fmt_bytes(rec['measured_peak_bytes'])} "
            f"utilization={rec['utilization']:.2f} "
            f"(bound x{rec['bound_factor']:g}: "
            f"{'OK' if rec['within_bound'] else 'OUTSIDE'})")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# estimate-vs-actual reconciliation
# ---------------------------------------------------------------------------


def reconcile(estimates: Optional[Sequence[float]] = None,
              measured_peak: Optional[float] = None,
              bound_factor: float = 4.0) -> Dict[str, Any]:
    """Compare the measured peak against the static per-program
    ``program_peak_bytes`` records (``framework/xla_insight.py``: the
    allocator's peak around each program's first run, plus its inputs).

    The stated bound: the largest program's estimate and the measured
    watermark must agree within ``bound_factor`` in either direction.
    The estimate is per-program (inputs plus what ONE program's run
    allocated) while the measurement sees the whole process — scope
    copies, other resident programs — so exact equality is not the
    contract; an order-of-magnitude disagreement means either the
    estimate or the sampling is lying and fails ``within_bound``."""
    if estimates is None:
        from .framework import xla_insight as _insight

        estimates = [i.peak_bytes for i in _insight.recent()
                     if i.peak_bytes]
    if measured_peak is None:
        measured_peak = totals()["lifetime_peak_bytes"]
    est = max((float(e) for e in estimates or [] if e), default=0.0)
    measured = float(measured_peak or 0.0)
    if est <= 0 or measured <= 0:
        return {"available": False,
                "static_peak_bytes": est or None,
                "measured_peak_bytes": measured or None}
    ratio = measured / est
    return {
        "available": True,
        "static_peak_bytes": int(est),
        "measured_peak_bytes": int(measured),
        "utilization": round(ratio, 4),
        "bound_factor": bound_factor,
        "within_bound": (1.0 / bound_factor) <= ratio <= bound_factor,
    }


# ---------------------------------------------------------------------------
# OOM post-mortem (the executor RESOURCE_EXHAUSTED hook)
# ---------------------------------------------------------------------------

_OOM_NEEDLES = ("resource_exhausted", "resource exhausted",
                "out of memory", "allocation failure")
# "oom" must be word-bounded: a bare substring would misclassify
# "no room left", "bloom", ... as device allocation failures
_OOM_WORD_RE = re.compile(r"\boom\b")


def is_oom_error(exc: BaseException) -> bool:
    """Does this look like a device allocation failure? The caching
    allocator raises ``torch.cuda.OutOfMemoryError``, which an op's
    lowering may have wrapped with the op's provenance (it is then the
    ``__cause__``); an already typed ResourceExhausted counts too, and so
    does a message that says so (a CUDA runtime error)."""
    import torch

    from .framework import errors as _errs

    seen = 0
    e: Optional[BaseException] = exc
    while e is not None and seen < 8:
        if isinstance(e, (_errs.ResourceExhaustedError,
                          torch.cuda.OutOfMemoryError)):
            return True
        text = f"{type(e).__name__}: {e}".lower()
        if (any(n in text for n in _OOM_NEEDLES)
                or _OOM_WORD_RE.search(text) is not None):
            return True
        e, seen = e.__cause__, seen + 1
    return False


def _output_bytes(block, op) -> int:
    """Static bytes of an op's outputs (-1 dims count as 1)."""
    from .framework.core import convert_dtype

    total = 0
    for name in op.output_arg_names():
        var = block._find_var_recursive(name)
        if var is None:
            continue
        try:
            n = 1
            for d in var.shape:
                n *= max(int(d), 1)
            total += n * convert_dtype(var.dtype).itemsize
        except (TypeError, ValueError, RuntimeError):
            continue
    return total


def _raising_op(exc: BaseException, program):
    """(bytes, op, op_idx) of the op whose run raised ``exc``, from the
    op provenance the executor attached; None when it names none."""
    prov = getattr(exc, "op_provenance", None)
    idx = getattr(prov, "op_idx", None)
    if idx is None:
        return None
    try:
        block = program.global_block()
        op = block.ops[idx]
    except (AttributeError, IndexError):
        return None
    return _output_bytes(block, op), op, idx


def _blame_op(program):
    """The op with the largest static output footprint — the best
    compile-time guess at who tipped the allocator over, where no op is
    known to have raised. Dynamic (-1) dims count as 1, so the ranking
    favors fully-known big tensors (activations, logits) over batch
    placeholders."""
    best = None  # (bytes, op, op_idx)
    try:
        block = program.global_block()
    except Exception:
        return None
    for idx, op in enumerate(block.ops):
        total = _output_bytes(block, op)
        if total > 0 and (best is None or total > best[0]):
            best = (total, op, idx)
    return best


def _remediation_hints(footprint: Optional[dict],
                       live: Optional[dict]) -> List[str]:
    hints = [
        "reduce the batch size or sequence length (activation and logits "
        "buffers scale linearly with both)",
        "run the card eagerly (PADDLE_TPU_EAGER=1) to see whether the "
        "CUDA graph's private pool, which holds every intermediate of the "
        "captured step at once, is what does not fit",
        "check torch.cuda.set_per_process_memory_fraction and other "
        "processes on the card: bytes_limit is the card's total memory",
    ]
    limit = (live or {}).get("bytes_limit")
    state = (footprint or {}).get("total_bytes", 0)
    if limit and state and state > 0.5 * limit:
        hints.insert(0, (
            f"model+optimizer state alone holds "
            f"{state / limit * 100.0:.0f}% of device memory "
            f"({state / 1e9:.2f}GB of {limit / 1e9:.2f}GB) — shard it "
            f"across cards (not ported yet: ROADMAP A10)"))
    return hints


def build_postmortem(exc: BaseException, program=None, scope=None,
                     insights: Optional[List[dict]] = None,
                     blame=None) -> Dict[str, Any]:
    """Everything an operator needs to explain an OOM, as one JSON doc:
    who (blamed op + provenance), what (live stats, per-step watermark
    tail), how big (footprint by layer prefix, top programs by estimated
    peak), and what to do about it (hints). `blame` is a precomputed
    :func:`_blame_op` result (the executor hook passes it so the block is
    scanned once)."""
    live = sample() or {}
    doc: Dict[str, Any] = {
        "schema": POSTMORTEM_SCHEMA,
        "time_unix": time.time(),
        "rank": _monitor.trainer_rank(),
        "pid": os.getpid(),
        "error": f"{type(exc).__name__}: {exc}"[:4000],
        "live": {k: v for k, v in live.items() if k != "raw"},
        "ledger": summary(),
        "step_tail": totals().get("step_series", [])[-20:],
    }
    if blame is None and program is not None:
        blame = _blame_op(program)
    if blame is not None:
        from .framework import errors as _errs

        nbytes, op, idx = blame
        prov = _errs.provenance_of(op, op_idx=idx)
        doc["blame"] = {
            "op_type": prov.op_type,
            "op_idx": idx,
            "output_bytes_estimate": nbytes,
            "callstack": list(prov.callstack),
        }
    if program is not None and scope is not None:
        try:
            from .framework import xla_insight as _insight

            doc["footprint"] = _insight.program_footprint(program, scope)
        except Exception:
            doc["footprint"] = None
    if insights is None:
        try:
            from .framework import xla_insight as _insight

            insights = [i.to_dict() for i in _insight.recent()]
        except Exception:
            insights = []
    top = sorted((i for i in insights if i.get("peak_bytes")),
                 key=lambda i: -i["peak_bytes"])[:5]
    doc["top_programs"] = [
        {"program": i.get("key_hash"), "label": i.get("label"),
         "peak_bytes": i.get("peak_bytes"), "flops": i.get("flops"),
         "temp_bytes": i.get("temp_bytes"),
         "argument_bytes": i.get("argument_bytes")}
        for i in top
    ]
    doc["reconciliation"] = reconcile(
        estimates=[i.get("peak_bytes") for i in (insights or [])])
    doc["hints"] = _remediation_hints(doc.get("footprint"), live)
    return doc


_POSTMORTEM_SEQ = 0


def dump_postmortem(doc: Dict[str, Any],
                    dir: Optional[str] = None) -> Optional[str]:
    """Write the post-mortem next to the program dumps
    (PADDLE_TPU_XLA_DUMP_DIR), falling back to the memwatch journal dir.
    Returns the path, or None when nowhere to put it — the typed error
    still carries the report in-process either way."""
    global _POSTMORTEM_SEQ
    base = (dir or _flags.env_flag("PADDLE_TPU_XLA_DUMP_DIR")
            or _JOURNAL_DIR
            or _flags.env_flag("PADDLE_TPU_MEMWATCH_DIR") or None)
    if not base:
        return None
    _POSTMORTEM_SEQ += 1
    path = os.path.join(
        base, f"oom_postmortem.rank{doc.get('rank', 0)}."
              f"{_POSTMORTEM_SEQ}.json")
    try:
        return _monitor.atomic_write_text(path, json.dumps(doc, indent=1))
    except OSError:
        return None


def oom_error(exc: BaseException, program=None, scope=None,
              insights: Optional[List[dict]] = None):
    """A device allocation failure -> the typed errors.ResourceExhausted
    the executor raises: op provenance (the op that raised, else the
    blame heuristic) attached, the full
    memory report on ``.memory_report``, the dump path on
    ``.postmortem_path``, and a headline message naming the peak, the
    blamed op and the first hint."""
    from .framework import errors as _errs

    raised = _raising_op(exc, program) if program is not None else None
    blame = raised or (_blame_op(program) if program is not None else None)
    report = build_postmortem(exc, program=program, scope=scope,
                              insights=insights, blame=blame)
    path = dump_postmortem(report)
    report["postmortem_path"] = path
    peak = report["ledger"].get("lifetime_peak_bytes", 0)
    parts = [f"device out of memory (measured peak "
             f"{peak / 1e6:.1f}MB"]
    limit = report["live"].get("bytes_limit")
    if limit:
        parts[0] += f" of {limit / 1e6:.1f}MB"
    parts[0] += ")"
    if blame is not None:
        nbytes, op, idx = blame
        what = "raised in" if raised else "largest static output:"
        parts.append(f"{what} op #{idx} {op.type!r} "
                     f"(outputs ~{nbytes / 1e6:.1f}MB)")
    if report["hints"]:
        parts.append(f"hint: {report['hints'][0]}")
    if path:
        parts.append(f"post-mortem: {path}")
    err = _errs.errors.ResourceExhausted("; ".join(parts))
    err.memory_report = report
    err.postmortem_path = path
    if blame is not None:
        _, op, idx = blame
        err = _errs.attach_op_provenance(err, op, op_idx=idx)
    err.__cause__ = exc
    _monitor.flight_record(
        "memwatch", "oom", peak_bytes=peak,
        blame=blame[1].type if blame is not None else None)
    return err


# env-driven wiring: under a launcher (or a user export) every rank
# persists its memory ledger with no code change
_env_dir = _flags.env_flag("PADDLE_TPU_MEMWATCH_DIR")
if _env_dir:
    try:
        os.makedirs(_env_dir, exist_ok=True)
        configure(dir=_env_dir)
    except OSError:
        pass  # unwritable dir: accounting stays in-process only
