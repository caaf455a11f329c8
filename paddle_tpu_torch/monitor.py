"""Runtime telemetry: typed metrics registry + legacy stat gauges.

Port of ``paddle_tpu/monitor.py`` (no device code). A rank change
re-anchors the rank-keyed journals of goodput, memwatch and dynamics,
as there; the interconnect ledger (commswatch) waits for ROADMAP A12.

Counterpart of Paddle's paddle/fluid/platform/monitor.h:76
(StatRegistry + STAT_ADD/STAT_RESET macros, used for GPU memory gauges),
grown into the framework's observability spine: Counter / Gauge /
Histogram metric families with labels, thread-safe, near-zero cost when
disabled, exported as Prometheus text or a JSON snapshot. In this
package the serving engine and its ledger report here.

Env knobs (declared in paddle_tpu_torch/flags.py):
  PADDLE_TPU_METRICS=0        disable all recording (inc/set/observe
                              become a single bool check)
  PADDLE_TPU_TRACE_DIR=d      enable the flight recorder; dumps land in d
  PADDLE_TPU_WATCHDOG_SECS=n  start the hang watchdog: no step progress
                              for n seconds -> flight-recorder dump
  PADDLE_TPU_FLIGHT_CAPACITY  ring-buffer size (default 512 events)

The legacy ``stat_add/stat_set/stat_get/stat_reset/stats`` gauge dict is
kept verbatim (reference STAT_* macro parity); its values ride along in
both exporters.

Flight recorder (the "what was each rank doing" half of hang diagnosis,
grown from the reference heart_beat_monitor.h liveness-only design): a
bounded ring buffer of recent span/metric/progress events per process,
dumped together with all-thread stacks to PADDLE_TPU_TRACE_DIR on
SIGTERM/SIGUSR1 or when the watchdog sees no step progress for N
seconds. distributed/launch.py collects the dumps when it reaps a
dead or stale rank.
"""
from __future__ import annotations

import bisect
import collections
import itertools
import json
import os
import re
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import flags as _flags

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_registry", "counter", "gauge", "histogram",
    "enabled", "enable", "snapshot", "to_prometheus", "write_snapshot",
    "reset_metrics",
    "stat_add", "stat_set", "stat_get", "stat_reset", "stats",
    "trainer_rank", "set_trainer_rank", "atomic_write_text",
    "FlightRecorder", "enable_flight_recorder", "flight_recorder",
    "flight_record", "note_progress", "progress_count",
    "dump_flight_record", "install_dump_handlers",
    "start_watchdog", "stop_watchdog",
]

# ---------------------------------------------------------------------------
# enable switch (module-level bool: the whole disabled-mode cost)
# ---------------------------------------------------------------------------

# declared in flags.py (the PADDLE_TPU_* env registry); read once at import
_ENABLED = bool(_flags.env_flag("PADDLE_TPU_METRICS"))


def enabled() -> bool:
    return _ENABLED


def enable(flag: bool = True) -> None:
    global _ENABLED
    _ENABLED = bool(flag)


# ---------------------------------------------------------------------------
# metric families
# ---------------------------------------------------------------------------

# latency-oriented default buckets (seconds), bounded at 18 + overflow
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
)

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _sanitize(name: str) -> str:
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    return out if _NAME_RE.match(out) else "_" + out


class _Metric:
    """Family base: owns the label-keyed children and the family lock."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        from .framework import errors as _errors

        if not _NAME_RE.match(name):
            raise _errors.errors.InvalidArgument(
                f"metric name {name!r} is not a valid identifier")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        self._nolabel = None  # cached () child: the unlabeled fast path

    def labels(self, *values, **kv):
        """Child for one label-value combination (prometheus_client idiom:
        ``m.labels(method="pull").inc()``). Children are cached — hold the
        returned handle on hot paths to skip the lookup entirely."""
        if kv:
            try:
                values = tuple(str(kv[n]) for n in self.labelnames)
            except KeyError as e:
                from .framework import errors as _errors

                raise _errors.errors.InvalidArgument(
                    f"metric {self.name!r} labels {self.labelnames} "
                    f"got {sorted(kv)}") from e
        else:
            values = tuple(str(v) for v in values)
        # lock-free hit path (GIL-atomic dict read); lock only to create
        child = self._children.get(values)
        if child is not None:
            return child
        if len(values) != len(self.labelnames):
            from .framework import errors as _errors

            raise _errors.errors.InvalidArgument(
                f"metric {self.name!r} expects {len(self.labelnames)} "
                f"label values, got {len(values)}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = self._new_child(values)
            return child

    def _unlabeled(self):
        child = self._nolabel
        if child is None:
            child = self._nolabel = self.labels()
        return child

    def _new_child(self, values):
        raise NotImplementedError

    def _series(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return list(self._children.items())

    def _reset(self) -> None:
        # zero in place instead of dropping children: handles cached by
        # instrumentation sites stay live across reset_metrics()
        with self._lock:
            for child in self._children.values():
                child._zero()


class _ValueChild:
    __slots__ = ("_lock", "value")

    def __init__(self, lock):
        self._lock = lock
        self.value = 0.0

    def _zero(self):
        self.value = 0.0


class _CounterChild(_ValueChild):
    def inc(self, value: float = 1.0) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self.value += value


class Counter(_Metric):
    """Monotonically increasing count (requests, bytes, cache hits)."""

    kind = "counter"

    def _new_child(self, values):
        return _CounterChild(self._lock)

    def inc(self, value: float = 1.0) -> None:
        if not _ENABLED:
            return
        self._unlabeled().inc(value)

    @property
    def value(self) -> float:
        return self._unlabeled().value


class _GaugeChild(_ValueChild):
    def set(self, value: float) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self.value = float(value)

    def inc(self, value: float = 1.0) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self.value += value

    def dec(self, value: float = 1.0) -> None:
        self.inc(-value)


class Gauge(_Metric):
    """Point-in-time level (queue depth, cache size, throughput)."""

    kind = "gauge"

    def _new_child(self, values):
        return _GaugeChild(self._lock)

    def set(self, value: float) -> None:
        if not _ENABLED:
            return
        self._unlabeled().set(value)

    def inc(self, value: float = 1.0) -> None:
        if not _ENABLED:
            return
        self._unlabeled().inc(value)

    def dec(self, value: float = 1.0) -> None:
        self.inc(-value)

    @property
    def value(self) -> float:
        return self._unlabeled().value


class _HistogramChild:
    __slots__ = ("_lock", "_bounds", "counts", "sum", "count")

    def __init__(self, lock, bounds):
        self._lock = lock
        self._bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # +1: +Inf overflow
        self.sum = 0.0
        self.count = 0

    def _zero(self):
        self.counts = [0] * len(self.counts)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        if not _ENABLED:
            return
        i = bisect.bisect_left(self._bounds, value)
        with self._lock:
            self.counts[i] += 1
            self.sum += value
            self.count += 1


class Histogram(_Metric):
    """Bounded-bucket distribution (latencies). Cumulative on export, raw
    per-bucket counts internally (one bisect + int increment per observe)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(name, help, labelnames)
        bs = tuple(sorted(buckets)) if buckets else DEFAULT_BUCKETS
        from .framework import errors as _errors

        if not bs:
            raise _errors.errors.InvalidArgument(
                f"histogram {name!r} needs at least one bucket bound")
        self.buckets = bs

    def _new_child(self, values):
        return _HistogramChild(self._lock, self.buckets)

    def observe(self, value: float) -> None:
        if not _ENABLED:
            return
        self._unlabeled().observe(value)

    def time(self):
        """Context manager observing the elapsed seconds of the block."""
        return _Timer(self)


class _Timer:
    __slots__ = ("_sink", "_t0")

    def __init__(self, sink):
        self._sink = sink

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sink.observe(time.perf_counter() - self._t0)
        return False


# ---------------------------------------------------------------------------
# registry + exporters
# ---------------------------------------------------------------------------


class MetricsRegistry:
    """Named metric families; get-or-create with type/label checking."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw) -> _Metric:
        from .framework import errors as _errors

        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(
                    name, help=help, labelnames=labelnames, **kw)
            elif not isinstance(m, cls) or m.labelnames != tuple(labelnames):
                raise _errors.errors.AlreadyExists(
                    f"metric {name!r} already registered as {m.kind} "
                    f"with labels {m.labelnames}")
            elif (kw.get("buckets") is not None
                    and tuple(sorted(kw["buckets"])) != m.buckets):
                raise _errors.errors.AlreadyExists(
                    f"histogram {name!r} already registered with buckets "
                    f"{m.buckets}")
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def reset(self) -> None:
        """Drop every recorded series (families stay registered)."""
        with self._lock:
            families = list(self._metrics.values())
        for m in families:
            m._reset()

    # -- exporters ------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able view: every family with its per-label-set series,
        plus the legacy stat gauges."""
        out: Dict[str, dict] = {}
        with self._lock:
            families = list(self._metrics.values())
        for m in families:
            series = []
            for values, child in m._series():
                labels = dict(zip(m.labelnames, values))
                if m.kind == "histogram":
                    series.append({
                        "labels": labels,
                        "buckets": list(m.buckets),
                        "counts": list(child.counts),
                        "sum": child.sum,
                        "count": child.count,
                    })
                else:
                    series.append({"labels": labels, "value": child.value})
            out[m.name] = {
                "type": m.kind,
                "help": m.help,
                "series": series,
            }
        return {
            "schema": "paddle_tpu.metrics/1",
            "time_unix": time.time(),
            "metrics": out,
            "stats": stats(),
        }

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (# HELP / # TYPE + samples);
        histograms expand to cumulative _bucket/_sum/_count samples."""
        lines: List[str] = []

        def esc(v: str) -> str:
            return (str(v).replace("\\", "\\\\").replace('"', '\\"')
                    .replace("\n", "\\n"))

        def fmt_labels(labels: Dict[str, str], extra: str = "") -> str:
            items = [f'{k}="{esc(v)}"' for k, v in labels.items()]
            if extra:
                items.append(extra)
            return "{" + ",".join(items) + "}" if items else ""

        with self._lock:
            families = list(self._metrics.values())
        for m in families:
            if m.help:
                help_text = m.help.replace("\\", "\\\\").replace("\n", "\\n")
                lines.append(f"# HELP {m.name} {help_text}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for values, child in m._series():
                labels = dict(zip(m.labelnames, values))
                if m.kind == "histogram":
                    cum = 0
                    for bound, c in zip(m.buckets, child.counts):
                        cum += c
                        le = 'le="%s"' % bound
                        lines.append(
                            f"{m.name}_bucket{fmt_labels(labels, le)} {cum}")
                    cum += child.counts[-1]
                    le_inf = 'le="+Inf"'
                    lines.append(
                        f"{m.name}_bucket{fmt_labels(labels, le_inf)} {cum}")
                    lines.append(
                        f"{m.name}_sum{fmt_labels(labels)} {child.sum}")
                    lines.append(
                        f"{m.name}_count{fmt_labels(labels)} {child.count}")
                else:
                    lines.append(
                        f"{m.name}{fmt_labels(labels)} {child.value}")
        for name, value in sorted(stats().items()):
            sname = _sanitize(name)
            lines.append(f"# TYPE {sname} gauge")
            lines.append(f"{sname} {value}")
        return "\n".join(lines) + "\n"


_default_registry = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _default_registry


def counter(name: str, help: str = "",
            labelnames: Sequence[str] = ()) -> Counter:
    return _default_registry.counter(name, help, labelnames)


def gauge(name: str, help: str = "",
          labelnames: Sequence[str] = ()) -> Gauge:
    return _default_registry.gauge(name, help, labelnames)


def histogram(name: str, help: str = "", labelnames: Sequence[str] = (),
              buckets: Optional[Sequence[float]] = None) -> Histogram:
    return _default_registry.histogram(name, help, labelnames, buckets)


def snapshot() -> dict:
    return _default_registry.snapshot()


def to_prometheus() -> str:
    return _default_registry.to_prometheus()


def reset_metrics() -> None:
    _default_registry.reset()


def atomic_write(path: str, data) -> str:
    """Write str or bytes to `path` via a same-directory temp file +
    os.replace, so a concurrent reader (the status server, an external
    scraper, a tool tailing the file) can never observe a torn write.
    The ONE atomicity implementation — journals, snapshots and training
    checkpoints all route through it. Chaos site: an armed io_stall
    sleeps here — the wedged-disk shape every flush must survive."""
    try:  # lazy: chaos imports monitor for its counters
        from . import chaos as _chaos

        _chaos.io_stall(path)
    except ImportError:
        pass
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb" if isinstance(data, bytes) else "w") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def atomic_write_text(path: str, text: str) -> str:
    return atomic_write(path, text)


def write_snapshot(path: str, fmt: str = "json") -> str:
    """Dump the default registry to `path` as JSON ('json') or Prometheus
    text ('prom'); returns the path. Atomic (temp + rename): external
    scrapers never see a half-written snapshot."""
    text = (to_prometheus() if fmt == "prom"
            else json.dumps(snapshot(), indent=1))
    return atomic_write_text(path, text)


# ---------------------------------------------------------------------------
# legacy stat gauges (reference STAT_ADD/STAT_RESET macro parity)
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_STATS: Dict[str, float] = {}


def stat_add(name: str, value: float = 1.0) -> None:
    if not _ENABLED:
        return
    with _LOCK:
        _STATS[name] = _STATS.get(name, 0.0) + value


def stat_set(name: str, value: float) -> None:
    if not _ENABLED:
        return
    with _LOCK:
        _STATS[name] = float(value)


def stat_get(name: str) -> float:
    with _LOCK:
        return _STATS.get(name, 0.0)


def stat_reset(name: str = None) -> None:
    with _LOCK:
        if name is None:
            _STATS.clear()
        else:
            _STATS.pop(name, None)


def stats() -> Dict[str, float]:
    with _LOCK:
        return dict(_STATS)


# ---------------------------------------------------------------------------
# flight recorder + hang watchdog
# ---------------------------------------------------------------------------


class FlightRecorder:
    """Bounded ring buffer of recent runtime events (span ends, progress
    marks, metric notes). Cheap enough to stay on during production runs;
    its whole value is the dump taken at the moment a rank dies or hangs."""

    def __init__(self, capacity: int = 512):
        self._lock = threading.Lock()
        self._events: "collections.deque" = collections.deque(maxlen=capacity)

    def record(self, kind: str, name: str, **fields) -> None:
        event = {"t": time.time(), "kind": kind, "name": name}
        if fields:
            event.update(fields)
        with self._lock:
            self._events.append(event)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()


_FLIGHT: Optional[FlightRecorder] = None
_FLIGHT_DIR: Optional[str] = None
_DUMP_SEQ = itertools.count(1)
_PROGRESS = 0
_WATCHDOG: Optional["_Watchdog"] = None


def enable_flight_recorder(capacity: Optional[int] = None,
                           dir: Optional[str] = None) -> FlightRecorder:
    global _FLIGHT, _FLIGHT_DIR
    if _FLIGHT is None:
        cap = capacity or int(_flags.env_flag("PADDLE_TPU_FLIGHT_CAPACITY"))
        _FLIGHT = FlightRecorder(cap)
    elif capacity and capacity != _FLIGHT._events.maxlen:
        # resize in place, keeping recent history: the recorder may have
        # been auto-created at import (env wiring) with the default size
        with _FLIGHT._lock:
            _FLIGHT._events = collections.deque(
                _FLIGHT._events, maxlen=capacity)
    if dir:
        _FLIGHT_DIR = dir
    return _FLIGHT


def flight_recorder() -> Optional[FlightRecorder]:
    return _FLIGHT


def flight_record(kind: str, name: str, **fields) -> None:
    """Record into the flight ring iff enabled — a single None check on
    the hot path (the profiler feeds every finished span through here)."""
    fr = _FLIGHT
    if fr is not None:
        fr.record(kind, name, **fields)


def note_progress(step: Optional[int] = None) -> None:
    """Bump the per-process step-progress counter the watchdog monitors.
    Called by Executor.run and the hapi fit loop once per step."""
    global _PROGRESS
    _PROGRESS += 1
    fr = _FLIGHT
    if fr is not None:
        fr.record("progress", "step", step=step)


def progress_count() -> int:
    return _PROGRESS


_RANK_OVERRIDE: Optional[int] = None


def set_trainer_rank(rank: int) -> None:
    """Override the env-derived rank (profiler.set_rank forwards here,
    so traces, journals, flight dumps and the status endpoints all agree
    on one identity)."""
    global _RANK_OVERRIDE
    changed = _RANK_OVERRIDE != int(rank)
    _RANK_OVERRIDE = int(rank)
    if changed:
        try:  # the goodput journal is rank-keyed: re-anchor its resume
            from . import goodput as _goodput

            _goodput._rank_changed()
        except Exception:
            pass
        try:  # the memwatch journal shares the rank-keyed contract
            from . import memwatch as _memwatch

            _memwatch._rank_changed()
        except Exception:
            pass
        try:  # so does the training-dynamics journal
            from . import dynamics as _dynamics

            _dynamics._rank_changed()
        except Exception:
            pass


def trainer_rank() -> int:
    """This process's trainer rank (launch.py PADDLE_* env protocol; 0
    standalone) — the one shared resolver for journal filenames, flight
    dumps and the status endpoints."""
    if _RANK_OVERRIDE is not None:
        return _RANK_OVERRIDE
    return int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0)


def _thread_stacks() -> Dict[str, List[str]]:
    """Formatted stacks of every live thread (sys._current_frames): the
    'where is each thread stuck' half of a hang dump."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: Dict[str, List[str]] = {}
    for tid, frame in sys._current_frames().items():
        key = f"{names.get(tid, 'thread')}-{tid}"
        out[key] = [ln.rstrip("\n") for ln in traceback.format_stack(frame)]
    return out


def dump_flight_record(reason: str = "", path: Optional[str] = None,
                       dir: Optional[str] = None) -> str:
    """Write {reason, rank, last-N events, all-thread stacks} as JSON.
    Default location: PADDLE_TPU_TRACE_DIR/flight.rank<k>.pid<p>.<n>.json
    (sequence-numbered: one process may dump more than once)."""
    doc = {
        "schema": "paddle_tpu.flight/1",
        "reason": reason,
        "time_unix": time.time(),
        "rank": trainer_rank(),
        "pid": os.getpid(),
        "progress": _PROGRESS,
        "events": _FLIGHT.events() if _FLIGHT is not None else [],
        "stacks": _thread_stacks(),
    }
    if path is None:
        base = (dir or _FLIGHT_DIR
                or _flags.env_flag("PADDLE_TPU_TRACE_DIR") or ".")
        path = os.path.join(
            base,
            f"flight.rank{doc['rank']}.pid{doc['pid']}.{next(_DUMP_SEQ)}.json")
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return path


def install_dump_handlers(signums: Optional[Sequence[int]] = None) -> List[int]:
    """Install signal handlers that dump the flight record. SIGUSR1 dumps
    and continues (poke a live-but-suspect rank); SIGTERM dumps and then
    re-delivers to the previous handler/default so the process still
    dies. Main-thread only (signal module restriction)."""
    import signal as _signal

    if signums is None:
        signums = [_signal.SIGTERM]
        if hasattr(_signal, "SIGUSR1"):
            signums.append(_signal.SIGUSR1)
    prev: Dict[int, object] = {}

    def _handler(signum, frame):
        try:
            dump_flight_record(reason=f"signal {signum}")
        except Exception:
            pass  # never mask the shutdown path with a dump failure
        try:
            # flush the span trace too: SIGTERM's default disposition
            # skips atexit, and the launcher-terminated rank is exactly
            # the one whose timeline the merge needs
            from . import profiler as _profiler

            _profiler.flush_trace()
        except Exception:
            pass
        if signum == _signal.SIGTERM:
            p = prev.get(signum)
            if callable(p):
                p(signum, frame)
            else:
                _signal.signal(signum, _signal.SIG_DFL)
                os.kill(os.getpid(), signum)

    installed = []
    for s in signums:
        prev[s] = _signal.signal(s, _handler)
        installed.append(int(s))
    return installed


class _Watchdog(threading.Thread):
    """Dumps the flight record when the watched progress value stalls for
    `stall_seconds`. One dump per stall episode: a new dump needs progress
    to resume and stall again first. Arms only once steps have actually
    happened (initial progress nonzero, or the first observed tick) — a
    process that never trains (pserver, a tool importing the package)
    must not be reported as hung."""

    def __init__(self, stall_seconds: float, interval: float,
                 progress_fn: Callable[[], float],
                 dir: Optional[str] = None):
        super().__init__(name="paddle-tpu-watchdog", daemon=True)
        self.stall_seconds = float(stall_seconds)
        self.interval = float(interval)
        self._progress_fn = progress_fn
        self._dir = dir
        self._stop_ev = threading.Event()
        self.dumps: List[str] = []

    def run(self):
        last_val = self._progress_fn()
        last_t = time.monotonic()
        armed = bool(last_val)
        dumped = False
        while not self._stop_ev.wait(self.interval):
            cur = self._progress_fn()
            now = time.monotonic()
            if cur != last_val:
                last_val, last_t, dumped = cur, now, False
                armed = True
            elif armed and not dumped and now - last_t >= self.stall_seconds:
                try:
                    self.dumps.append(dump_flight_record(
                        reason=(f"watchdog: no step progress for "
                                f"{now - last_t:.1f}s"),
                        dir=self._dir))
                except Exception:
                    pass
                dumped = True

    def stop(self):
        self._stop_ev.set()


def start_watchdog(stall_seconds: Optional[float] = None,
                   interval: Optional[float] = None,
                   progress_fn: Optional[Callable[[], float]] = None,
                   dir: Optional[str] = None) -> _Watchdog:
    """Start the hang watchdog. Defaults: stall from
    PADDLE_TPU_WATCHDOG_SECS (120), progress = the counter
    note_progress() bumps. A no-arg call returns any already-running
    watchdog (idempotent); explicit arguments replace it — the env
    auto-start must not silently swallow a caller's configuration."""
    global _WATCHDOG
    if _WATCHDOG is not None and _WATCHDOG.is_alive():
        if (stall_seconds is None and interval is None
                and progress_fn is None and dir is None):
            return _WATCHDOG
        stop_watchdog()
    stall = float(stall_seconds if stall_seconds is not None
                  else _flags.env_flag("PADDLE_TPU_WATCHDOG_SECS") or 120)
    enable_flight_recorder(dir=dir)
    wd = _Watchdog(
        stall,
        interval if interval is not None else max(0.05, min(1.0, stall / 4)),
        progress_fn or progress_count,
        dir=dir,
    )
    wd.start()
    _WATCHDOG = wd
    return wd


def stop_watchdog() -> None:
    global _WATCHDOG
    if _WATCHDOG is not None:
        _WATCHDOG.stop()
        _WATCHDOG = None


# env-driven wiring: launch.py exports PADDLE_TPU_TRACE_DIR (and the
# watchdog knob rides along in the inherited environment), so every
# spawned rank records flights + answers dump signals with no code change
_env_trace_dir = _flags.env_flag("PADDLE_TPU_TRACE_DIR")
if _env_trace_dir:
    enable_flight_recorder(dir=_env_trace_dir)
    try:
        install_dump_handlers()
    except (ValueError, OSError):
        pass  # non-main thread / restricted env: dumps stay on-demand
if float(_flags.env_flag("PADDLE_TPU_WATCHDOG_SECS")) > 0:
    start_watchdog()
