"""Serving goodput ledger: where does each serving second actually go.

Port of ``paddle_tpu/serving/ledger.py``; it holds no device code, so
only its imports changed, and :func:`status` also carries the installed
roofline and its reconciliation. The journal schema is the JAX
package's, so tools that read one package's journals read the other's.

The serving-plane counterpart of ``paddle_tpu/goodput.py``: the engine
(``serving/engine.py``) attributes every closed scheduler tick's wall
clock into typed buckets, and the cumulative ledger answers the two
operator questions the training ledger answers for fit loops — "how much
of the wall was productive device compute" and "what is the top badput
offender" — plus the SLO telemetry serving adds on top (tokens/s, TTFT
and per-request latency histograms, batch occupancy, KV-block
utilization).

Buckets (the at-scale serving loss modes the Gemma-on-Cloud-TPU
comparison attributes wins to — batch occupancy and prefill/decode
scheduling visibility):

  prefill_compute  prompt-processing program windows (one-shot predictor
                   executes charge here too: they ARE the prompt pass)
  decode_compute   continuous-batching decode tick program windows
  queue_wait       engine wall with requests queued but nothing runnable
                   (admission blocked on slots/KV with an empty batch)
  batch_gap        host gap between device dispatches while the batch
                   held active requests (scheduling/bookkeeping overhead
                   the device pays for)
  host_other       unattributed remainder of ticks with no runnable or
                   queued work

Tick accounting is two-phase like goodput's: the engine ``add()``s into
the OPEN tick, then ``end_tick(wall)`` assigns the remainder by state
(active batch -> batch_gap, queued-only -> queue_wait, else host_other)
and folds into the cumulative ledger — so a closed tick's buckets sum to
its wall clock by construction, and the SERVE bench's "buckets sum to
wall" assertion is a tautology the plumbing must keep true.

The ledger persists via a per-rank journal
(``PADDLE_TPU_SERVE_DIR/serving.rank<k>.json``, atomic write-then-
rename): a restarted replica resumes its cumulative totals, and
``load_journals()`` merges per-replica files into the job view
``distributed/launch.py --serve`` prints at teardown and
``tools/obs_report.py --serve`` renders. Latency/TTFT distributions are
kept as fixed-bound histograms so cross-replica merges stay exact.

Two reconciliations ride the ledger (the ``memwatch.reconcile`` /
``shard_insight.reconcile`` idiom — explicit bound factors, verdict
taxonomy, never a silent pass):

- :func:`reconcile_spans` — summed per-request decode span seconds vs
  the engine's decode slot-seconds (decode bucket x occupancy); the two
  sides come from independent plumbing (per-request records vs per-tick
  attribution), so a dropped span or a double-counted tick trips it;
- :func:`reconcile_roofline` — measured decode tokens/s vs the AOT
  cost-analysis roofline prediction of the decode program (compute /
  memory / dispatch bound factors stated per leg).
"""
from __future__ import annotations

import atexit
import glob
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from .. import flags as _flags
from .. import monitor as _monitor

__all__ = [
    "BUCKETS", "PRODUCTIVE_BUCKETS", "ATTRIBUTION_BUCKETS",
    "ServingLedger", "ledger", "reset",
    "add", "mark", "add_slot_seconds", "end_tick", "record_request",
    "record_attribution", "attribution_summary", "reconcile_attribution",
    "totals", "summary",
    "slo_summary", "status", "configure", "disable_persistence", "flush",
    "journal_path", "load_journal", "load_journals", "merge_ledgers",
    "top_badput", "render_summary", "hist_quantile", "new_hist",
    "hist_observe", "merge_hist", "reconcile_spans", "reconcile_roofline",
    "set_roofline",
]

SCHEMA = "paddle_tpu.serving/1"

BUCKETS = ("prefill_compute", "decode_compute", "queue_wait", "batch_gap",
           "host_other")
PRODUCTIVE_BUCKETS = ("prefill_compute", "decode_compute")

# per-request latency-attribution buckets: every closed request's e2e
# wall decomposes into these, summing to the measured total by
# construction (the router assembles the first three around the winning
# attempt; the engine reports the rest from its lifecycle timestamps).
# An engine-side record (no router in front) carries only the engine
# buckets — the router-side ones are simply absent, not zero-padded.
ATTRIBUTION_BUCKETS = (
    "router_queue",      # dispatch overhead outside backoff + attempts
    "backoff_wait",      # measured retry backoff sleeps
    "transport",         # serial attempt wall not accounted by the
                         # winner's engine-side e2e (wire + dead peers)
    "admission_queue",   # submit -> admitted into a decode slot
    "batch_wait",        # admitted but not inside a compute window
    "prefill_compute",   # prompt pass program window(s)
    "decode_compute",    # summed per-tick decode windows
    "postprocess",       # last compute window end -> retired
)

# residual = |sum(buckets) - e2e| / e2e is a small fraction; the latency
# bounds are wrong for it — fixed fraction bounds keep merges exact
RESIDUAL_BOUNDS = (0.0001, 0.0002, 0.0005, 0.001, 0.002, 0.005, 0.01,
                   0.02, 0.05, 0.1, 0.2, 0.5, 1.0)

# per-class raw-record retention: the slowest request per class is kept
# whole (the "top-latency offender" obs_report renders); a short recent
# tail rides along for spot debugging without bloating the journal
_ATTR_TAIL = 32

_EMA_ALPHA = 0.1

# fixed log-spaced bounds so per-replica histograms merge exactly across
# restarts and ranks (1ms .. 120s covers CPU-sim ticks through pod SLOs)
LATENCY_BOUNDS = tuple(
    round(0.001 * (2.0 ** (i / 2.0)), 6) for i in range(34))

# serving rides the metrics registry too: the Prometheus endpoint and
# the obs_report snapshot both carry the SLO series
_M_BUCKET_S = _monitor.counter(
    "serve_bucket_seconds_total",
    "cumulative attributed serving tick seconds by bucket", ("bucket",))
_M_REQUESTS = _monitor.counter(
    "serve_requests_total", "serving requests by outcome", ("outcome",))
_M_TOKENS = _monitor.counter(
    "serve_tokens_total", "serving tokens by kind (prompt/decode)",
    ("kind",))
_M_TTFT = _monitor.histogram(
    "serve_ttft_seconds", "time to first token (admit -> first decode)",
    buckets=LATENCY_BOUNDS)
_M_LATENCY = _monitor.histogram(
    "serve_request_latency_seconds",
    "whole-request latency (submit -> done)", buckets=LATENCY_BOUNDS)
_M_OCCUPANCY = _monitor.gauge(
    "serve_batch_occupancy",
    "active decode slots / max batch of the last closed tick")
_M_KV_UTIL = _monitor.gauge(
    "serve_kv_block_utilization",
    "allocated KV blocks / allocatable blocks of the last closed tick")
_M_QUEUE = _monitor.gauge(
    "serve_queue_depth", "requests waiting in the admission queue")
_M_TPS = _monitor.gauge(
    "serve_tokens_per_sec", "decode tokens/s EMA over closed ticks")


# ---------------------------------------------------------------------------
# mergeable fixed-bound histograms (journal-resident latency/TTFT)
# ---------------------------------------------------------------------------


def new_hist(bounds: Optional[Sequence[float]] = None) -> Dict[str, Any]:
    bounds = list(LATENCY_BOUNDS if bounds is None else bounds)
    return {"bounds": bounds,
            "counts": [0] * (len(bounds) + 1),
            "sum": 0.0, "count": 0}


def hist_observe(hist: Dict[str, Any], value: float) -> None:
    import bisect

    i = bisect.bisect_left(hist["bounds"], value)
    hist["counts"][i] += 1
    hist["sum"] += float(value)
    hist["count"] += 1


def merge_hist(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    """Exact merge of two fixed-bound histograms (same bounds)."""
    bounds = (a or {}).get("bounds") or (b or {}).get("bounds")
    out = new_hist(bounds)
    for h in (a, b):
        if not h:
            continue
        counts = list(h.get("counts", []))
        counts += [0] * (len(out["counts"]) - len(counts))
        out["counts"] = [x + y for x, y in zip(out["counts"], counts)]
        out["sum"] += float(h.get("sum", 0.0))
        out["count"] += int(h.get("count", 0))
    return out


def hist_quantile(hist: Optional[Dict[str, Any]],
                  q: float) -> Optional[float]:
    """Linear interpolation inside the winning bucket (the Prometheus
    histogram_quantile estimator, same math obs_report uses)."""
    if not hist or not hist.get("count"):
        return None
    bounds, counts = hist["bounds"], hist["counts"]
    total = sum(counts)
    rank = q * total
    cum = 0
    lo = 0.0
    for bound, c in zip(bounds, counts):
        if cum + c >= rank:
            frac = (rank - cum) / c if c else 0.0
            return lo + (bound - lo) * frac
        cum += c
        lo = bound
    return bounds[-1]


def _hist_summary(hist: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    if not hist or not hist.get("count"):
        return {"count": 0, "avg": None, "p50": None, "p99": None}
    return {
        "count": int(hist["count"]),
        "avg": round(hist["sum"] / hist["count"], 6),
        "p50": hist_quantile(hist, 0.50),
        "p99": hist_quantile(hist, 0.99),
    }


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------


def _zero_buckets() -> Dict[str, float]:
    return {b: 0.0 for b in BUCKETS}


def _new_attribution() -> Dict[str, Any]:
    """Empty per-request attribution aggregate: per-traffic-class bucket
    histograms + e2e/residual histograms + the slowest raw record."""
    return {"n_requests": 0, "classes": {}}


def _new_attr_class() -> Dict[str, Any]:
    return {
        "n": 0,
        "buckets": {},  # bucket name -> latency hist (materialized lazily)
        "e2e": new_hist(),
        "residual": new_hist(RESIDUAL_BOUNDS),
        "slowest": None,    # raw record of the max-e2e request
        "recent": [],       # bounded tail of raw records
    }


def merge_attribution(a: Optional[Dict[str, Any]],
                      b: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Exact merge of two attribution aggregates (journal resume and the
    cross-replica/router merge): histograms add, the slowest record wins
    by e2e, recents concat newest-first and truncate."""
    out = _new_attribution()
    for doc in (a, b):
        if not doc:
            continue
        out["n_requests"] += int(doc.get("n_requests", 0))
        for klass, cls in (doc.get("classes") or {}).items():
            dst = out["classes"].setdefault(klass, _new_attr_class())
            dst["n"] += int(cls.get("n", 0))
            for bucket, h in (cls.get("buckets") or {}).items():
                dst["buckets"][bucket] = merge_hist(
                    dst["buckets"].get(bucket) or {}, h)
            dst["e2e"] = merge_hist(dst["e2e"], cls.get("e2e") or {})
            dst["residual"] = merge_hist(dst["residual"],
                                         cls.get("residual") or {})
            cand = cls.get("slowest")
            if cand and (dst["slowest"] is None
                         or float(cand.get("e2e_s", 0.0))
                         > float(dst["slowest"].get("e2e_s", 0.0))):
                dst["slowest"] = dict(cand)
            dst["recent"] = sorted(
                dst["recent"] + list(cls.get("recent") or []),
                key=lambda r: -float(r.get("time_unix") or 0.0)
            )[:_ATTR_TAIL]
    return out


def _elastic_attempt() -> int:
    """This replica's elastic incarnation — journal provenance for the
    merge's stale-attempt reasoning (THE one definition lives with the
    chaos attempt-guard)."""
    from .. import chaos as _chaos

    return _chaos.elastic_attempt()


def _invalid(msg: str):
    from ..framework import errors as _errors

    return _errors.errors.InvalidArgument(msg)


def _finalize(doc: Dict[str, Any], buckets: Dict[str, float],
              wall: float) -> Dict[str, Any]:
    """Attach the derived fields — the ONE place the serving goodput
    fraction is defined (productive = prefill + decode compute)."""
    productive = sum(buckets[b] for b in PRODUCTIVE_BUCKETS)
    denom = wall if wall > 0 else sum(buckets.values())
    doc.update({
        "buckets": buckets,
        "productive_seconds": productive,
        "badput_seconds": max(0.0, denom - productive),
        "goodput_fraction": (productive / denom) if denom > 0 else None,
    })
    return doc


class ServingLedger:
    """Cumulative serving-plane attribution for one replica process.

    Thread-safe; the engine ``add()``s into the open tick and closes it
    with ``end_tick``; ``record_request`` folds one finished request's
    SLO numbers. ``base`` holds totals resumed from a prior
    incarnation's journal."""

    def __init__(self):
        self._lock = threading.RLock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.buckets = _zero_buckets()
            self.open = _zero_buckets()
            self.ticks = 0
            self.wall_seconds = 0.0
            self.decode_tokens = 0
            self.prompt_tokens = 0
            self.requests = {"ok": 0, "failed": 0, "evicted": 0}
            self.ttft_hist = new_hist()
            self.latency_hist = new_hist()
            # occupancy / KV utilization, wall-weighted over closed ticks
            self.occupancy_weight = 0.0
            self.kv_util_weight = 0.0
            self.weighted_wall = 0.0
            # the span-reconciliation sides (independent plumbing):
            # per-request decode span seconds vs per-tick slot-seconds
            self.request_span_seconds = 0.0
            self.decode_slot_seconds = 0.0
            # per-request latency attribution (record_attribution)
            self.attribution = _new_attribution()
            self.tokens_per_sec_ema: Optional[float] = None
            self.roofline: Optional[Dict[str, Any]] = None
            self.base: Optional[dict] = None
            self.started_unix = time.time()

    # -- recording ------------------------------------------------------
    def add(self, bucket: str, seconds: float) -> None:
        if bucket not in self.open:
            raise _invalid(
                f"serving bucket {bucket!r} is not one of {BUCKETS}")
        if seconds <= 0.0:
            return
        with self._lock:
            self.open[bucket] += float(seconds)

    def mark(self) -> float:
        with self._lock:
            return sum(self.open.values())

    def add_slot_seconds(self, seconds: float) -> None:
        """The engine-side leg of the span reconciliation: one decode
        window's compute seconds multiplied by its active slot count."""
        if seconds <= 0.0:
            return
        with self._lock:
            self.decode_slot_seconds += float(seconds)

    def end_tick(self, wall_seconds: float, decoded_tokens: int = 0,
                 active: int = 0, max_batch: int = 1,
                 kv_used: int = 0, kv_total: int = 0,
                 queued: int = 0,
                 attributed: Optional[Dict[str, float]] = None) -> dict:
        """Close the in-flight tick: the unattributed remainder goes to
        batch_gap (active batch), queue_wait (queued-only) or host_other
        (idle bookkeeping), so closed buckets sum to wall.

        With ``attributed`` the tick is built from that dict ALONE and
        the shared open tick is untouched — the atomic path concurrent
        one-shot executes use so their windows can't bleed into another
        thread's tick (and vice versa)."""
        wall = max(0.0, float(wall_seconds))
        with self._lock:
            if attributed is None:
                tick = self.open
                self.open = _zero_buckets()
            else:
                tick = _zero_buckets()
                for b, v in attributed.items():
                    tick[b] += float(v)
            got = sum(tick.values())
            rest = max(0.0, wall - got)
            if active > 0:
                tick["batch_gap"] += rest
            elif queued > 0:
                tick["queue_wait"] += rest
            else:
                tick["host_other"] += rest
            closed = dict(tick)
            for b, v in closed.items():
                self.buckets[b] += v
            self.ticks += 1
            self.wall_seconds += wall
            self.decode_tokens += int(decoded_tokens)
            if wall > 0:
                self.weighted_wall += wall
                self.occupancy_weight += wall * (
                    active / float(max(1, max_batch)))
                if kv_total > 0:
                    self.kv_util_weight += wall * (kv_used / float(kv_total))
                if decoded_tokens:
                    tps = decoded_tokens / wall
                    if self.tokens_per_sec_ema is None:
                        self.tokens_per_sec_ema = tps
                    else:
                        self.tokens_per_sec_ema += _EMA_ALPHA * (
                            tps - self.tokens_per_sec_ema)
        for b, v in closed.items():
            if v > 0:
                _M_BUCKET_S.labels(bucket=b).inc(v)
        _M_OCCUPANCY.set(active / float(max(1, max_batch)))
        if kv_total > 0:
            _M_KV_UTIL.set(kv_used / float(kv_total))
        _M_QUEUE.set(queued)
        if self.tokens_per_sec_ema is not None:
            _M_TPS.set(self.tokens_per_sec_ema)
        return closed

    def record_request(self, outcome: str = "ok",
                       ttft_s: Optional[float] = None,
                       latency_s: Optional[float] = None,
                       prompt_tokens: int = 0, output_tokens: int = 0,
                       span_seconds: float = 0.0) -> None:
        with self._lock:
            self.requests[outcome] = self.requests.get(outcome, 0) + 1
            self.prompt_tokens += int(prompt_tokens)
            if ttft_s is not None:
                hist_observe(self.ttft_hist, ttft_s)
            if latency_s is not None:
                hist_observe(self.latency_hist, latency_s)
            self.request_span_seconds += float(span_seconds)
        _M_REQUESTS.labels(outcome=outcome).inc()
        if prompt_tokens:
            _M_TOKENS.labels(kind="prompt").inc(prompt_tokens)
        if output_tokens:
            _M_TOKENS.labels(kind="decode").inc(output_tokens)
        if ttft_s is not None:
            _M_TTFT.observe(ttft_s)
        if latency_s is not None:
            _M_LATENCY.observe(latency_s)

    def record_attribution(self, buckets: Dict[str, float], e2e_s: float,
                           klass: str = "default", outcome: str = "ok",
                           request_id: Optional[str] = None,
                           time_unix: Optional[float] = None) -> float:
        """Fold one closed request's latency decomposition. ``buckets``
        maps ATTRIBUTION_BUCKETS names to seconds (absent buckets are
        simply unobserved, never zero-filled — an engine-side record has
        no router_queue); ``e2e_s`` is the independently measured
        end-to-end wall the buckets must reconstruct. Returns the
        residual fraction |sum - e2e| / e2e the caller can surface."""
        for b in buckets:
            if b not in ATTRIBUTION_BUCKETS:
                raise _invalid(f"attribution bucket {b!r} is not one of "
                               f"{ATTRIBUTION_BUCKETS}")
        e2e = max(0.0, float(e2e_s))
        got = sum(max(0.0, float(v)) for v in buckets.values())
        residual = abs(got - e2e) / e2e if e2e > 0 else 0.0
        record = {
            "request_id": request_id,
            "class": klass,
            "outcome": outcome,
            "e2e_s": round(e2e, 6),
            "buckets": {b: round(max(0.0, float(v)), 6)
                        for b, v in buckets.items()},
            "residual": round(residual, 6),
            "time_unix": time.time() if time_unix is None else time_unix,
        }
        with self._lock:
            attr = self.attribution
            attr["n_requests"] += 1
            cls = attr["classes"].setdefault(klass, _new_attr_class())
            cls["n"] += 1
            for b, v in buckets.items():
                v = max(0.0, float(v))
                h = cls["buckets"].setdefault(b, new_hist())
                hist_observe(h, v)
            hist_observe(cls["e2e"], e2e)
            hist_observe(cls["residual"], residual)
            if (cls["slowest"] is None
                    or e2e > float(cls["slowest"].get("e2e_s", 0.0))):
                cls["slowest"] = record
            cls["recent"].insert(0, record)
            del cls["recent"][_ATTR_TAIL:]
        return residual

    def set_roofline(self, pred: Optional[Dict[str, Any]]) -> None:
        """Install the decode program's roofline prediction (from the
        xla_insight AOT cost analysis + calibration) so journal readers
        can run the measured-vs-roofline reconciliation offline."""
        with self._lock:
            self.roofline = dict(pred) if pred else None

    # -- views ----------------------------------------------------------
    def totals(self, include_open: bool = True) -> Dict[str, Any]:
        with self._lock:
            open_part = dict(self.open) if include_open else _zero_buckets()
            buckets = {b: self.buckets[b] + open_part[b] for b in BUCKETS}
            doc: Dict[str, Any] = {
                "schema": SCHEMA,
                "rank": _monitor.trainer_rank(),
                "pid": os.getpid(),
                "time_unix": time.time(),
                "started_unix": self.started_unix,
                "attempt": _elastic_attempt(),
                "tokens_per_sec_ema": self.tokens_per_sec_ema,
                "roofline": dict(self.roofline) if self.roofline else None,
            }
            ticks = self.ticks
            wall = self.wall_seconds
            decode_tokens = self.decode_tokens
            prompt_tokens = self.prompt_tokens
            requests = dict(self.requests)
            ttft = {k: (list(v) if isinstance(v, list) else v)
                    for k, v in self.ttft_hist.items()}
            latency = {k: (list(v) if isinstance(v, list) else v)
                       for k, v in self.latency_hist.items()}
            occ_w = self.occupancy_weight
            kv_w = self.kv_util_weight
            w_wall = self.weighted_wall
            span_s = self.request_span_seconds
            slot_s = self.decode_slot_seconds
            attribution = json.loads(json.dumps(self.attribution))
            base = self.base
        if base:
            for b in BUCKETS:
                buckets[b] += float(base.get("buckets", {}).get(b, 0.0))
            ticks += int(base.get("ticks", 0))
            wall += float(base.get("wall_seconds", 0.0))
            decode_tokens += int(base.get("decode_tokens", 0))
            prompt_tokens += int(base.get("prompt_tokens", 0))
            for k, v in (base.get("requests") or {}).items():
                requests[k] = requests.get(k, 0) + int(v)
            ttft = merge_hist(ttft, base.get("ttft_hist") or {})
            latency = merge_hist(latency, base.get("latency_hist") or {})
            occ_w += float(base.get("occupancy_weight", 0.0))
            kv_w += float(base.get("kv_util_weight", 0.0))
            w_wall += float(base.get("weighted_wall", 0.0))
            span_s += float(base.get("request_span_seconds", 0.0))
            slot_s += float(base.get("decode_slot_seconds", 0.0))
            attribution = merge_attribution(base.get("attribution"),
                                            attribution)
            doc["resumed_from_journal"] = True
            # a warm-restarted replica's lifetime starts when its FIRST
            # incarnation did — the stale-journal filter keys on it
            if base.get("started_unix"):
                doc["started_unix"] = min(doc["started_unix"],
                                          float(base["started_unix"]))
        doc.update({
            "ticks": ticks,
            "wall_seconds": wall,
            "decode_tokens": decode_tokens,
            "prompt_tokens": prompt_tokens,
            "tokens_per_sec": (decode_tokens / wall) if wall > 0 else None,
            "requests": requests,
            "ttft_hist": ttft,
            "latency_hist": latency,
            "occupancy_weight": occ_w,
            "kv_util_weight": kv_w,
            "weighted_wall": w_wall,
            "batch_occupancy": (occ_w / w_wall) if w_wall > 0 else None,
            "kv_block_utilization": (kv_w / w_wall) if w_wall > 0 else None,
            "request_span_seconds": span_s,
            "decode_slot_seconds": slot_s,
            "attribution": attribution,
        })
        return _finalize(doc, buckets, wall)


_LEDGER = ServingLedger()
_JOURNAL_DIR: Optional[str] = None
_FLUSH_TICKS = max(1, int(_flags.env_flag("PADDLE_TPU_SERVE_FLUSH_TICKS")))
_ticks_since_flush = 0
_atexit_registered = False


def ledger() -> ServingLedger:
    return _LEDGER


def reset() -> None:
    global _ticks_since_flush
    _LEDGER.reset()
    _ticks_since_flush = 0


def add(bucket: str, seconds: float) -> None:
    if not _monitor.enabled():
        return
    _LEDGER.add(bucket, seconds)


def mark() -> float:
    return _LEDGER.mark()


def add_slot_seconds(seconds: float) -> None:
    if not _monitor.enabled():
        return
    _LEDGER.add_slot_seconds(seconds)


def end_tick(wall_seconds: float, **kw) -> Optional[dict]:
    global _ticks_since_flush
    if not _monitor.enabled():
        return None
    closed = _LEDGER.end_tick(wall_seconds, **kw)
    if _JOURNAL_DIR is not None:
        _ticks_since_flush += 1
        if _ticks_since_flush >= _FLUSH_TICKS:
            _ticks_since_flush = 0
            try:
                flush()
            except OSError:
                pass  # a full disk must not kill the serving loop
    return closed


def record_request(**kw) -> None:
    if not _monitor.enabled():
        return
    _LEDGER.record_request(**kw)


def record_attribution(buckets: Dict[str, float], e2e_s: float,
                       **kw) -> Optional[float]:
    if not _monitor.enabled():
        return None
    return _LEDGER.record_attribution(buckets, e2e_s, **kw)


def set_roofline(pred: Optional[Dict[str, Any]]) -> None:
    _LEDGER.set_roofline(pred)


def totals(include_open: bool = True) -> Dict[str, Any]:
    return _LEDGER.totals(include_open=include_open)


def top_badput(doc: Optional[Dict[str, Any]] = None
               ) -> Optional[Dict[str, Any]]:
    """The non-productive bucket holding the most seconds — the 'why is
    my p99 high' headline."""
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


def slo_summary(doc: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The SLO table: tokens/s, TTFT and latency p50/p99, occupancy, KV
    utilization, request outcomes — from a ledger doc (live totals or a
    loaded/merged journal)."""
    doc = doc or totals()
    return {
        "tokens_per_sec": doc.get("tokens_per_sec"),
        "decode_tokens": doc.get("decode_tokens", 0),
        "prompt_tokens": doc.get("prompt_tokens", 0),
        "requests": doc.get("requests", {}),
        "ttft": _hist_summary(doc.get("ttft_hist")),
        "latency": _hist_summary(doc.get("latency_hist")),
        "batch_occupancy": doc.get("batch_occupancy"),
        "kv_block_utilization": doc.get("kv_block_utilization"),
    }


def attribution_summary(doc: Optional[Dict[str, Any]] = None
                        ) -> Dict[str, Any]:
    """The per-traffic-class latency-attribution table from a ledger doc
    (live totals or a loaded/merged journal): count/avg/p50/p99 per
    bucket, the e2e and residual distributions, and the slowest raw
    record — the 'my p99 spiked, where did the time go' answer
    obs_report renders."""
    doc = doc or totals()
    attr = doc.get("attribution") or {}
    classes: Dict[str, Any] = {}
    for klass, cls in (attr.get("classes") or {}).items():
        buckets = {}
        for b in ATTRIBUTION_BUCKETS:
            h = (cls.get("buckets") or {}).get(b)
            if h and h.get("count"):
                buckets[b] = _hist_summary(h)
        classes[klass] = {
            "n": int(cls.get("n", 0)),
            "buckets": buckets,
            "e2e": _hist_summary(cls.get("e2e")),
            "residual": _hist_summary(cls.get("residual")),
            "slowest": cls.get("slowest"),
        }
    return {"n_requests": int(attr.get("n_requests", 0)),
            "classes": classes}


def summary() -> Dict[str, Any]:
    doc = totals()
    doc["top_badput"] = top_badput(doc)
    doc["slo"] = slo_summary(doc)
    return doc


def status() -> Dict[str, Any]:
    """The /status `serving` section: inert ({available: False}) until
    an engine has closed a tick or finished a request — importing the
    package must not fabricate a serving plane. Once a decode roofline
    is installed the section also carries it and its
    measured-vs-roofline reconciliation (the port's addition: the JAX
    package reads them from the journal only), so a replica's decode
    bound can be read over HTTP."""
    doc = totals()
    if doc["ticks"] == 0 and not any(doc["requests"].values()):
        return {"available": False}
    out = {
        "available": True,
        "ticks": doc["ticks"],
        "wall_seconds": doc["wall_seconds"],
        "goodput_fraction": doc["goodput_fraction"],
        "buckets": doc["buckets"],
        "top_badput": top_badput(doc),
        "slo": slo_summary(doc),
        "uptime_seconds": time.time() - _LEDGER.started_unix,
        "reconciliation": reconcile_spans(doc),
    }
    if (doc.get("attribution") or {}).get("n_requests"):
        out["request_attribution"] = attribution_summary(doc)
        out["attribution_reconciliation"] = reconcile_attribution(doc)
    if doc.get("roofline"):
        out["roofline"] = doc["roofline"]
        out["roofline_reconciliation"] = reconcile_roofline(doc)
    return out


# ---------------------------------------------------------------------------
# journal persistence (the goodput.py idiom, serving-flavored)
# ---------------------------------------------------------------------------


def journal_path(dir: Optional[str] = None) -> str:
    base = dir or _JOURNAL_DIR or "."
    return os.path.join(base,
                        f"serving.rank{_monitor.trainer_rank()}.json")


def configure(dir: Optional[str] = None,
              flush_ticks: Optional[int] = None,
              resume: bool = True) -> None:
    """Set up journal persistence; with `resume`, an existing journal
    seeds the cumulative base — only while the in-process ledger is
    still pristine (recorded ticks re-loaded as base would count
    twice)."""
    global _JOURNAL_DIR, _FLUSH_TICKS, _atexit_registered
    if dir:
        _JOURNAL_DIR = dir
        pristine = (_LEDGER.base is None and _LEDGER.ticks == 0
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
    if flush_ticks is not None:
        _FLUSH_TICKS = max(1, int(flush_ticks))


def disable_persistence() -> None:
    """Drop journal persistence for THIS process — the supervisor
    (distributed/launch.py) sheds the inherited serving env so its exit
    flush can never clobber a real replica's journal."""
    global _JOURNAL_DIR
    _JOURNAL_DIR = None


def _flush_at_exit() -> None:
    try:
        flush()
    except OSError:
        pass


def flush(path: Optional[str] = None) -> Optional[str]:
    """Write the cumulative serving journal (atomic temp + os.replace).
    No-op when persistence is unconfigured and no path given."""
    if path is None:
        if _JOURNAL_DIR is None:
            return None
        path = journal_path()
    doc = totals(include_open=False)
    doc["span_reconciliation"] = reconcile_spans(doc)
    doc["roofline_reconciliation"] = reconcile_roofline(doc)
    doc["attribution_reconciliation"] = reconcile_attribution(doc)
    return _monitor.atomic_write_text(path, json.dumps(doc, indent=1))


def load_journal(path: str) -> Dict[str, Any]:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != SCHEMA:
        raise ValueError(f"{path}: not a serving journal (schema "
                         f"{doc.get('schema')!r})")
    return doc


def load_journals(dir: str,
                  ranks: Optional[Sequence[int]] = None,
                  drop_stale: bool = True
                  ) -> Optional[Dict[str, Any]]:
    """Merge per-replica journals in `dir` into the job-level view
    (launch.py --serve teardown, obs_report --serve).

    The merge does NOT assume a fixed replica count for the run:

    - ``ranks`` (the goodput PR-4 idiom) filters journals from an
      earlier, larger run sharing the directory;
    - ``drop_stale`` filters by TIME when the caller cannot know the
      rank set (obs_report --serve): a journal whose last flush
      (``time_unix``) predates the newest journal's lifetime start
      (``started_unix``) belongs to an earlier run entirely and is
      dropped. A replica that died mid-run keeps flushing until its
      death (inside every survivor's lifetime) so its work still
      counts, and a warm-restarted replica resumes its journal with the
      ORIGINAL started_unix, so resuming never outdates its peers."""
    want = set(int(r) for r in ranks) if ranks is not None else None
    docs = []
    paths = sorted(
        glob.glob(os.path.join(dir, "serving.rank*.json"))
        + glob.glob(os.path.join(dir, "serving.router.json")))
    for path in paths:
        try:
            doc = load_journal(path)
        except (OSError, ValueError):
            continue
        # the router journal rides the rank filter free: it is a front
        # tier, not a replica, and carries no rank of its own
        if (doc.get("role") == "router" or want is None
                or int(doc.get("rank", -1)) in want):
            docs.append(doc)
    stale_filtered = 0
    if drop_stale and len(docs) > 1:
        newest_start = max(float(d.get("started_unix") or 0.0)
                           for d in docs)
        kept = [d for d in docs
                if float(d.get("time_unix") or 0.0) + 1.0 >= newest_start]
        stale_filtered = len(docs) - len(kept)
        docs = kept
    if not docs:
        return None
    merged = merge_ledgers(docs)
    merged["stale_filtered"] = stale_filtered
    return merged


def merge_ledgers(docs: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Sum per-replica ledgers: buckets/ticks/wall/tokens add, the
    fixed-bound histograms merge exactly, occupancy re-weights over the
    summed wall. Replica tokens/s ADD (replicas serve concurrently) over
    the LONGEST single-replica wall — the mean would shrink the divisor
    when a replica died mid-run (short wall) and overstate the job's
    rate exactly when a fault made it slower."""
    buckets = _zero_buckets()
    ticks = 0
    wall = 0.0
    decode_tokens = 0
    prompt_tokens = 0
    requests: Dict[str, int] = {}
    ttft = new_hist()
    latency = new_hist()
    occ_w = kv_w = w_wall = 0.0
    span_s = slot_s = 0.0
    ranks: List[int] = []
    roofline = None
    max_wall = 0.0
    n_resumed = 0
    n_replicas = 0
    attribution = _new_attribution()
    traffic = None
    autoscale = None
    for d in docs:
        attribution = merge_attribution(attribution, d.get("attribution"))
        if d.get("role") == "router":
            # the front tier's journal: its attribution records (the
            # full-stack decomposition), traffic telemetry, and the
            # autoscaler's decision trail fold in, but it is not a
            # replica — no rank row, no wall divisor
            if traffic is None and d.get("traffic"):
                traffic = d["traffic"]
            if autoscale is None and d.get("autoscale"):
                autoscale = d["autoscale"]
            continue
        n_replicas += 1
        if roofline is None and d.get("roofline"):
            # replicas serve the same compiled decode program: one
            # prediction speaks for the merged view
            roofline = d["roofline"]
        for b in BUCKETS:
            buckets[b] += float(d.get("buckets", {}).get(b, 0.0))
        ticks += int(d.get("ticks", 0))
        wall += float(d.get("wall_seconds", 0.0))
        max_wall = max(max_wall, float(d.get("wall_seconds", 0.0)))
        if d.get("resumed_from_journal"):
            n_resumed += 1
        decode_tokens += int(d.get("decode_tokens", 0))
        prompt_tokens += int(d.get("prompt_tokens", 0))
        for k, v in (d.get("requests") or {}).items():
            requests[k] = requests.get(k, 0) + int(v)
        ttft = merge_hist(ttft, d.get("ttft_hist") or {})
        latency = merge_hist(latency, d.get("latency_hist") or {})
        occ_w += float(d.get("occupancy_weight", 0.0))
        kv_w += float(d.get("kv_util_weight", 0.0))
        w_wall += float(d.get("weighted_wall", 0.0))
        span_s += float(d.get("request_span_seconds", 0.0))
        slot_s += float(d.get("decode_slot_seconds", 0.0))
        if d.get("rank") is not None:
            ranks.append(int(d["rank"]))
    # replica throughputs add over the LONGEST replica wall (concurrent
    # replicas; a died-mid-run replica's short wall must not shrink the
    # divisor and inflate the job rate)
    per_replica_wall = max_wall
    out = _finalize({
        "schema": SCHEMA,
        "ranks": sorted(ranks),
        "n_replicas": n_replicas,
        "n_resumed": n_resumed,
        "ticks": ticks,
        "wall_seconds": wall,
        "decode_tokens": decode_tokens,
        "prompt_tokens": prompt_tokens,
        "tokens_per_sec": (decode_tokens / per_replica_wall
                           if per_replica_wall > 0 else None),
        "requests": requests,
        "ttft_hist": ttft,
        "latency_hist": latency,
        "occupancy_weight": occ_w,
        "kv_util_weight": kv_w,
        "weighted_wall": w_wall,
        "batch_occupancy": (occ_w / w_wall) if w_wall > 0 else None,
        "kv_block_utilization": (kv_w / w_wall) if w_wall > 0 else None,
        "request_span_seconds": span_s,
        "decode_slot_seconds": slot_s,
        "attribution": attribution,
        "traffic": traffic,
        "autoscale": autoscale,
        "roofline": roofline,
    }, buckets, wall)
    out["top_badput"] = top_badput(out)
    out["slo"] = slo_summary(out)
    out["span_reconciliation"] = reconcile_spans(out)
    out["roofline_reconciliation"] = reconcile_roofline(out)
    out["attribution_reconciliation"] = reconcile_attribution(out)
    return out


def render_summary(doc: Dict[str, Any], title: str = "serving") -> str:
    """Human-readable SLO + bucket table (launch.py --serve teardown,
    obs_report text)."""
    denom = doc.get("wall_seconds") or sum(
        doc.get("buckets", {}).values()) or 0.0
    frac = doc.get("goodput_fraction")
    slo = doc.get("slo") or slo_summary(doc)
    head = f"== {title}: "
    head += (f"{frac * 100.0:.1f}% productive" if frac is not None
             else "no attributed time")
    head += (f" over {doc.get('ticks', 0)} tick(s), "
             f"{denom:.2f}s wall ==")
    lines = [head]
    n_ok = (doc.get("requests") or {}).get("ok", 0)
    tps = slo.get("tokens_per_sec")
    lines.append(
        f"  requests ok={n_ok} failed="
        f"{(doc.get('requests') or {}).get('failed', 0)} evicted="
        f"{(doc.get('requests') or {}).get('evicted', 0)}"
        + (f"  tokens/s={tps:.1f}" if tps else ""))
    for label, h in (("ttft", slo.get("ttft")),
                     ("latency", slo.get("latency"))):
        if h and h.get("count"):
            lines.append(
                f"  {label:<8} p50={h['p50']:.4f}s p99={h['p99']:.4f}s "
                f"avg={h['avg']:.4f}s n={h['count']}")
    occ = slo.get("batch_occupancy")
    kvu = slo.get("kv_block_utilization")
    if occ is not None:
        lines.append(f"  occupancy={occ:.3f}"
                     + (f" kv_util={kvu:.3f}" if kvu is not None else ""))
    for b in BUCKETS:
        v = float(doc.get("buckets", {}).get(b, 0.0))
        pct = (v / denom * 100.0) if denom > 0 else 0.0
        marker = "*" if b in PRODUCTIVE_BUCKETS else " "
        lines.append(f"  {marker}{b:<16} {v:>10.3f}s  {pct:>5.1f}%")
    worst = doc.get("top_badput") or top_badput(doc)
    if worst:
        lines.append(f"  top badput: {worst['bucket']} "
                     f"({worst['seconds']:.3f}s)")
    attr = doc.get("attribution") or {}
    if attr.get("n_requests"):
        rec = (doc.get("attribution_reconciliation")
               or reconcile_attribution(doc))
        if rec.get("available"):
            lines.append(
                f"  attribution: n={rec['n_requests']} residual "
                f"p50={rec['residual_p50']:.4f} "
                f"p99={rec['residual_p99']:.4f} [{rec['verdict']}]")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# reconciliations (explicit bounds, verdict taxonomy — never silent)
# ---------------------------------------------------------------------------


def reconcile_spans(doc: Optional[Dict[str, Any]] = None,
                    bound_factor: Optional[float] = None) -> Dict[str, Any]:
    """Summed per-request decode span seconds vs the engine's decode
    slot-seconds (decode_compute x active slots, accumulated per tick).
    The two sides ride independent plumbing — the per-request lifecycle
    records vs the per-tick ledger attribution — so a request dropped
    from span emission or a double-counted tick trips the bound.

    Verdicts: within_bound / outside_bound / spans_only / engine_only /
    (available: False when neither side recorded)."""
    doc = doc or totals()
    if bound_factor is None:
        bound_factor = float(_flags.env_flag("PADDLE_TPU_SERVE_SPAN_BOUND"))
    spans = float(doc.get("request_span_seconds", 0.0))
    slots = float(doc.get("decode_slot_seconds", 0.0))
    out: Dict[str, Any] = {
        "request_span_seconds": round(spans, 6),
        "decode_slot_seconds": round(slots, 6),
        "bound_factor": bound_factor,
        "available": True,
    }
    # sub-millisecond residue (a tick closed mid-request) is noise, not
    # a verdict: both sides must carry real time before the bound bites
    floor = 1e-4
    spans_real, slots_real = spans > floor, slots > floor
    if not spans_real and not slots_real:
        out.update(available=False, verdict=None, within_bound=None)
        return out
    if spans_real and not slots_real:
        out.update(verdict="spans_only", within_bound=False, ok=False)
        return out
    if slots_real and not spans_real:
        out.update(verdict="engine_only", within_bound=False, ok=False)
        return out
    ratio = spans / slots
    within = (1.0 / bound_factor) <= ratio <= bound_factor
    out.update(ratio=round(ratio, 4),
               verdict="within_bound" if within else "outside_bound",
               within_bound=within, ok=within)
    return out


def reconcile_attribution(doc: Optional[Dict[str, Any]] = None,
                          bound: Optional[float] = None) -> Dict[str, Any]:
    """Do the per-request buckets reconstruct the measured e2e walls?
    Every record folded its residual fraction |sum(buckets) - e2e| / e2e
    into a fixed-bound histogram; the MEDIAN residual must sit under
    ``bound`` (PADDLE_TPU_SERVE_ATTR_BOUND). The p99 is surfaced
    unbounded — one straggler with a torn clock should be visible, not
    fatal.

    Verdicts: within_bound / outside_bound / (available: False when no
    request carried an attribution record)."""
    doc = doc or totals()
    if bound is None:
        bound = float(_flags.env_flag("PADDLE_TPU_SERVE_ATTR_BOUND"))
    attr = doc.get("attribution") or {}
    residual: Dict[str, Any] = {}
    for cls in (attr.get("classes") or {}).values():
        residual = merge_hist(residual, cls.get("residual") or {})
    n = int(attr.get("n_requests", 0))
    out: Dict[str, Any] = {"n_requests": n, "bound": bound,
                           "available": True}
    if n == 0 or not residual.get("count"):
        out.update(available=False, verdict=None, within_bound=None)
        return out
    p50 = hist_quantile(residual, 0.50)
    p99 = hist_quantile(residual, 0.99)
    within = p50 is not None and p50 <= bound
    out.update(
        residual_p50=round(p50, 6) if p50 is not None else None,
        residual_p99=round(p99, 6) if p99 is not None else None,
        verdict="within_bound" if within else "outside_bound",
        within_bound=within, ok=within)
    return out


def reconcile_roofline(doc: Optional[Dict[str, Any]] = None,
                       roofline: Optional[Dict[str, Any]] = None,
                       bound_factor: Optional[float] = None,
                       headroom: float = 1.5) -> Dict[str, Any]:
    """Measured decode tokens/s vs the AOT cost-analysis roofline.

    ``roofline`` is the prediction the engine installs after compiling
    the decode program (serving/model.py decode_roofline): per-tick
    compute/memory/dispatch lower-bound legs and the implied tokens/s
    ceiling at the observed occupancy. The measured rate must sit within
    ``bound_factor`` BELOW the ceiling (the engine is allowed overhead,
    not magic) and at most ``headroom`` above it (the calibration's
    streaming-bandwidth probe understates cache-resident access, so a
    modest overshoot is measurement noise — but a rate FAR above the
    roofline means the prediction, or the measurement, is lying).

    The measured side is the DECODE-PLANE rate — decode tokens over the
    decode_compute bucket's seconds — because that is what the roofline
    models; the gap between it and the wall tokens/s is exactly what
    the goodput buckets attribute (prefill share, queue, gaps), not a
    roofline miss.

    Verdicts: within_bound / outside_bound / measured_only /
    predicted_only / (available: False)."""
    doc = doc or totals()
    roofline = roofline or doc.get("roofline")
    if bound_factor is None:
        bound_factor = float(
            _flags.env_flag("PADDLE_TPU_SERVE_ROOFLINE_BOUND"))
    decode_s = float(doc.get("buckets", {}).get("decode_compute", 0.0))
    decode_tokens = int(doc.get("decode_tokens", 0))
    if decode_s > 0 and decode_tokens > 0:
        measured = decode_tokens / decode_s
    else:
        measured = doc.get("tokens_per_sec")
    predicted = (roofline or {}).get("predicted_tokens_per_sec")
    out: Dict[str, Any] = {
        "measured_tokens_per_sec": measured,
        "wall_tokens_per_sec": doc.get("tokens_per_sec"),
        "predicted_tokens_per_sec": predicted,
        "bound_factor": bound_factor,
        "headroom": headroom,
        "bound_factors": (roofline or {}).get("legs"),
        "bound_by": (roofline or {}).get("bound_by"),
        "available": True,
    }
    meas_real = bool(measured and measured > 0)
    pred_real = bool(predicted and predicted > 0)
    if not meas_real and not pred_real:
        out.update(available=False, verdict=None, within_bound=None)
        return out
    if meas_real and not pred_real:
        out.update(verdict="measured_only", within_bound=False, ok=False)
        return out
    if pred_real and not meas_real:
        out.update(verdict="predicted_only", within_bound=False, ok=False)
        return out
    ratio = measured / predicted
    within = (1.0 / bound_factor) <= ratio <= headroom
    out.update(ratio=round(ratio, 4),
               verdict="within_bound" if within else "outside_bound",
               within_bound=within, ok=within)
    return out


# env-driven wiring: under launch.py --serve (or a user export) every
# replica persists its serving ledger with no code change
_env_dir = _flags.env_flag("PADDLE_TPU_SERVE_DIR")
if _env_dir:
    try:
        os.makedirs(_env_dir, exist_ok=True)
        configure(dir=_env_dir)
    except OSError:
        pass  # unwritable dir: accounting stays in-process only
