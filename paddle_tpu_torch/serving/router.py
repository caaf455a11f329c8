"""Serving front tier: replica failover, retry/hedging, draining.

Port of ``paddle_tpu/serving/router.py``. It holds no device code, so
only its imports and these notes changed: the replicas it fronts run the
port's engine, on a CUDA card or on the CPU.

The router is the piece that turns N single-replica engines
(replica processes such as ``tools/torch_serve_replica.py``, each
observable through
``/healthz`` + ``/status``) into one available service: a replica that
dies takes its in-flight requests and KV state with it, and *something*
has to notice, re-dispatch the lost work, and keep the tail latency
bounded while the replica warm-restarts. That something is this module.

Mechanics, each independently testable:

- **health**: a background prober sweeps every replica's ``/healthz``
  (the serving sub-document ``engine.healthz_info()`` publishes); a
  failed dispatch marks its replica suspect immediately — detection is
  *typed* (``errors.Unavailable`` with a ``reason``), never a hang, and
  every state transition lands in ``Router.health_events`` so a chaos
  round can reconstruct the detection/recovery timeline.
- **least-loaded dispatch**: healthy replicas ranked by router-side
  in-flight count plus the replica's last reported queue depth.
- **retry with exponential backoff + jitter**: up to
  ``PADDLE_TPU_SERVE_RETRIES`` re-dispatches; delay for attempt k is
  ``base * 2^k`` (capped) scaled into ``[0.5, 1.0)`` by a deterministic
  per-(request_id, attempt) jitter — see :func:`backoff_delay_s`, whose
  bounds the unit suite pins. A retry prefers a replica the request has
  not failed on.
- **deadline-aware hedging**: with ``PADDLE_TPU_SERVE_HEDGE_MS`` > 0, a
  request whose primary attempt is still outstanding past the hedge
  window AND whose SLO is at risk (remaining budget below the router's
  completed-latency EMA, or below half the original budget before the
  EMA exists) is duplicated onto a second replica; first success wins,
  the loser is harvested in the background.
- **idempotent re-dispatch**: every attempt (retry or hedge) carries the
  SAME request_id. Replicas dedup it (the engine's idempotency cache),
  and greedy decode over identical parameters makes the re-dispatched
  request produce the same tokens on any replica — the per-engine
  bit-match contract extended across the tier. Whenever two attempts of
  one request both return, the router compares them
  (``serve_router_bitmatch_total{verdict}``); a mismatch is a
  correctness alarm, not a retry.
- **draining**: :meth:`Router.drain_replica` stops routing to a replica
  and tells it to finish its admitted work
  (``ServingEngine.drain``), so it can be taken down without dropping
  anything (bounded by ``PADDLE_TPU_SERVE_DRAIN_S``).

The chaos site ``admit_error`` (``chaos.py``) is checked at the
top of every dispatch attempt, so injected front-door faults exercise
exactly the retry path a real one would.
"""
from __future__ import annotations

import itertools
import json
import math
import os
import threading
import time
import zlib
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import chaos as _chaos
from .. import flags as _flags
from .. import monitor as _monitor
from .. import profiler as _profiler
from . import ledger as _ledger

__all__ = [
    "backoff_delay_s", "LocalReplica", "HttpReplica", "Router",
    "TrafficTelemetry",
    "HEALTHY", "UNHEALTHY", "DEAD", "DRAINING",
]

HEALTHY, UNHEALTHY, DEAD, DRAINING = ("healthy", "unhealthy", "dead",
                                      "draining")

BACKOFF_CAP_MS = 2000.0

_M_RETRIES = _monitor.counter(
    "serve_router_retries_total",
    "request re-dispatches after a failed attempt (backoff + jitter)")
_M_HEDGES = _monitor.counter(
    "serve_router_hedges_total",
    "duplicate dispatches fired for SLO-at-risk requests")
_M_HEDGE_WINS = _monitor.counter(
    "serve_router_hedge_wins_total",
    "hedged dispatches where the hedge returned first")
_M_FAILOVER = _monitor.counter(
    "serve_router_failover_total",
    "requests completed on a different replica than first dispatched")
_M_BITMATCH = _monitor.counter(
    "serve_router_bitmatch_total",
    "re-dispatch token comparisons by verdict (match/mismatch)",
    ("verdict",))
_M_DISPATCH = _monitor.counter(
    "serve_router_dispatch_total", "router dispatches by outcome",
    ("outcome",))

_rid_counter = itertools.count(1)


def _unavailable(msg: str, reason: str = "unavailable"):
    from ..framework import errors as _errors

    e = _errors.errors.Unavailable(msg)
    e.reason = reason
    return e


def backoff_delay_s(attempt: int, request_id: str = "",
                    base_ms: Optional[float] = None,
                    cap_ms: float = BACKOFF_CAP_MS,
                    seed: int = 0) -> float:
    """Delay before re-dispatch number ``attempt`` (0-based): exponential
    ``base * 2^attempt`` capped at ``cap_ms``, jittered into
    ``[raw/2, raw)`` by a crc32 hash of (seed, request_id, attempt) —
    deterministic (same request replays the same schedule; the chaos
    bench is reproducible) yet decorrelated across requests (no retry
    stampede onto a just-recovered replica)."""
    if base_ms is None:
        base_ms = float(_flags.env_flag("PADDLE_TPU_SERVE_BACKOFF_MS"))
    raw = min(float(cap_ms), float(base_ms) * (2.0 ** max(0, int(attempt))))
    u = zlib.crc32(f"{seed}/{request_id}/{attempt}".encode()) / 2.0 ** 32
    return (raw * (0.5 + 0.5 * u)) / 1e3


# ---------------------------------------------------------------------------
# replica clients: one protocol, two transports
# ---------------------------------------------------------------------------


class LocalReplica:
    """In-process replica client over a ServingEngine — the unit-test
    and single-process transport (same protocol as HttpReplica)."""

    def __init__(self, name: str, engine):
        self.name = name
        self.engine = engine

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               deadline_s: float, request_id: str,
               timeout: float,
               trace: Optional[str] = None) -> Dict[str, Any]:
        handle = self.engine.submit(prompt, max_new_tokens=max_new_tokens,
                                    deadline_s=deadline_s,
                                    request_id=request_id, trace=trace)
        tokens = handle.result(timeout=timeout)
        return {"request_id": request_id, "tokens": list(tokens),
                "cached": handle.cached, "replica": self.name,
                "attribution": handle.attribution,
                "engine_e2e_s": handle.engine_e2e_s}

    def healthz(self, timeout: float = 1.0) -> Dict[str, Any]:
        return {"status": "ok", "serving": self.engine.healthz_info()}

    def status(self, timeout: float = 1.0) -> Dict[str, Any]:
        from . import ledger as _ledger

        return _ledger.status()

    def drain(self, timeout: float = 1.0) -> Dict[str, Any]:
        self.engine.drain()
        return {"draining": True, "drained": self.engine.drained()}


class HttpReplica:
    """HTTP replica client over the per-rank status server
    (``status.py``): GET /healthz + /status for health and load,
    POST /generate for dispatch, POST /drain for connection draining.
    Transport failures surface as typed ``errors.Unavailable`` carrying
    a ``reason`` (connect/timeout/http_<code>) — the router's detection
    input, never a bare socket exception."""

    def __init__(self, name: str, base_url: str):
        self.name = name
        self.base_url = base_url.rstrip("/")

    def _request(self, path: str, doc: Optional[dict], timeout: float
                 ) -> Dict[str, Any]:
        import socket
        import urllib.error
        import urllib.request

        url = self.base_url + path
        data = json.dumps(doc).encode() if doc is not None else None
        req = urllib.request.Request(
            url, data=data,
            headers={"Content-Type": "application/json"} if data else {})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return json.loads(resp.read().decode() or "{}")
        except urllib.error.HTTPError as e:
            try:
                body = json.loads(e.read().decode() or "{}")
            except (ValueError, OSError):
                body = {}
            raise _unavailable(
                f"{self.name} {path} -> HTTP {e.code}: "
                f"{body.get('error') or e.reason}",
                reason=("draining" if body.get("draining")
                        else f"http_{e.code}")) from e
        except (socket.timeout, TimeoutError) as e:
            raise _unavailable(
                f"{self.name} {path} timed out after {timeout:.1f}s",
                reason="timeout") from e
        except (urllib.error.URLError, ConnectionError, OSError) as e:
            raise _unavailable(
                f"{self.name} {path} unreachable: "
                f"{getattr(e, 'reason', e)}", reason="connect") from e

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               deadline_s: float, request_id: str,
               timeout: float,
               trace: Optional[str] = None) -> Dict[str, Any]:
        doc = {
            "request_id": request_id,
            "prompt": list(int(t) for t in prompt),
            "max_new_tokens": int(max_new_tokens),
            "deadline_s": float(deadline_s),
        }
        if trace:
            doc["__trace__"] = trace  # trace_id:span_id, on HTTP
        return self._request("/generate", doc, timeout)

    def healthz(self, timeout: float = 1.0) -> Dict[str, Any]:
        return self._request("/healthz", None, timeout)

    def status(self, timeout: float = 1.0) -> Dict[str, Any]:
        return self._request("/status", None, timeout)

    def drain(self, timeout: float = 5.0) -> Dict[str, Any]:
        return self._request("/drain", {}, timeout)


class TrafficTelemetry:
    """Router arrival-process ledger — the forecast input the
    traffic-aware autoscaler (``capacity.py``) reads.

    Per traffic class: request-rate EMAs at multiple horizons
    (irregular-sample exponential decay, ``alpha = 1 - exp(-dt/h)`` so
    a quiet gap decays the estimate instead of freezing it) and the
    interarrival mean/CV (coefficient of variation — CV ~ 1 is Poisson,
    CV >> 1 is bursty; the number an autoscaler must see before it
    trusts a mean rate). Plus a bounded queue-depth / in-flight time
    series sampled at dispatch, on the shared span clock so the series
    aligns with the merged timeline."""

    def __init__(self, horizons: Optional[Sequence[float]] = None,
                 max_series: Optional[int] = None):
        if horizons is None:
            horizons = [
                float(h) for h in str(_flags.env_flag(
                    "PADDLE_TPU_SERVE_TELEMETRY_HORIZONS")).split(",")
                if h.strip()]
        self.horizons = tuple(float(h) for h in horizons)
        self.max_series = int(
            max_series if max_series is not None
            else _flags.env_flag("PADDLE_TPU_SERVE_TELEMETRY_SERIES"))
        self._lock = threading.Lock()
        self._classes: Dict[str, Dict[str, Any]] = {}
        self._series: List[Dict[str, Any]] = []
        self.started_unix = _profiler.span_clock_unix()

    def _new_class(self) -> Dict[str, Any]:
        return {"n": 0, "last_unix": None,
                "rate_ema": {h: None for h in self.horizons},
                "dt_sum": 0.0, "dt_sq": 0.0, "dt_n": 0}

    def note_arrival(self, klass: str = "default",
                     now: Optional[float] = None) -> None:
        now = _profiler.span_clock_unix() if now is None else float(now)
        with self._lock:
            cls = self._classes.setdefault(klass, self._new_class())
            last = cls["last_unix"]
            if last is not None:
                dt = max(1e-9, now - last)
                rate = 1.0 / dt
                for h in self.horizons:
                    alpha = 1.0 - math.exp(-dt / h)
                    prev = cls["rate_ema"][h]
                    cls["rate_ema"][h] = (
                        rate if prev is None
                        else prev + alpha * (rate - prev))
                cls["dt_sum"] += dt
                cls["dt_sq"] += dt * dt
                cls["dt_n"] += 1
            cls["n"] += 1
            cls["last_unix"] = now

    def note_depth(self, queued: int, inflight: int,
                   now: Optional[float] = None) -> None:
        now = _profiler.span_clock_unix() if now is None else float(now)
        with self._lock:
            self._series.append({"time_unix": round(now, 6),
                                 "queued": int(queued),
                                 "inflight": int(inflight)})
            if len(self._series) > self.max_series > 0:
                del self._series[:len(self._series) - self.max_series]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            classes: Dict[str, Any] = {}
            for klass, cls in self._classes.items():
                n_dt = cls["dt_n"]
                mean = cv = None
                if n_dt > 0:
                    mean = cls["dt_sum"] / n_dt
                    if n_dt > 1 and mean > 0:
                        var = max(0.0, cls["dt_sq"] / n_dt - mean * mean)
                        cv = math.sqrt(var) / mean
                classes[klass] = {
                    "n": cls["n"],
                    "rate_ema": {
                        f"{h:g}s": (round(v, 4) if v is not None else None)
                        for h, v in cls["rate_ema"].items()},
                    "interarrival": {
                        "mean_s": round(mean, 6) if mean is not None
                        else None,
                        "cv": round(cv, 4) if cv is not None else None,
                        "n": n_dt},
                    "last_unix": cls["last_unix"],
                }
            series = list(self._series)
        depth_summary = None
        if series:
            qs = [s["queued"] for s in series]
            fs = [s["inflight"] for s in series]
            depth_summary = {
                "samples": len(series),
                "queued_mean": round(sum(qs) / len(qs), 3),
                "queued_max": max(qs),
                "inflight_mean": round(sum(fs) / len(fs), 3),
                "inflight_max": max(fs),
            }
        return {"horizons_s": list(self.horizons),
                "started_unix": self.started_unix,
                "classes": classes,
                "depth_summary": depth_summary,
                "series": series}


class _Rep:
    """Router-side replica bookkeeping."""

    def __init__(self, client):
        self.client = client
        self.name = client.name
        self.state = HEALTHY  # optimistic: the first dispatch probes it
        self.inflight = 0
        self.last_queued = 0
        self.consecutive_failures = 0
        self.dispatches = 0


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------


class Router:
    """The front tier over N replica clients (Local or Http)."""

    def __init__(self, replicas: Sequence[Any],
                 retries: Optional[int] = None,
                 backoff_ms: Optional[float] = None,
                 hedge_ms: Optional[float] = None,
                 default_slo_s: Optional[float] = None,
                 seed: int = 0,
                 health_interval_s: float = 0.5,
                 health_timeout_s: float = 1.0,
                 max_workers: int = 64):
        self._reps: Dict[str, _Rep] = {}
        for client in replicas:
            if client.name in self._reps:
                raise ValueError(f"duplicate replica name {client.name!r}")
            self._reps[client.name] = _Rep(client)
        self.retries = int(retries if retries is not None
                           else _flags.env_flag("PADDLE_TPU_SERVE_RETRIES"))
        self.backoff_ms = float(
            backoff_ms if backoff_ms is not None
            else _flags.env_flag("PADDLE_TPU_SERVE_BACKOFF_MS"))
        self.hedge_ms = float(
            hedge_ms if hedge_ms is not None
            else _flags.env_flag("PADDLE_TPU_SERVE_HEDGE_MS"))
        self.default_slo_s = float(
            default_slo_s if default_slo_s is not None
            else _flags.env_flag("PADDLE_TPU_SERVE_SLO_S"))
        self.seed = int(seed)
        self.health_interval_s = float(health_interval_s)
        self.health_timeout_s = float(health_timeout_s)
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="serve-router")
        self._health_thread: Optional[threading.Thread] = None
        self._stop_health = threading.Event()
        self._pending_compares: List[Any] = []
        # the completed-latency EMAs feeding the SLO-at-risk hedge test,
        # PER TRAFFIC CLASS: one global EMA let a batch tenant's long
        # completions inflate the expected-service estimate and trip
        # hedges for every interactive request (or, the other way, a
        # fast interactive stream suppress the hedge a slow class needed)
        self._latency_ema: Dict[str, float] = {}
        # multi-tenant SLO classes (set_slo_classes): per-class default
        # deadline, hedge policy, and admission weight
        self.slo_classes: Optional[Dict[str, Dict[str, Any]]] = None
        self._admission_cap: Optional[int] = None
        self._class_inflight: Dict[str, int] = {}
        # the autoscaler's journal (note_autoscale): current plan +
        # typed decision records, exported with ledger_doc()
        self._autoscale: Optional[Dict[str, Any]] = None
        # the router's OWN serving ledger (per-request full-stack
        # latency attribution) — never the module singleton, which
        # belongs to a co-resident replica engine's journal
        self._ledger = _ledger.ServingLedger()
        # arrival-process telemetry: the autoscaler's forecast input
        self.telemetry = TrafficTelemetry()
        self.health_events: List[Dict[str, Any]] = []
        self.stats: Dict[str, int] = {
            "dispatches": 0, "ok": 0, "failed": 0, "retries": 0,
            "hedges": 0, "hedge_wins": 0, "failovers": 0,
            "bitmatch_checked": 0, "bitmatch_mismatch": 0,
            "admission_rejects": 0,
        }

    # -- replica set ----------------------------------------------------

    def replica_names(self) -> List[str]:
        return list(self._reps)

    def replica_state(self, name: str) -> str:
        return self._reps[name].state

    def clients(self) -> List[Any]:
        with self._lock:
            return [r.client for r in self._reps.values()]

    def add_replica(self, client) -> None:
        """Join a freshly warm-booted replica into the rotation (the
        autoscaler's scale-up path). Optimistic like the constructor:
        the first dispatch or health sweep probes it."""
        with self._lock:
            if client.name in self._reps:
                raise ValueError(f"duplicate replica name {client.name!r}")
            self._reps[client.name] = _Rep(client)
        _monitor.flight_record("serve_router", "replica_added",
                               replica=client.name)

    def remove_replica(self, name: str) -> None:
        """Drop a replica from the rotation (after drain_replica — the
        autoscaler's scale-down path never removes undrained work)."""
        with self._lock:
            self._reps.pop(name, None)
        _monitor.flight_record("serve_router", "replica_removed",
                               replica=name)

    # -- SLO classes + autoscale journal --------------------------------

    def set_slo_classes(self, classes: Dict[str, Dict[str, Any]],
                        admission_cap: Optional[int] = None) -> None:
        """Install the multi-tenant SLO-class table: per-class default
        deadlines, per-class hedge policy (a batch class with hedge=0
        never burns a second replica slot), and — with an
        ``admission_cap`` — weighted admission: once router-wide
        in-flight reaches the cap, a class keeps admitting only inside
        its weight-proportional share, so one tenant's burst cannot
        starve another's p99."""
        with self._lock:
            self.slo_classes = dict(classes)
            if admission_cap is not None:
                self._admission_cap = int(admission_cap) or None

    def _class_slo_s(self, klass: str) -> float:
        cls = (self.slo_classes or {}).get(klass)
        if cls and cls.get("slo_s"):
            return float(cls["slo_s"])
        return self.default_slo_s

    def _class_hedge_allowed(self, klass: str) -> bool:
        cls = (self.slo_classes or {}).get(klass)
        return True if cls is None else bool(cls.get("hedge", True))

    def _admit(self, klass: str) -> bool:
        """Weighted admission test (True = admit). Only bites when an
        admission cap is configured AND the router is at it; below the
        cap every class admits freely, above it a class is bounced
        (typed, retryable) once its own in-flight exceeds its
        weight-share of the cap."""
        cap = self._admission_cap
        if not cap or not self.slo_classes:
            return True
        with self._lock:
            total = sum(self._class_inflight.values())
            if total < cap:
                return True
            weights = {k: float(c.get("weight", 1.0))
                       for k, c in self.slo_classes.items()}
            w = weights.get(klass, 1.0)
            share = cap * w / max(1e-9, sum(weights.values()))
            if self._class_inflight.get(klass, 0) < max(1.0, share):
                return True
            self.stats["admission_rejects"] += 1
        _monitor.flight_record("serve_router", "admission_reject",
                               klass=klass)
        return False

    def note_autoscale(self, plan: Optional[Dict[str, Any]] = None,
                       decision: Optional[Dict[str, Any]] = None,
                       decisions: Optional[List[Dict[str, Any]]] = None,
                       summary: Optional[Dict[str, Any]] = None) -> None:
        """Fold the autoscaler's state into this router's journal:
        current plan, typed decision records (appended one at a time or
        replaced wholesale by finalize()), and the round summary
        (attainment/regret) — exported under ``autoscale`` in
        ledger_doc() so ``serving.router.json`` carries the whole
        decision trail."""
        with self._lock:
            auto = self._autoscale or {"plan": None, "decisions": []}
            if plan is not None:
                auto["plan"] = plan
            if decision is not None:
                auto["decisions"].append(decision)
            if decisions is not None:
                auto["decisions"] = list(decisions)
            if summary is not None:
                auto.update(summary)
            self._autoscale = auto

    def _transition(self, rep: _Rep, state: str, reason: str) -> None:
        with self._lock:
            if rep.state == state:
                return
            old, rep.state = rep.state, state
            # unix stamp on THE span clock so health transitions line up
            # with replica spans in the merged timeline (a process-local
            # time.time() drifts against perf_counter-anchored spans)
            self.health_events.append({
                "time_unix": _profiler.span_clock_unix(),
                "replica": rep.name,
                "from": old, "to": state, "reason": reason,
            })
        _monitor.flight_record("serve_router", "replica_" + state,
                               replica=rep.name, was=old, reason=reason)

    # -- health ---------------------------------------------------------

    def probe_once(self) -> Dict[str, str]:
        """One health sweep: /healthz per replica (except ones this
        router is draining — their state is router-owned). Dead replicas
        that answer again rejoin the healthy set — the warm-restart
        rejoin path."""
        for rep in self._reps.values():
            if rep.state == DRAINING:
                # router-owned draining is sticky until the REPLICA says
                # it is no longer draining (a cancelled take-down);
                # while the drain RPC is still in flight the replica may
                # transiently report not-draining — the flip back to
                # DRAINING on the next sweep costs one typed rejection.
                # A missing `serving` section here is a replica that
                # crashed mid-drain and is warm-restarting: NOT servable
                # yet (same rule as the normal branch below)
                try:
                    doc = rep.client.healthz(
                        timeout=self.health_timeout_s)
                    srv = doc.get("serving")
                    if srv is None:
                        self._transition(rep, UNHEALTHY, "no_engine")
                    elif not srv.get("draining"):
                        self._transition(rep, HEALTHY, "drain_cancelled")
                except Exception:
                    pass  # still counted as draining, not dead
                continue
            try:
                doc = rep.client.healthz(timeout=self.health_timeout_s)
                srv = doc.get("serving")
                if srv is None:
                    # the process answers but no engine is registered
                    # yet (a replica still warm-restarting: status port
                    # binds at import, the engine warms after) — up,
                    # but not servable
                    self._transition(rep, UNHEALTHY, "no_engine")
                    continue
                rep.last_queued = int(srv.get("queued") or 0)
                rep.consecutive_failures = 0
                if srv.get("draining"):
                    self._transition(rep, DRAINING, "replica_draining")
                else:
                    self._transition(rep, HEALTHY, "healthz_ok")
            except Exception as e:
                rep.consecutive_failures += 1
                self._transition(
                    rep, DEAD,
                    str(getattr(e, "reason", None) or "healthz_failed"))
        return {name: r.state for name, r in self._reps.items()}

    def start_health(self, interval_s: Optional[float] = None) -> None:
        if self._health_thread is not None \
                and self._health_thread.is_alive():
            return
        if interval_s is not None:
            self.health_interval_s = float(interval_s)
        self._stop_health.clear()

        def loop():
            while not self._stop_health.wait(self.health_interval_s):
                try:
                    self.probe_once()
                except Exception:
                    pass  # the prober must outlive any one bad sweep

        self._health_thread = threading.Thread(
            target=loop, name="serve-router-health", daemon=True)
        self._health_thread.start()

    def stop(self) -> None:
        self._stop_health.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=5)
            self._health_thread = None
        self.wait_hedges(timeout=1.0)
        self._pool.shutdown(wait=False)

    # -- selection ------------------------------------------------------

    def _pick(self, exclude: Sequence[str] = (),
              prefer_not: Optional[str] = None) -> Optional[_Rep]:
        """Least-loaded healthy replica: router-side in-flight plus the
        replica's last reported queue depth; a retry prefers a replica
        the request has not already failed on."""
        with self._lock:
            cands = [r for r in self._reps.values()
                     if r.state == HEALTHY and r.name not in exclude]
            if not cands:
                return None
            if prefer_not is not None and len(cands) > 1:
                others = [c for c in cands if c.name != prefer_not]
                cands = others or cands
            cands.sort(key=lambda r: (r.inflight + r.last_queued,
                                      r.inflight, r.name))
            return cands[0]

    # -- dispatch -------------------------------------------------------

    def _slo_at_risk(self, t_submit: float, deadline_abs: float,
                     klass: str = "default") -> bool:
        """Hedge admission test: the remaining budget is smaller than
        the expected service time (THIS class's completed-latency EMA
        — a batch tenant's long completions must not trip interactive
        hedges, nor a fast interactive stream suppress a slow class's),
        or — before the class has an EMA — less than half the original
        budget remains."""
        remaining = deadline_abs - time.monotonic()
        if remaining <= 0:
            return True
        ema = self._latency_ema.get(klass)
        if ema is not None:
            return remaining < ema
        return remaining < 0.5 * (deadline_abs - t_submit)

    def _note_latency(self, seconds: float,
                      klass: str = "default") -> None:
        with self._lock:
            ema = self._latency_ema.get(klass)
            if ema is None:
                self._latency_ema[klass] = float(seconds)
            else:
                self._latency_ema[klass] = ema + 0.2 * (seconds - ema)

    def _call(self, rep: _Rep, request_id: str, prompt: Sequence[int],
              max_new_tokens: int, deadline_abs: float,
              hedge: bool = False,
              trace_ctx: Optional[Tuple[str, str]] = None,
              klass: str = "default") -> Dict[str, Any]:
        """One attempt on one replica; never raises — the outcome record
        is the aggregation unit retry/hedging reasons over. With
        ``trace_ctx`` (trace_id, root_span_id) the attempt pre-mints its
        span id, ships "trace_id:span_id" to the replica (whose
        lifecycle spans parent under it) and emits the attempt span as a
        sibling child of the dispatch root on completion — so retries,
        hedges and failovers render as one connected flow."""
        t0 = time.monotonic()
        t0_ns = time.perf_counter_ns()
        rec: Dict[str, Any] = {"replica": rep.name, "hedge": bool(hedge),
                               "time_unix": _profiler.span_clock_unix()}
        attempt_sid = trace_arg = None
        if trace_ctx is not None:
            attempt_sid = _profiler.new_span_id()
            trace_arg = f"{trace_ctx[0]}:{attempt_sid}"
        with self._lock:
            rep.inflight += 1
            rep.dispatches += 1
        try:
            remaining = max(0.05, deadline_abs - t0)
            out = rep.client.submit(
                prompt, max_new_tokens=max_new_tokens,
                deadline_s=remaining, request_id=request_id,
                timeout=remaining + 2.0, trace=trace_arg)
            rec.update(ok=True, tokens=list(out.get("tokens") or []),
                       cached=bool(out.get("cached")),
                       attribution=out.get("attribution"),
                       engine_e2e_s=out.get("engine_e2e_s"))
            self._note_latency(time.monotonic() - t0, klass)
        except Exception as e:
            rec.update(ok=False, error=str(e)[:300],
                       error_type=type(e).__name__,
                       reason=getattr(e, "reason", None))
            # only TRANSPORT failures kill a replica: a connect refusal
            # is a dead process RIGHT NOW, a timeout may be one slow
            # request (two strikes). Application-level typed rejections
            # (shed/drain bounces, http_5xx) mean the replica is alive
            # and talking — marking it DEAD would let a load burst
            # permanently empty the rotation when no prober runs.
            if rec["reason"] in ("connect", "timeout"):
                with self._lock:
                    rep.consecutive_failures += 1
                    strikes = rep.consecutive_failures
                if rec["reason"] == "connect" or strikes >= 2:
                    self._transition(rep, DEAD, rec["reason"])
        else:
            with self._lock:
                rep.consecutive_failures = 0
        finally:
            with self._lock:
                rep.inflight -= 1
        t1 = time.monotonic()
        rec["latency_s"] = round(t1 - t0, 6)
        # monotonic interval for the dispatch-side attribution: the
        # union of attempt intervals is what "time spent attempting"
        # means once hedges overlap
        rec["_t0_mono"], rec["_t1_mono"] = t0, t1
        if attempt_sid is not None:
            _profiler.emit_span(
                "serve/attempt", cat="serve", t0_ns=t0_ns,
                dur_ns=time.perf_counter_ns() - t0_ns,
                span_id=attempt_sid, parent_span_id=trace_ctx[1],
                trace_id=trace_ctx[0],
                meta={"request_id": request_id, "replica": rep.name,
                      "hedge": bool(hedge), "ok": bool(rec.get("ok")),
                      **({"reason": rec["reason"]}
                         if rec.get("reason") else {})})
        return rec

    def _compare_tokens(self, request_id: str, a: Dict[str, Any],
                        b: Dict[str, Any]) -> Optional[bool]:
        """Bit-match audit over two completed attempts of one request:
        greedy decode over identical replica parameters must agree."""
        if not (a.get("ok") and b.get("ok")):
            return None
        match = list(a.get("tokens") or []) == list(b.get("tokens") or [])
        with self._lock:
            self.stats["bitmatch_checked"] += 1
            if not match:
                self.stats["bitmatch_mismatch"] += 1
        _M_BITMATCH.labels(verdict="match" if match else "mismatch").inc()
        if not match:
            _monitor.flight_record(
                "serve_router", "bitmatch_mismatch",
                request_id=request_id, a=a.get("replica"),
                b=b.get("replica"))
        return match

    def wait_hedges(self, timeout: float = 5.0) -> None:
        """Block until in-background hedge losers are harvested (their
        bit-match comparisons recorded) — tests and the chaos bench call
        this before reading the stats."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                pending = [f for f in self._pending_compares
                           if not f.done()]
                self._pending_compares = pending
            if not pending or time.monotonic() >= deadline:
                return
            wait(pending, timeout=max(0.0, deadline - time.monotonic()))

    def _attempt(self, request_id: str, prompt: Sequence[int],
                 max_new_tokens: int, t_submit: float,
                 deadline_abs: float, tried: List[str],
                 attempts_log: List[Dict[str, Any]],
                 flags: Optional[Dict[str, Any]] = None,
                 trace_ctx: Optional[Tuple[str, str]] = None,
                 klass: str = "default"
                 ) -> Optional[Dict[str, Any]]:
        """One (possibly hedged) attempt round. Returns the successful
        record or None (every outcome appended to ``attempts_log``)."""
        rep = self._pick(prefer_not=tried[-1] if tried else None)
        if rep is None:
            attempts_log.append({
                "replica": None, "ok": False, "hedge": False,
                "error_type": "UnavailableError",
                "reason": "no_replica",
                "time_unix": _profiler.span_clock_unix(),
                "error": "no healthy replica in the set"})
            return None
        tried.append(rep.name)
        fut = self._pool.submit(self._call, rep, request_id, prompt,
                                max_new_tokens, deadline_abs,
                                False, trace_ctx, klass)
        hedge_s = self.hedge_ms / 1e3
        if hedge_s > 0 and self._class_hedge_allowed(klass):
            done, _ = wait([fut], timeout=hedge_s)
            if not done and self._slo_at_risk(t_submit, deadline_abs,
                                              klass):
                rep2 = self._pick(exclude=[rep.name])
                if rep2 is not None:
                    tried.append(rep2.name)
                    if flags is not None:
                        # recorded HERE, not derived from attempts_log:
                        # the loser may be harvested after dispatch()
                        # already returned its record
                        flags["hedged"] = True
                    with self._lock:
                        self.stats["hedges"] += 1
                    _M_HEDGES.inc()
                    fut2 = self._pool.submit(self._call, rep2, request_id,
                                             prompt, max_new_tokens,
                                             deadline_abs, True, trace_ctx,
                                             klass)
                    return self._resolve_hedge(request_id, fut, fut2,
                                               deadline_abs, attempts_log)
        timeout = max(0.05, deadline_abs - time.monotonic()) + 3.0
        done, _ = wait([fut], timeout=timeout)
        if not done:
            # a future that CANCELS never started: that is router pool
            # saturation, not a wedged replica — the no_hang verdict
            # must not blame a replica for our own queue
            saturated = fut.cancel()
            attempts_log.append({
                "replica": rep.name, "ok": False, "hedge": False,
                "error_type": ("UnavailableError" if saturated
                               else "ExecutionTimeoutError"),
                "reason": "pool_saturated" if saturated else "hang",
                "time_unix": _profiler.span_clock_unix(),
                "error": ("attempt never started: router pool saturated"
                          if saturated else
                          "attempt never returned within the deadline")})
            return None
        rec = fut.result()
        attempts_log.append(rec)
        return rec if rec.get("ok") else None

    def _resolve_hedge(self, request_id: str, primary, hedge,
                       deadline_abs: float,
                       attempts_log: List[Dict[str, Any]]
                       ) -> Optional[Dict[str, Any]]:
        """First success wins; the loser is harvested in the background
        and compared for the bit-match audit."""
        futs = {primary, hedge}
        timeout = max(0.05, deadline_abs - time.monotonic()) + 3.0
        deadline = time.monotonic() + timeout
        winner: Optional[Dict[str, Any]] = None
        while futs:
            done, futs_left = wait(
                futs, timeout=max(0.0, deadline - time.monotonic()),
                return_when=FIRST_COMPLETED)
            if not done:
                # every outstanding attempt past the deadline is a HANG
                # and must say so — a silent break would let a wedged
                # hedged request pass the no_hang/typed verdicts. A
                # cancellable future never started: pool saturation,
                # not a wedged replica.
                for f in futs:
                    saturated = f.cancel()
                    attempts_log.append({
                        "replica": None, "ok": False, "hedge": f is hedge,
                        "error_type": ("UnavailableError" if saturated
                                       else "ExecutionTimeoutError"),
                        "reason": ("pool_saturated" if saturated
                                   else "hang"),
                        "time_unix": _profiler.span_clock_unix(),
                        "error": "attempt never returned within the "
                                 "deadline"})
                break
            futs = set(futs_left)
            for f in done:
                rec = f.result()
                attempts_log.append(rec)
                if rec.get("ok") and winner is None:
                    winner = rec
                    if f is hedge:
                        with self._lock:
                            self.stats["hedge_wins"] += 1
                        _M_HEDGE_WINS.inc()
            if winner is not None:
                break
        if winner is not None and futs:
            # harvest the loser off the critical path: its bit-match
            # verdict lands in the counters/stats via wait_hedges(). It
            # is NOT appended to attempts_log — dispatch() has already
            # returned that list inside the request record, and a
            # caller-visible record must not mutate under its reader
            loser = next(iter(futs))
            win = winner

            def _harvest():
                self._compare_tokens(request_id, win, loser.result())

            with self._lock:
                self._pending_compares.append(self._pool.submit(_harvest))
        elif winner is not None:
            others = [r for r in attempts_log[-2:] if r is not winner]
            for other in others:
                self._compare_tokens(request_id, winner, other)
        return winner

    def _assemble_attribution(self, attempts: List[Dict[str, Any]],
                              winner: Optional[Dict[str, Any]],
                              e2e_s: float, backoff_wait_s: float
                              ) -> Tuple[Dict[str, float], float]:
        """Full-stack latency decomposition of one dispatch: the
        winner's engine-side buckets, plus the router-side trio —
        measured backoff sleeps, ``transport`` (the UNION of attempt
        wall intervals minus the winner's engine e2e: wire time plus
        dead-peer probing; the union, so overlapping hedge attempts
        cannot double-count), and ``router_queue`` (the remainder) — so
        the buckets reconstruct the router-measured e2e. Returns
        (buckets, residual_fraction)."""
        intervals = sorted(
            (a["_t0_mono"], a["_t1_mono"]) for a in attempts
            if a.get("_t0_mono") is not None)
        union = 0.0
        cur0 = cur1 = None
        for a0, a1 in intervals:
            if cur1 is None or a0 > cur1:
                if cur1 is not None:
                    union += cur1 - cur0
                cur0, cur1 = a0, a1
            else:
                cur1 = max(cur1, a1)
        if cur1 is not None:
            union += cur1 - cur0
        buckets: Dict[str, float] = {}
        eng = (winner or {}).get("attribution") or {}
        eng_s = 0.0
        for b, v in eng.items():
            v = max(0.0, float(v))
            buckets[b] = v
            eng_s += v
        buckets["backoff_wait"] = max(0.0, float(backoff_wait_s))
        buckets["transport"] = max(0.0, union - eng_s)
        buckets["router_queue"] = max(
            0.0, e2e_s - buckets["backoff_wait"] - union)
        got = sum(buckets.values())
        residual = abs(got - e2e_s) / e2e_s if e2e_s > 0 else 0.0
        return buckets, residual

    def dispatch(self, prompt: Sequence[int], max_new_tokens: int = 16,
                 deadline_s: Optional[float] = None,
                 request_id: Optional[str] = None,
                 traffic_class: str = "default") -> Dict[str, Any]:
        """Dispatch one request with failover: pick -> attempt ->
        (hedge) -> retry with backoff, all attempts under one
        request_id. Returns the request record (never raises): ``ok``,
        ``tokens``, ``n_attempts``, per-attempt outcomes,
        ``within_deadline`` — the availability unit the SERVE chaos
        bench aggregates — and ``attribution`` (the full-stack latency
        decomposition, recorded per ``traffic_class`` in the router's
        ledger)."""
        if deadline_s is None:
            deadline_s = self._class_slo_s(traffic_class)
        rid = request_id or f"rt-{next(_rid_counter)}"
        t_submit = time.monotonic()
        t_submit_ns = time.perf_counter_ns()
        t_submit_unix = _profiler.span_clock_unix()
        deadline_abs = t_submit + float(deadline_s)
        self.telemetry.note_arrival(traffic_class, now=t_submit_unix)
        if not self._admit(traffic_class):
            # weighted admission: at the cap and over this class's
            # share — a typed, retryable bounce, so the starved tenant's
            # p99 is protected by the bursting tenant's 503s, not theirs
            latency = time.monotonic() - t_submit
            with self._lock:
                self.stats["dispatches"] += 1
                self.stats["failed"] += 1
            _M_DISPATCH.labels(outcome="failed").inc()
            err = (f"admission: class {traffic_class!r} over its "
                   f"weighted share at the router admission cap")
            attribution = {"backoff_wait": 0.0, "transport": 0.0,
                           "router_queue": latency}
            self._ledger.record_attribution(
                attribution, latency, klass=traffic_class,
                outcome="failed", request_id=rid,
                time_unix=t_submit_unix)
            return {
                "request_id": rid, "time_unix": t_submit_unix,
                "ok": False, "tokens": None, "cached": False,
                "replica": None, "replicas_tried": [],
                "n_attempts": 0,
                "attempts": [{
                    "replica": None, "ok": False, "hedge": False,
                    "error_type": "UnavailableError",
                    "reason": "admission_weighted",
                    "time_unix": t_submit_unix, "error": err}],
                "hedged": False, "failover": False,
                "latency_s": round(latency, 6),
                "deadline_s": float(deadline_s),
                "within_deadline": False,
                "traffic_class": traffic_class,
                "attribution": {b: round(v, 6)
                                for b, v in attribution.items()},
                "attribution_residual": 0.0,
                "error": err, "error_type": "UnavailableError",
            }
        attempts: List[Dict[str, Any]] = []
        tried: List[str] = []
        flags: Dict[str, Any] = {"hedged": False}
        winner: Optional[Dict[str, Any]] = None
        backoff_wait = 0.0
        # cross-process trace root: pre-mint the dispatch span id, every
        # attempt becomes a sibling child carrying "trace_id:span_id"
        # across the wire. PADDLE_TPU_SERVE_TRACE=0 strips propagation.
        trace_ctx: Optional[Tuple[str, str]] = None
        if _profiler.tracing_active() \
                and bool(_flags.env_flag("PADDLE_TPU_SERVE_TRACE")):
            trace_ctx = (_profiler.current_trace_id(),
                         _profiler.new_span_id())
        with self._lock:
            self.stats["dispatches"] += 1
            queued = sum(r.last_queued for r in self._reps.values())
            inflight = sum(r.inflight for r in self._reps.values())
            self._class_inflight[traffic_class] = \
                self._class_inflight.get(traffic_class, 0) + 1
        self.telemetry.note_depth(queued, inflight, now=t_submit_unix)
        for attempt in range(self.retries + 1):
            if attempt > 0:
                delay = backoff_delay_s(attempt - 1, rid,
                                        self.backoff_ms, seed=self.seed)
                remaining = deadline_abs - time.monotonic()
                if remaining <= 0:
                    break  # no budget left: this is NOT a retry
                with self._lock:
                    self.stats["retries"] += 1
                _M_RETRIES.inc()
                t_sleep = time.monotonic()
                time.sleep(min(delay, max(0.0, remaining - 1e-3)))
                backoff_wait += time.monotonic() - t_sleep
            if _chaos.armed("admit_error"):
                from ..framework import errors as _errors

                try:
                    _chaos.admit_error(where=f"router/{rid}")
                except _errors.errors.Unavailable as e:
                    attempts.append({
                        "replica": None, "ok": False, "hedge": False,
                        "error": str(e)[:300], "reason": "chaos",
                        "error_type": type(e).__name__,
                        "time_unix": _profiler.span_clock_unix()})
                    continue
            winner = self._attempt(rid, prompt, max_new_tokens, t_submit,
                                   deadline_abs, tried, attempts, flags,
                                   trace_ctx, traffic_class)
            if winner is not None:
                break
        with self._lock:
            self._class_inflight[traffic_class] = max(
                0, self._class_inflight.get(traffic_class, 1) - 1)
        latency = time.monotonic() - t_submit
        ok = winner is not None
        # failover = completed on a different replica than FIRST
        # dispatched to (tried[0]); attempts-list order is completion
        # order under hedging, so it cannot be the key
        failover = bool(ok and tried
                        and winner.get("replica") != tried[0])
        if failover:
            with self._lock:
                self.stats["failovers"] += 1
            _M_FAILOVER.inc()
        with self._lock:
            self.stats["ok" if ok else "failed"] += 1
        _M_DISPATCH.labels(outcome="ok" if ok else "failed").inc()
        last_err = next((a for a in reversed(attempts)
                         if not a.get("ok")), None)
        attribution, residual = self._assemble_attribution(
            attempts, winner, latency, backoff_wait)
        self._ledger.record_attribution(
            attribution, latency, klass=traffic_class,
            outcome="ok" if ok else "failed", request_id=rid,
            time_unix=t_submit_unix)
        for a in attempts:  # internal interval keys stay internal
            a.pop("_t0_mono", None)
            a.pop("_t1_mono", None)
        if trace_ctx is not None:
            _profiler.emit_span(
                "serve/dispatch", cat="serve", t0_ns=t_submit_ns,
                dur_ns=time.perf_counter_ns() - t_submit_ns,
                span_id=trace_ctx[1], trace_id=trace_ctx[0],
                meta={"request_id": rid, "ok": ok,
                      "replica": winner.get("replica") if ok else None,
                      "hedged": flags["hedged"],
                      "failover": failover,
                      "n_attempts": len(attempts),
                      "traffic_class": traffic_class})
        return {
            "request_id": rid,
            "time_unix": t_submit_unix,
            "ok": ok,
            "tokens": list(winner["tokens"]) if ok else None,
            "cached": bool(winner.get("cached")) if ok else False,
            "replica": winner.get("replica") if ok else None,
            "replicas_tried": list(dict.fromkeys(tried)),
            "n_attempts": len(attempts),
            "attempts": attempts,
            "hedged": flags["hedged"] or any(a.get("hedge")
                                             for a in attempts),
            "failover": failover,
            "latency_s": round(latency, 6),
            "deadline_s": float(deadline_s),
            "within_deadline": bool(ok and latency <= float(deadline_s)),
            "traffic_class": traffic_class,
            "attribution": {b: round(v, 6)
                            for b, v in attribution.items()},
            "attribution_residual": round(residual, 6),
            "error": (last_err or {}).get("error") if not ok else None,
            "error_type": (last_err or {}).get("error_type")
            if not ok else None,
        }

    # -- draining -------------------------------------------------------

    def drain_replica(self, name: str,
                      timeout_s: Optional[float] = None) -> bool:
        """Take a replica out of rotation without dropping its admitted
        work: stop routing to it, ask it to drain, and wait (bounded by
        PADDLE_TPU_SERVE_DRAIN_S) until it reports drained."""
        if timeout_s is None:
            timeout_s = float(_flags.env_flag("PADDLE_TPU_SERVE_DRAIN_S"))
        rep = self._reps[name]
        self._transition(rep, DRAINING, "drain_requested")
        try:
            rep.client.drain(timeout=max(1.0, self.health_timeout_s))
        except Exception as e:
            self._transition(rep, DEAD,
                             str(getattr(e, "reason", None) or "drain_rpc"))
            return False
        deadline = time.monotonic() + float(timeout_s)
        while time.monotonic() < deadline:
            try:
                doc = rep.client.healthz(timeout=self.health_timeout_s)
                if (doc.get("serving") or {}).get("drained"):
                    return True
            except Exception:
                return False  # died while draining: nothing left to wait on
            time.sleep(0.05)
        return False

    def snapshot(self) -> Dict[str, Any]:
        """Router stats + per-replica state (the chaos bench's failover
        section; obs_report reads the metric counters instead)."""
        with self._lock:
            return {
                "stats": dict(self.stats),
                "latency_ema_s": dict(self._latency_ema),
                "class_inflight": {k: v for k, v
                                   in self._class_inflight.items() if v},
                "slo_classes": self.slo_classes,
                "admission_cap": self._admission_cap,
                "replicas": {
                    name: {"state": r.state, "inflight": r.inflight,
                           "queued": r.last_queued,
                           "dispatches": r.dispatches}
                    for name, r in self._reps.items()
                },
                "health_events": list(self.health_events),
            }

    def ledger_doc(self) -> Dict[str, Any]:
        """The router's serving-ledger journal document: the full-stack
        per-request attribution aggregate plus the arrival-process
        telemetry, marked ``role: router`` so ledger.load_journals /
        merge_ledgers treat it as the front tier, not a replica."""
        doc = self._ledger.totals(include_open=False)
        doc["role"] = "router"
        doc["traffic"] = self.telemetry.snapshot()
        doc["router"] = self.snapshot()
        with self._lock:
            if self._autoscale is not None:
                doc["autoscale"] = json.loads(json.dumps(self._autoscale))
        doc["attribution_reconciliation"] = \
            _ledger.reconcile_attribution(doc)
        return doc

    def flush_ledger(self, dir: str) -> str:
        """Write ``serving.router.json`` next to the replicas' per-rank
        journals (atomic write-then-rename) so the merged job view
        carries the full-stack attribution and traffic telemetry."""
        path = os.path.join(dir, "serving.router.json")
        return _monitor.atomic_write_text(
            path, json.dumps(self.ledger_doc(), indent=1))
