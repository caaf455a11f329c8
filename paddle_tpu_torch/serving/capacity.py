"""Serving capacity planner: traffic telemetry becomes scale decisions.

Port of ``paddle_tpu/serving/capacity.py``. It holds no device code, so
only its imports and these notes changed. The roofline it scores with is
the port's (``DecodeModel.decode_roofline`` over the analytic decode
cost record). The repo's committed ``SERVE_r*.json`` rounds are the JAX
package's, taken on a TPU and in a CPU container, so nothing in the port
points :func:`load_serve_history` or :func:`plan`'s ``history_dir`` at
them: the port's plans run uncalibrated until the port records rounds of
its own.

The serving twin of the training auto-planner (``planner.py``), over the
router's traffic telemetry: per-class arrival-rate EMAs at multiple
horizons, the interarrival CV, and the router's queue-depth series. Same
discipline, serving units:

- **forecast** (:func:`forecast_demand`): per traffic class, blend the
  rate EMAs across horizons (short horizons react to a burst, long ones
  smooth it; weights ~ 1/h) and widen the planning demand by the
  measured burstiness — ``upper = blend * (1 + cv_widen * cv)`` — so a
  CV~1 Poisson stream plans ~2x its mean while a metronome stream plans
  its mean. Pure math over a ``TrafficTelemetry.snapshot()``.
- **enumerate** (:func:`enumerate_configs`): every (replicas x tp x
  max_batch) configuration inside the device budget.
- **score** (:func:`score_config`): per-replica tokens/s capacity from
  the decode roofline's per-tick legs, scaled to the candidate's
  batch and tp (compute grows with batch and shards by tp; the
  weight-streaming memory leg shards by tp; dispatch is host-side and
  constant), then corrected by the measured-vs-predicted calibration
  factor replayed from committed ``SERVE_r*.json`` rounds — per-config
  where this shape has history, global otherwise.
- **decide** (:func:`decide`): pure — pick the CHEAPEST configuration
  (fewest devices) whose calibrated capacity holds the widened demand
  with headroom AND whose predicted queueing latency meets every SLO
  class; every rejection carries its why-not. Re-deciding the same
  scored set under another SLO or headroom recomputes no roofline.
- **act** (:class:`Autoscaler`): the router-supervisor loop that
  executes the plan live — scale-ups ride the warm-restart path
  (a replica process loading the shared params .npz), every
  scale-down drains first, and every decision journals as a typed
  record (inputs snapshot, predicted vs realized SLO attainment) that
  lands in ``serving.router.json``.
- **judge** (:func:`oracle_schedule` / :func:`scale_regret`): after a
  trace-driven round, the oracle replica schedule is recomputed from
  the SAME arrival trace (per window: fewest replicas whose capacity
  clears the window's demand plus carried backlog) and ``scale_regret``
  is the replica-seconds mismatch between what the autoscaler ran and
  what the oracle would have — the number the SERVE gate bounds.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .. import flags as _flags
from .. import monitor as _monitor
from .. import profiler as _profiler

__all__ = [
    "parse_slo_classes", "forecast_demand", "enumerate_configs",
    "score_config", "decide", "plan", "render_plan_text",
    "extract_traffic", "load_serve_history",
    "calibration_pairs_from_serve_history", "calibrate_capacity",
    "oracle_schedule", "schedule_windows", "scale_regret",
    "slo_attainment", "Autoscaler",
]

SCHEMA = "paddle_tpu.serve_plan/1"


# ---------------------------------------------------------------------------
# SLO classes (multi-tenant: interactive vs batch)
# ---------------------------------------------------------------------------


def parse_slo_classes(spec: Optional[str] = None) -> Dict[str, Dict[str, Any]]:
    """Parse the SLO-class spec (PADDLE_TPU_SERVE_SLO_CLASSES when not
    given): ``name:slo=<s>,weight=<w>,hedge=<0|1>[;name:...]``. Weight
    is the class's admission share under contention; hedge gates
    whether the router may duplicate this class's SLO-at-risk requests
    (a batch tenant's long completions should absorb latency, not burn
    a second replica slot)."""
    if spec is None:
        spec = str(_flags.env_flag("PADDLE_TPU_SERVE_SLO_CLASSES"))
    classes: Dict[str, Dict[str, Any]] = {}
    for part in str(spec).split(";"):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise ValueError(
                f"SLO class {part!r}: expected name:slo=<s>[,...]")
        name, _, kvs = part.partition(":")
        name = name.strip()
        if not name:
            raise ValueError(f"SLO class {part!r}: empty class name")
        cls = {"slo_s": None, "weight": 1.0, "hedge": True}
        for kv in kvs.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, _, v = kv.partition("=")
            k = k.strip()
            if k == "slo":
                cls["slo_s"] = float(v)
            elif k == "weight":
                cls["weight"] = float(v)
            elif k == "hedge":
                cls["hedge"] = v.strip() not in ("0", "false", "off", "no")
            else:
                raise ValueError(
                    f"SLO class {name!r}: unknown key {k!r} "
                    f"(expected slo/weight/hedge)")
        if cls["slo_s"] is None or cls["slo_s"] <= 0:
            raise ValueError(f"SLO class {name!r}: slo=<seconds> required")
        if cls["weight"] <= 0:
            raise ValueError(f"SLO class {name!r}: weight must be > 0")
        classes[name] = cls
    if not classes:
        raise ValueError(f"no SLO classes in spec {spec!r}")
    return classes


# ---------------------------------------------------------------------------
# forecast: telemetry snapshot -> per-class planning demand
# ---------------------------------------------------------------------------


def forecast_demand(traffic: Optional[Dict[str, Any]],
                    cv_widen: Optional[float] = None) -> Dict[str, Any]:
    """Per-class demand forecast from a ``TrafficTelemetry.snapshot()``.

    Blend: ``sum(w_h * ema_h) / sum(w_h)`` over the horizons with an
    estimate, ``w_h = 1/h`` — the 1s EMA dominates so a burst moves the
    forecast within seconds, while the 60s EMA keeps a quiet gap from
    reading as zero demand. Planning upper bound: the blend widened by
    the measured interarrival CV (``1 + cv_widen * cv``; CV defaults to
    1.0 — Poisson — while unmeasured, so a cold class still plans
    burst room). The queue-depth series rides along as the backlog
    signal an executor can drain on."""
    if cv_widen is None:
        cv_widen = float(_flags.env_flag(
            "PADDLE_TPU_SERVE_AUTOSCALE_CV_WIDEN"))
    traffic = traffic or {}
    horizons = [float(h) for h in traffic.get("horizons_s") or []]
    classes_out: Dict[str, Any] = {}
    total_blend = total_upper = 0.0
    for klass, cls in (traffic.get("classes") or {}).items():
        emas = cls.get("rate_ema") or {}
        num = den = 0.0
        for h in horizons:
            v = emas.get(f"{h:g}s")
            if v is None:
                continue
            w = 1.0 / max(h, 1e-9)
            num += w * float(v)
            den += w
        blend = (num / den) if den > 0 else 0.0
        cv = (cls.get("interarrival") or {}).get("cv")
        cv_eff = float(cv) if cv is not None else 1.0
        upper = blend * (1.0 + cv_widen * cv_eff)
        classes_out[klass] = {
            "n": cls.get("n"),
            "rate_blend_per_s": round(blend, 4),
            "rate_upper_per_s": round(upper, 4),
            "cv": round(cv_eff, 4),
            "cv_measured": cv is not None,
        }
        total_blend += blend
        total_upper += upper
    depth = traffic.get("depth_summary") or {}
    series = traffic.get("series") or []
    last = series[-1] if series else {}
    return {
        "classes": classes_out,
        "total_rate_blend_per_s": round(total_blend, 4),
        "total_rate_upper_per_s": round(total_upper, 4),
        "cv_widen": cv_widen,
        "horizons_s": horizons,
        "backlog": {
            "queued_last": last.get("queued"),
            "inflight_last": last.get("inflight"),
            "queued_mean": depth.get("queued_mean"),
            "queued_max": depth.get("queued_max"),
        },
    }


# ---------------------------------------------------------------------------
# enumerate + score: the candidate configurations
# ---------------------------------------------------------------------------


def enumerate_configs(device_budget: int,
                      tp_degrees: Sequence[int] = (1, 2),
                      max_batches: Sequence[int] = (4, 8, 16),
                      min_replicas: int = 1) -> List[Dict[str, Any]]:
    """Every (replicas x tp x max_batch) with replicas*tp inside the
    device budget — the serving counterpart of the training planner's
    layout enumeration (axes: data-parallel replicas instead of dp/tp
    mesh shapes, plus the batch knob the engine schedules under)."""
    budget = max(1, int(device_budget))
    out: List[Dict[str, Any]] = []
    for tp in sorted(set(int(t) for t in tp_degrees)):
        if tp < 1 or tp > budget:
            continue
        for replicas in range(max(1, int(min_replicas)),
                              budget // tp + 1):
            for mb in sorted(set(int(b) for b in max_batches)):
                out.append({
                    "spec": f"r{replicas}/tp{tp}/mb{mb}",
                    "replicas": replicas, "tp": tp, "max_batch": mb,
                    "devices": replicas * tp,
                })
    return out


def score_config(cand: Dict[str, Any], roofline: Dict[str, Any],
                 calibration: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
    """Capacity score for one candidate from the decode roofline's
    per-tick legs (measured at the roofline's program's ``max_batch``,
    carried in ``mean_active``'s program): compute scales linearly with
    the batch the tick serves and shards by tp; the memory leg is
    weight-streaming dominated at serving batch sizes, so it shards by
    tp but does not grow with batch; dispatch is host-side and does
    neither. Per-replica tokens/s = max_batch / scaled tick floor; the
    calibration factor (median measured/predicted from committed SERVE
    rounds — per-config where this spec has history) corrects it."""
    legs = roofline.get("legs") or {}
    base_batch = max(1.0, float(roofline.get("mean_active") or 1.0))
    b = float(cand["max_batch"])
    tp = float(cand["tp"])
    scaled = {
        "compute_s": float(legs.get("compute_s") or 0.0) * (b / base_batch)
        / tp,
        "memory_s": float(legs.get("memory_s") or 0.0) / tp,
        "dispatch_s": float(legs.get("dispatch_s") or 0.0),
    }
    floor = max(scaled.values()) if any(scaled.values()) else 0.0
    bound_by = max(scaled, key=scaled.get) if floor > 0 else None
    per_replica = (b / floor) if floor > 0 else 0.0
    cal = (calibration or {}).get("tokens_per_sec") or {}
    per_config = (cal.get("by_config") or {}).get(cand["spec"]) or {}
    factor = per_config.get("correction_factor") \
        or cal.get("correction_factor")
    corrected = per_replica * factor if factor else None
    effective = corrected if corrected is not None else per_replica
    return {
        "spec": cand["spec"],
        "axes": {"replicas": cand["replicas"], "tp": cand["tp"],
                 "max_batch": cand["max_batch"]},
        "devices": cand["devices"],
        "legs": {k: round(v, 9) for k, v in scaled.items()},
        "predicted": {
            "tick_seconds_floor": round(floor, 9) if floor else None,
            "bound_by": bound_by,
            "tokens_per_sec_per_replica": round(per_replica, 2),
            "tokens_per_sec_corrected": (round(corrected, 2)
                                         if corrected is not None
                                         else None),
            "correction_source": (
                "config" if per_config.get("correction_factor")
                else ("global" if factor else None)),
            "tokens_per_sec_total": round(
                effective * cand["replicas"], 2),
        },
    }


# ---------------------------------------------------------------------------
# decide: the pure verdict
# ---------------------------------------------------------------------------


def decide(scored: Sequence[Dict[str, Any]], forecast: Dict[str, Any],
           slo_classes: Dict[str, Dict[str, Any]], *,
           device_budget: int,
           tokens_per_request: float = 8.0,
           headroom: Optional[float] = None,
           top_k: int = 3) -> Dict[str, Any]:
    """Scored candidates + forecast + SLO classes -> the verdict. Pure:
    re-deciding the same scored set under a tighter SLO or different
    headroom is free (no roofline or model recompute). Feasibility per
    candidate: calibrated total capacity must hold the CV-widened
    demand (in tokens/s) inside the headroom, and the predicted
    queueing latency — one request's decode time inflated by the
    utilization knee, ``service / (1 - rho)`` — must meet every class's
    SLO. Survivors rank cheapest-first (devices, then predicted
    latency); every rejection carries its why-not, tallied."""
    if headroom is None:
        headroom = float(_flags.env_flag(
            "PADDLE_TPU_SERVE_AUTOSCALE_HEADROOM"))
    top_k = max(1, int(top_k))
    tokens_per_request = max(1e-9, float(tokens_per_request))
    demand_tps = (forecast.get("total_rate_upper_per_s") or 0.0) \
        * tokens_per_request

    feasible: List[Dict[str, Any]] = []
    rejected: List[Dict[str, Any]] = []
    for s in scored:
        pred = s["predicted"]
        cap_total = float(pred["tokens_per_sec_total"] or 0.0)

        def _reject(reason: str, detail: str) -> None:
            rejected.append({
                "spec": s["spec"], "axes": s["axes"],
                "devices": s["devices"], "reason": reason,
                "detail": detail,
                "predicted_tokens_per_sec_total": cap_total,
            })

        if s["devices"] > int(device_budget):
            _reject("over-budget",
                    f"{s['devices']} devices against a budget of "
                    f"{device_budget}")
            continue
        if cap_total <= 0:
            _reject("no-roofline", "no capacity estimate for this shape")
            continue
        if demand_tps > cap_total:
            _reject("under-capacity",
                    f"demand {demand_tps:.1f} tok/s exceeds capacity "
                    f"{cap_total:.1f} tok/s")
            continue
        if demand_tps > cap_total * (1.0 - headroom):
            _reject("headroom",
                    f"demand {demand_tps:.1f} tok/s eats the "
                    f"{headroom:.0%} headroom of {cap_total:.1f} tok/s")
            continue
        rho = demand_tps / cap_total
        floor = float(pred["tick_seconds_floor"] or 0.0)
        # one request's decode time once scheduled (it runs on ONE
        # replica regardless of how many the config has)
        service_s = tokens_per_request * floor
        latency_by_class: Dict[str, Any] = {}
        slo_miss = None
        for klass, cls in slo_classes.items():
            lat = service_s / max(1e-9, 1.0 - rho)
            attain = 1.0 if lat <= cls["slo_s"] \
                else round(cls["slo_s"] / lat, 4)
            latency_by_class[klass] = {
                "predicted_latency_s": round(lat, 4),
                "slo_s": cls["slo_s"],
                "predicted_attainment": attain,
            }
            if slo_miss is None and lat > cls["slo_s"]:
                slo_miss = (klass, lat, cls["slo_s"])
        if slo_miss is not None:
            klass, lat, slo = slo_miss
            _reject(f"slo-miss:{klass}",
                    f"predicted latency {lat:.3f}s over the "
                    f"{slo:g}s {klass} SLO at rho={rho:.2f}")
            continue
        feasible.append({
            **{k: s[k] for k in ("spec", "axes", "devices", "predicted")},
            "rho": round(rho, 4),
            "by_class": latency_by_class,
        })

    feasible.sort(key=lambda e: (
        e["devices"],
        max(c["predicted_latency_s"] for c in e["by_class"].values())
        if e["by_class"] else 0.0,
        e["spec"]))
    ranked = feasible[:top_k]
    pick = ranked[0] if ranked else None
    for e in feasible[top_k:]:
        rejected.append({
            "spec": e["spec"], "axes": e["axes"],
            "devices": e["devices"], "reason": "costlier",
            "detail": (f"{e['devices']} devices vs the pick's "
                       f"{pick['devices']}" if pick else
                       f"outside top-{top_k}"),
            "predicted_tokens_per_sec_total":
                e["predicted"]["tokens_per_sec_total"],
        })
    tally: Dict[str, int] = {}
    for r in rejected:
        tally[r["reason"]] = tally.get(r["reason"], 0) + 1
    return {
        "pick": pick,
        "ranked": ranked,
        "rejected": rejected,
        "rejected_tally": dict(sorted(tally.items())),
        "n_feasible": len(feasible),
        "top_k": top_k,
        "headroom_fraction": headroom,
        "demand_tokens_per_sec": round(demand_tps, 2),
        "tokens_per_request": tokens_per_request,
        "verdict": "ok" if pick is not None else "no_feasible_config",
    }


# ---------------------------------------------------------------------------
# calibration: replaying committed SERVE rounds
# ---------------------------------------------------------------------------


def load_serve_history(history_dir: str,
                       pattern: str = "SERVE_r*.json"
                       ) -> List[Tuple[str, dict]]:
    """Committed SERVE rounds oldest -> newest (the planner's
    load_round_history, serving pattern). The port's own rounds only:
    the repo root's ``SERVE_r*.json`` are the JAX package's."""
    from .. import planner as _planner

    return _planner.load_round_history(history_dir,
                                       patterns=(pattern,))[pattern]


def calibration_pairs_from_serve_history(
        history: Sequence[Tuple[str, dict]]) -> Dict[str, List[dict]]:
    """Replay committed SERVE rounds into (predicted, measured)
    tokens/s pairs, keyed by the round's engine config:

    - steady rounds carry both sides in
      ``reconciliations.measured_vs_roofline`` (the roofline
      honesty check), measured at the engine wall;
    - autoscale rounds carry the planner's own per-replica prediction
      and the realized per-replica rate under ``autoscale.calibration_pair``.

    Rounds predating either surface are skipped — counted by absence,
    never guessed at. The per-config median outvotes the global one in
    :func:`score_config` exactly as in the training planner."""
    pairs: Dict[str, List[dict]] = {"tokens_per_sec": []}

    def add(rnd, config, predicted, measured):
        if not predicted or not measured or predicted <= 0 \
                or measured <= 0:
            return
        pairs["tokens_per_sec"].append({
            "round": rnd, "config": config,
            "predicted": round(float(predicted), 4),
            "measured": round(float(measured), 4),
            "ratio": round(float(measured) / float(predicted), 6),
        })

    for rnd, doc in history:
        parsed = doc.get("parsed") if isinstance(doc.get("parsed"), dict) \
            else doc
        eng = parsed.get("engine") or {}
        config = (f"r{eng.get('replicas', 1)}/tp1/"
                  f"mb{eng.get('max_batch')}")
        roof_rec = (parsed.get("reconciliations") or {}).get(
            "measured_vs_roofline") or {}
        add(rnd, config, roof_rec.get("predicted_tokens_per_sec"),
            roof_rec.get("measured_tokens_per_sec"))
        auto = parsed.get("autoscale") or {}
        pair = auto.get("calibration_pair") or {}
        add(rnd, pair.get("config") or config,
            pair.get("predicted_tokens_per_sec_per_replica"),
            pair.get("measured_tokens_per_sec_per_replica"))
    return pairs


def calibrate_capacity(pairs: Dict[str, List[dict]]) -> Dict[str, Any]:
    """The planner's calibrate() over serving pairs: per-metric median
    measured/predicted correction factor, raw vs residual error, and
    the per-config medians that outvote the global factor."""
    from .. import planner as _planner

    return _planner.calibrate(pairs)


# ---------------------------------------------------------------------------
# the oracle schedule + scale regret (the judged numbers)
# ---------------------------------------------------------------------------


def oracle_schedule(arrivals: Sequence[Tuple[float, float]], *,
                    capacity_tokens_per_sec: float,
                    window_s: float,
                    max_replicas: int,
                    min_replicas: int = 1,
                    horizon_s: Optional[float] = None
                    ) -> Dict[str, Any]:
    """The post-hoc oracle: given the SAME arrival trace the round ran
    — ``(t_seconds, demand_tokens)`` pairs — the fewest replicas per
    window whose combined capacity clears that window's demand plus
    any backlog carried from windows the cap already saturated. The
    oracle sees the future exactly one window at a time (it is a
    capacity bound, not a clairvoyant scheduler) and is clamped to the
    same [min, max] replica range the autoscaler had."""
    if capacity_tokens_per_sec <= 0:
        raise ValueError("capacity_tokens_per_sec must be > 0")
    if window_s <= 0:
        raise ValueError("window_s must be > 0")
    max_replicas = max(int(min_replicas), int(max_replicas))
    end = max((t for t, _ in arrivals), default=0.0)
    if horizon_s is not None:
        end = max(end, float(horizon_s))
    n_windows = max(1, int(math.ceil(end / window_s)) or 1)
    demand = [0.0] * n_windows
    for t, tokens in arrivals:
        w = min(n_windows - 1, max(0, int(t // window_s)))
        demand[w] += float(tokens)
    per_window_cap = capacity_tokens_per_sec * window_s
    windows: List[Dict[str, Any]] = []
    backlog = 0.0
    for w, d in enumerate(demand):
        need = backlog + d
        replicas = int(math.ceil(need / per_window_cap)) if need > 0 else 0
        replicas = min(max_replicas, max(int(min_replicas), replicas))
        served = min(need, replicas * per_window_cap)
        backlog = max(0.0, need - served)
        windows.append({
            "t0_s": round(w * window_s, 3),
            "demand_tokens": round(d, 2),
            "replicas": replicas,
        })
    return {
        "window_s": float(window_s),
        "min_replicas": int(min_replicas),
        "max_replicas": int(max_replicas),
        "capacity_tokens_per_sec_per_replica":
            float(capacity_tokens_per_sec),
        "windows": windows,
        "replica_seconds": round(
            sum(w["replicas"] for w in windows) * window_s, 3),
        "final_backlog_tokens": round(backlog, 2),
    }


def schedule_windows(events: Sequence[Tuple[float, int]],
                     horizon_s: float, window_s: float,
                     initial_replicas: int) -> List[int]:
    """Flatten a step function of (t_seconds, replicas_after) scale
    events into per-window replica counts (time-weighted mean per
    window, rounded half-up) aligned with :func:`oracle_schedule`'s
    windows — the actual side of the regret comparison."""
    if window_s <= 0:
        raise ValueError("window_s must be > 0")
    n_windows = max(1, int(math.ceil(horizon_s / window_s)) or 1)
    evs = sorted((max(0.0, float(t)), int(n)) for t, n in events)
    counts: List[int] = []
    for w in range(n_windows):
        t0, t1 = w * window_s, min((w + 1) * window_s, horizon_s)
        t1 = max(t1, t0 + 1e-9)
        level = int(initial_replicas)
        weighted = 0.0
        cursor = t0
        for t, n in evs:
            if t <= t0:
                level = n
                continue
            if t >= t1:
                break
            weighted += level * (t - cursor)
            cursor, level = t, n
        weighted += level * (t1 - cursor)
        counts.append(int(math.floor(weighted / (t1 - t0) + 0.5)))
    return counts


def scale_regret(actual_replicas: Sequence[int],
                 oracle: Dict[str, Any]) -> Dict[str, Any]:
    """Replica-seconds mismatch between the schedule the autoscaler ran
    and the oracle's, normalized by the oracle's replica-seconds:
    ``sum |actual_w - oracle_w| * window / oracle_replica_seconds``.
    Over-provisioning (idle replicas the oracle would not have paid
    for) and under-provisioning (windows the oracle says needed more)
    both count — regret 0 means the autoscaler tracked the oracle
    exactly; reaction lag after a burst shows up as a small positive
    number, a wedged autoscaler as a large one."""
    counts = [w["replicas"] for w in oracle["windows"]]
    if len(actual_replicas) != len(counts):
        raise ValueError(
            f"schedule length {len(actual_replicas)} != oracle windows "
            f"{len(counts)}")
    window_s = float(oracle["window_s"])
    mismatch = sum(abs(int(a) - int(o))
                   for a, o in zip(actual_replicas, counts))
    oracle_rs = max(1e-9, float(oracle["replica_seconds"]))
    over = sum(max(0, int(a) - int(o))
               for a, o in zip(actual_replicas, counts))
    under = sum(max(0, int(o) - int(a))
                for a, o in zip(actual_replicas, counts))
    return {
        "scale_regret": round(mismatch * window_s / oracle_rs, 6),
        "actual_replica_seconds": round(
            sum(int(a) for a in actual_replicas) * window_s, 3),
        "oracle_replica_seconds": round(oracle_rs, 3),
        "over_provisioned_windows": over,
        "under_provisioned_windows": under,
        "n_windows": len(counts),
        "window_s": window_s,
    }


def slo_attainment(records: Sequence[Dict[str, Any]],
                   slo_classes: Dict[str, Dict[str, Any]]
                   ) -> Dict[str, Any]:
    """Per-class SLO attainment over router dispatch records: the
    fraction of each class's requests that completed within that
    class's OWN SLO (the dispatch deadline already carries it; this
    recomputes against the class table so a record dispatched with a
    wrong deadline cannot launder a miss)."""
    by_class: Dict[str, Dict[str, Any]] = {}
    for rec in records:
        klass = rec.get("traffic_class") or "default"
        cls = by_class.setdefault(klass, {"n": 0, "ok_within_slo": 0})
        cls["n"] += 1
        slo = (slo_classes.get(klass) or {}).get("slo_s") \
            or rec.get("deadline_s")
        if rec.get("ok") and rec.get("latency_s") is not None \
                and slo and float(rec["latency_s"]) <= float(slo):
            cls["ok_within_slo"] += 1
    total = sum(c["n"] for c in by_class.values())
    ok = sum(c["ok_within_slo"] for c in by_class.values())
    for klass, c in by_class.items():
        c["attainment"] = round(c["ok_within_slo"] / c["n"], 4) \
            if c["n"] else None
        c["slo_s"] = (slo_classes.get(klass) or {}).get("slo_s")
    return {
        "by_class": by_class,
        "overall": round(ok / total, 4) if total else None,
        "requests": total,
    }


# ---------------------------------------------------------------------------
# plan(): the serve_plan CLI entry (decide without acting)
# ---------------------------------------------------------------------------


def extract_traffic(doc: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """A telemetry snapshot out of whatever the operator has on hand: a
    raw ``TrafficTelemetry.snapshot()``, a merged serving ledger /
    ``serving.router.json`` (``traffic``), or a committed SERVE round
    (``parsed.traffic_telemetry``)."""
    if not isinstance(doc, dict):
        return None
    if "classes" in doc and "horizons_s" in doc:
        return doc
    for path in (("traffic",), ("parsed", "traffic_telemetry"),
                 ("traffic_telemetry",)):
        cur: Any = doc
        for key in path:
            cur = cur.get(key) if isinstance(cur, dict) else None
        if isinstance(cur, dict) and "classes" in cur:
            return cur
    return None


def plan(traffic: Optional[Dict[str, Any]],
         roofline: Dict[str, Any], *,
         device_budget: int,
         slo_classes: Optional[Dict[str, Dict[str, Any]]] = None,
         tp_degrees: Sequence[int] = (1, 2),
         max_batches: Sequence[int] = (4, 8, 16),
         tokens_per_request: float = 8.0,
         headroom: Optional[float] = None,
         top_k: int = 3,
         history_dir: Optional[str] = None) -> Dict[str, Any]:
    """forecast -> enumerate -> score (calibrated against committed
    SERVE rounds when ``history_dir`` is given) -> decide. The full
    decision report tools/serve_plan.py renders and the Autoscaler
    re-runs each tick."""
    slo_classes = slo_classes or parse_slo_classes()
    calibration = None
    n_history = 0
    if history_dir:
        history = load_serve_history(history_dir)
        n_history = len(history)
        calibration = calibrate_capacity(
            calibration_pairs_from_serve_history(history))
    forecast = forecast_demand(traffic)
    cands = enumerate_configs(device_budget, tp_degrees=tp_degrees,
                              max_batches=max_batches)
    scored = [score_config(c, roofline, calibration) for c in cands]
    decision = decide(scored, forecast, slo_classes,
                      device_budget=device_budget,
                      tokens_per_request=tokens_per_request,
                      headroom=headroom, top_k=top_k)
    return {
        "schema": SCHEMA,
        "slo_classes": slo_classes,
        "forecast": forecast,
        "n_candidates": len(cands),
        "decision": decision,
        "calibration": ((calibration or {}).get("tokens_per_sec")
                        if calibration else None),
        "n_history_rounds": n_history,
        "roofline": {k: roofline.get(k)
                     for k in ("bound_by", "tick_seconds_floor",
                               "mean_active", "program")},
    }


def render_plan_text(report: Dict[str, Any]) -> str:
    """Human rendering of a plan() report (tools/serve_plan.py)."""
    d = report["decision"]
    lines = [
        f"serve_plan: {d['verdict']} — demand "
        f"{d['demand_tokens_per_sec']} tok/s (upper bound), "
        f"{report['n_candidates']} candidate(s), "
        f"{d['n_feasible']} feasible",
    ]
    for klass, cls in sorted(report["slo_classes"].items()):
        fc = (report["forecast"]["classes"] or {}).get(klass) or {}
        lines.append(
            f"  class {klass}: slo {cls['slo_s']:g}s weight "
            f"{cls['weight']:g} hedge {int(cls['hedge'])} — forecast "
            f"{fc.get('rate_blend_per_s', 0.0)} req/s "
            f"(upper {fc.get('rate_upper_per_s', 0.0)}, cv "
            f"{fc.get('cv', 'n/a')})")
    pick = d.get("pick")
    if pick:
        p = pick["predicted"]
        lines.append(
            f"  pick {pick['spec']}: {pick['devices']} device(s), "
            f"{p['tokens_per_sec_total']} tok/s total "
            f"(per-replica {p['tokens_per_sec_per_replica']}"
            + (f", corrected {p['tokens_per_sec_corrected']} via "
               f"{p['correction_source']}"
               if p.get("tokens_per_sec_corrected") is not None else "")
            + f"), rho {pick['rho']}")
        for klass, c in sorted(pick["by_class"].items()):
            lines.append(
                f"    {klass}: predicted {c['predicted_latency_s']}s "
                f"against {c['slo_s']:g}s SLO "
                f"(attainment {c['predicted_attainment']})")
    for e in d.get("ranked", [])[1:]:
        lines.append(f"  runner-up {e['spec']}: {e['devices']} "
                     f"device(s), rho {e['rho']}")
    if d.get("rejected_tally"):
        tally = ", ".join(f"{k} x{v}"
                          for k, v in d["rejected_tally"].items())
        lines.append(f"  rejected: {tally}")
    cal = report.get("calibration")
    if cal and cal.get("n_pairs"):
        lines.append(
            f"  calibration: factor {cal['correction_factor']} over "
            f"{cal['n_pairs']} pair(s) from "
            f"{report['n_history_rounds']} committed round(s), "
            f"residual {cal['residual_error']}")
    else:
        lines.append("  calibration: none (predictions uncorrected)")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# the autoscaler: executing the plan live
# ---------------------------------------------------------------------------


class Autoscaler:
    """The router-supervisor loop that turns plans into scale actions.

    Owns the replica set between ``min_replicas`` and ``max_replicas``:
    each :meth:`step` re-forecasts from the router's live telemetry,
    re-decides (pure — the expensive roofline/calibration inputs are
    fixed at construction), and moves ONE replica toward the plan:
    scale-ups call ``spawn_replica(index) -> client`` (the
    warm-restart path: a replica process loading the shared params .npz)
    and add the client to the router's rotation; scale-downs ALWAYS
    drain first (``Router.drain_replica``) and only then call
    ``stop_replica(name)`` — admitted work retires, nothing drops.
    Per-class hedge policy and weighted admission are pushed to the
    router from the SLO-class table. Every decision journals as a
    typed record (inputs snapshot, predicted attainment; realized
    attainment back-filled by :meth:`finalize`) mirrored into the
    router's ledger doc, and emits a ``serve/scale`` instant event on
    the span clock so the merged timeline can line scale actions up
    against the p99 they caused or fixed."""

    def __init__(self, router, roofline: Dict[str, Any], *,
                 spawn_replica: Callable[[int], Any],
                 stop_replica: Callable[[str], None],
                 device_budget: int,
                 tp: int = 1, max_batch: int = 8,
                 slo_classes: Optional[Dict[str, Dict[str, Any]]] = None,
                 min_replicas: int = 1,
                 max_replicas: Optional[int] = None,
                 interval_s: Optional[float] = None,
                 cooldown_s: Optional[float] = None,
                 headroom: Optional[float] = None,
                 tokens_per_request: float = 8.0,
                 calibration: Optional[Dict[str, Any]] = None,
                 tp_degrees: Optional[Sequence[int]] = None,
                 max_batches: Optional[Sequence[int]] = None):
        self.router = router
        self.roofline = roofline
        self.spawn_replica = spawn_replica
        self.stop_replica = stop_replica
        self.device_budget = int(device_budget)
        self.tp = int(tp)
        self.max_batch = int(max_batch)
        self.slo_classes = slo_classes or parse_slo_classes()
        self.min_replicas = max(1, int(min_replicas))
        self.max_replicas = int(
            max_replicas if max_replicas is not None
            else _flags.env_flag("PADDLE_TPU_SERVE_AUTOSCALE_MAX_REPLICAS"))
        self.interval_s = float(
            interval_s if interval_s is not None
            else _flags.env_flag("PADDLE_TPU_SERVE_AUTOSCALE_INTERVAL_S"))
        self.cooldown_s = float(
            cooldown_s if cooldown_s is not None
            else _flags.env_flag("PADDLE_TPU_SERVE_AUTOSCALE_COOLDOWN_S"))
        self.headroom = headroom
        self.tokens_per_request = float(tokens_per_request)
        self.calibration = calibration
        self.tp_degrees = tuple(tp_degrees) if tp_degrees \
            else (self.tp,)
        self.max_batches = tuple(max_batches) if max_batches \
            else (self.max_batch,)
        self.decisions: List[Dict[str, Any]] = []
        self.current_plan: Optional[Dict[str, Any]] = None
        self.managed: Dict[str, Any] = {
            c.name: c for c in getattr(router, "clients", lambda: [])()
        } if hasattr(router, "clients") else {}
        if not self.managed:
            self.managed = {name: None
                            for name in router.replica_names()}
        self._next_index = len(self.managed)
        self._last_scale_mono = -math.inf
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the SLO-class table re-tunes the router's per-class behavior
        router.set_slo_classes(self.slo_classes)

    # -- bookkeeping ----------------------------------------------------

    def n_replicas(self) -> int:
        return len(self.managed)

    def _journal(self, action: str, *, to_replicas: int,
                 replica: Optional[str], reason: str,
                 decision: Optional[Dict[str, Any]] = None,
                 forecast: Optional[Dict[str, Any]] = None,
                 drained: Optional[bool] = None) -> Dict[str, Any]:
        pick = (decision or {}).get("pick") or {}
        predicted_attainment = {
            klass: c.get("predicted_attainment")
            for klass, c in (pick.get("by_class") or {}).items()
        } or None
        rec = {
            "time_unix": _profiler.span_clock_unix(),
            "action": action,
            "from_replicas": self.n_replicas(),
            "to_replicas": int(to_replicas),
            "replica": replica,
            "reason": reason,
            "inputs": {
                "forecast": {
                    "total_rate_upper_per_s":
                        (forecast or {}).get("total_rate_upper_per_s"),
                    "classes": {
                        k: {kk: c.get(kk) for kk in
                            ("rate_blend_per_s", "rate_upper_per_s",
                             "cv")}
                        for k, c in ((forecast or {}).get("classes")
                                     or {}).items()},
                    "backlog": (forecast or {}).get("backlog"),
                },
                "plan_spec": pick.get("spec"),
                "demand_tokens_per_sec":
                    (decision or {}).get("demand_tokens_per_sec"),
                "rejected_tally":
                    (decision or {}).get("rejected_tally"),
            },
            "predicted_slo_attainment": predicted_attainment,
            "realized_slo_attainment": None,
        }
        if drained is not None:
            rec["drained"] = bool(drained)
        self.decisions.append(rec)
        self.router.note_autoscale(plan=self.current_plan, decision=rec)
        _monitor.flight_record("serve_autoscale", action,
                               to_replicas=int(to_replicas),
                               replica=replica, reason=reason)
        _profiler.emit_instant(
            f"serve/scale/{action}", cat="serve_scale",
            meta={"action": action, "replica": replica,
                  "from_replicas": rec["from_replicas"],
                  "to_replicas": rec["to_replicas"],
                  "reason": reason})
        return rec

    # -- the loop body --------------------------------------------------

    def step(self) -> Optional[Dict[str, Any]]:
        """One autoscale tick: forecast -> decide -> move one replica
        toward the plan. Returns the decision record when an action
        (or plan change) was journaled, else None."""
        forecast = forecast_demand(self.router.telemetry.snapshot())
        cands = enumerate_configs(self.device_budget,
                                  tp_degrees=self.tp_degrees,
                                  max_batches=self.max_batches,
                                  min_replicas=self.min_replicas)
        scored = [score_config(c, self.roofline, self.calibration)
                  for c in cands]
        decision = decide(scored, forecast, self.slo_classes,
                          device_budget=self.device_budget,
                          tokens_per_request=self.tokens_per_request,
                          headroom=self.headroom)
        pick = decision.get("pick")
        if pick is None:
            # nothing feasible: hold at max (the least-bad execution of
            # an infeasible plan) and say why
            target = self.max_replicas
            plan_spec = None
        else:
            target = pick["axes"]["replicas"]
            plan_spec = pick["spec"]
        target = min(self.max_replicas, max(self.min_replicas, target))
        prev_spec = (self.current_plan or {}).get("spec")
        self.current_plan = {
            "spec": plan_spec,
            "target_replicas": target,
            "verdict": decision["verdict"],
            "demand_tokens_per_sec": decision["demand_tokens_per_sec"],
            "rejected_tally": decision["rejected_tally"],
            "time_unix": _profiler.span_clock_unix(),
        }
        # every tick's plan reaches the router journal — a flag-on
        # round that never scales still shows WHAT the planner decided
        self.router.note_autoscale(plan=self.current_plan)
        out: Optional[Dict[str, Any]] = None
        if pick is not None and plan_spec != prev_spec \
                and prev_spec is not None:
            non_replica_change = (
                pick["axes"]["tp"] != self.tp
                or pick["axes"]["max_batch"] != self.max_batch)
            out = self._journal(
                "plan_change", to_replicas=target, replica=None,
                reason=(f"plan {prev_spec} -> {plan_spec}"
                        + ("; tp/max_batch change needs a rolling "
                           "restart (not executed live)"
                           if non_replica_change else "")),
                decision=decision, forecast=forecast)
        now = time.monotonic()
        if now - self._last_scale_mono < self.cooldown_s:
            return out
        current = self.n_replicas()
        if target > current:
            out = self._scale_up(decision, forecast, target)
        elif target < current:
            out = self._scale_down(decision, forecast, target)
        return out

    def _scale_up(self, decision, forecast, target) -> Dict[str, Any]:
        index = self._next_index
        rec = self._journal(
            "scale_up", to_replicas=self.n_replicas() + 1,
            replica=f"replica{index}",
            reason=(f"demand {decision['demand_tokens_per_sec']} tok/s "
                    f"needs {target} replica(s)"),
            decision=decision, forecast=forecast)
        t0 = time.perf_counter()
        client = self.spawn_replica(index)
        rec["boot_seconds"] = round(time.perf_counter() - t0, 3)
        rec["replica"] = client.name
        self.router.add_replica(client)
        self.managed[client.name] = client
        self._next_index += 1
        self._last_scale_mono = time.monotonic()
        return rec

    def _scale_down(self, decision, forecast, target) -> Dict[str, Any]:
        # newest managed replica goes first (LIFO keeps replica0, the
        # anchor every round boots with, serving)
        name = list(self.managed)[-1]
        self._journal(
            "drain_start", to_replicas=self.n_replicas(),
            replica=name,
            reason=(f"demand {decision['demand_tokens_per_sec']} tok/s "
                    f"fits {target} replica(s); draining before "
                    f"take-down"),
            decision=decision, forecast=forecast)
        drained = self.router.drain_replica(name)
        rec = self._journal(
            "scale_down", to_replicas=self.n_replicas() - 1,
            replica=name, reason="drained take-down" if drained
            else "drain timed out; taking down anyway",
            decision=decision, forecast=forecast, drained=drained)
        self.stop_replica(name)
        self.router.remove_replica(name)
        self.managed.pop(name, None)
        self._last_scale_mono = time.monotonic()
        return rec

    # -- realized attainment (the honesty back-fill) --------------------

    def finalize(self, records: Sequence[Dict[str, Any]]
                 ) -> Dict[str, Any]:
        """Back-fill every journaled decision's realized per-class SLO
        attainment from the round's dispatch records (each decision
        sees the records submitted AFTER it, up to the next decision)
        and return the round-level attainment summary."""
        overall = slo_attainment(records, self.slo_classes)
        times = [d["time_unix"] for d in self.decisions]
        for i, dec in enumerate(self.decisions):
            t0 = times[i]
            t1 = times[i + 1] if i + 1 < len(times) else math.inf
            window = [r for r in records
                      if t0 <= float(r.get("time_unix") or 0) < t1]
            if window:
                att = slo_attainment(window, self.slo_classes)
                dec["realized_slo_attainment"] = {
                    klass: c.get("attainment")
                    for klass, c in att["by_class"].items()}
        self.router.note_autoscale(plan=self.current_plan,
                                   decisions=self.decisions)
        return overall

    # -- background loop -------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.step()
                except Exception:
                    # the autoscaler must outlive any one bad tick; the
                    # flight record carries the why
                    _monitor.flight_record("serve_autoscale",
                                           "step_error")

        self._thread = threading.Thread(
            target=loop, name="serve-autoscaler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
