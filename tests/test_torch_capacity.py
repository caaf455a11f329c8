"""The port's capacity planner (``serving/capacity.py``) and its planner
subset (``planner.py``) against the JAX package's, and the autoscaler's
act path over stub replicas.

Every pure function gives the same output on the same inputs in both
packages (or raises the same error), one case each. The autoscaler
cases are the JAX package's (``tests/test_autoscale.py``) on the port:
drain before stop on a scale-down, cooldown gating, and the realized
attainment back-fill; then both packages' autoscalers over the same
stubs journal the same decisions.
"""
import torch_threads  # noqa: F401 (one torch thread a worker)
import json
import math

import pytest

from paddle_tpu import planner as jplanner
from paddle_tpu.serving import capacity as jcapacity
from paddle_tpu.serving import ledger as jledger
from paddle_tpu.serving import router as jrt
from paddle_tpu_torch import planner
from paddle_tpu_torch.serving import capacity
from paddle_tpu_torch.serving import ledger as serving_ledger
from paddle_tpu_torch.serving import router as rt


@pytest.fixture(autouse=True)
def _fresh_ledger():
    serving_ledger.reset()
    jledger.reset()
    yield
    serving_ledger.reset()
    jledger.reset()


_ROOF = {"legs": {"compute_s": 2e-4, "memory_s": 1e-3, "dispatch_s": 1e-5},
         "mean_active": 4.0, "bound_by": "memory_s",
         "tick_seconds_floor": 1e-3, "program": "abc"}
_SLO_SPEC = "interactive:slo=3,weight=3,hedge=1;batch:slo=30,weight=1"
_TRAFFIC = {
    "horizons_s": [1.0, 10.0, 60.0],
    "classes": {
        "interactive": {"n": 40, "rate_ema": {"1s": 20.0, "10s": 12.0,
                                              "60s": None},
                        "interarrival": {"cv": 1.7}},
        "batch": {"n": 3, "rate_ema": {"1s": 0.5, "10s": 0.2, "60s": 0.1},
                  "interarrival": {"cv": None}},
    },
    "depth_summary": {"queued_mean": 1.5, "queued_max": 4},
    "series": [{"time_unix": 1.0, "queued": 2, "inflight": 3}],
}
_CALIB = {"tokens_per_sec": {"correction_factor": 0.5, "by_config": {
    "r1/tp1/mb8": {"correction_factor": 0.25}}}}
_HISTORY = [
    ("SERVE_r01.json", {"parsed": {
        "engine": {"replicas": 1, "max_batch": 8},
        "reconciliations": {"measured_vs_roofline": {
            "predicted_tokens_per_sec": 1000.0,
            "measured_tokens_per_sec": 400.0}}}}),
    ("SERVE_r02.json", {
        "engine": {"replicas": 2, "max_batch": 4},
        "autoscale": {"calibration_pair": {
            "config": "r2/tp1/mb4",
            "predicted_tokens_per_sec_per_replica": 300.0,
            "measured_tokens_per_sec_per_replica": 240.0}}}),
    ("SERVE_r03.json", {"parsed": {"engine": {"max_batch": 8}}}),
]
_RECORDS = [
    {"traffic_class": "interactive", "ok": True, "latency_s": 0.5},
    {"traffic_class": "interactive", "ok": True, "latency_s": 4.0},
    {"traffic_class": "batch", "ok": False, "latency_s": 1.0},
    {"traffic_class": "batch", "ok": True, "latency_s": 10.0},
    {"ok": True, "latency_s": 1.0, "deadline_s": 2.0},
]


def _scored(mod):
    return [mod.score_config(c, _ROOF, _CALIB)
            for c in mod.enumerate_configs(4, tp_degrees=(1, 2),
                                           max_batches=(4, 8))]


def _decide(mod, **kw):
    return mod.decide(_scored(mod), mod.forecast_demand(_TRAFFIC),
                      mod.parse_slo_classes(_SLO_SPEC), device_budget=3,
                      **kw)


# (name, call(mod)): each run on both packages' capacity modules
_CASES = [
    ("parse_slo_classes", lambda m: m.parse_slo_classes(_SLO_SPEC)),
    ("parse_slo_classes_default", lambda m: m.parse_slo_classes()),
    ("parse_slo_classes_hedge_off",
     lambda m: m.parse_slo_classes("a:slo=1,hedge=off;b:slo=2,weight=4")),
    ("parse_slo_classes_no_colon", lambda m: m.parse_slo_classes("a")),
    ("parse_slo_classes_unknown_key",
     lambda m: m.parse_slo_classes("a:slo=1,color=red")),
    ("parse_slo_classes_no_slo", lambda m: m.parse_slo_classes("a:weight=1")),
    ("parse_slo_classes_empty", lambda m: m.parse_slo_classes(" ; ")),
    ("forecast_demand", lambda m: m.forecast_demand(_TRAFFIC)),
    ("forecast_demand_widen0",
     lambda m: m.forecast_demand(_TRAFFIC, cv_widen=0.0)),
    ("forecast_demand_none", lambda m: m.forecast_demand(None)),
    ("enumerate_configs",
     lambda m: m.enumerate_configs(4, tp_degrees=(1, 2, 8),
                                   max_batches=(16, 4, 4))),
    ("enumerate_configs_min2",
     lambda m: m.enumerate_configs(3, min_replicas=2)),
    ("score_config_uncalibrated",
     lambda m: [m.score_config(c, _ROOF) for c in m.enumerate_configs(2)]),
    ("score_config_calibrated", lambda m: _scored(m)),
    ("score_config_no_legs",
     lambda m: m.score_config(m.enumerate_configs(1)[0], {})),
    ("decide", lambda m: _decide(m)),
    ("decide_headroom_top1", lambda m: _decide(m, headroom=0.6, top_k=1)),
    ("decide_tight_slo",
     lambda m: m.decide(_scored(m), m.forecast_demand(_TRAFFIC),
                        m.parse_slo_classes("x:slo=0.01"),
                        device_budget=4, tokens_per_request=64.0)),
    ("decide_under_capacity",
     lambda m: m.decide(_scored(m), m.forecast_demand(_TRAFFIC),
                        m.parse_slo_classes(_SLO_SPEC), device_budget=2,
                        tokens_per_request=5000.0)),
    ("plan", lambda m: m.plan(_TRAFFIC, _ROOF, device_budget=2,
                              slo_classes=m.parse_slo_classes(_SLO_SPEC))),
    ("render_plan_text",
     lambda m: m.render_plan_text(m.plan(
         _TRAFFIC, _ROOF, device_budget=4,
         slo_classes=m.parse_slo_classes(_SLO_SPEC)))),
    ("render_plan_text_infeasible",
     lambda m: m.render_plan_text(m.plan(
         _TRAFFIC, _ROOF, device_budget=1, tokens_per_request=1e6,
         slo_classes=m.parse_slo_classes(_SLO_SPEC)))),
    ("extract_traffic_raw", lambda m: m.extract_traffic(_TRAFFIC)),
    ("extract_traffic_ledger",
     lambda m: m.extract_traffic({"traffic": _TRAFFIC})),
    ("extract_traffic_round",
     lambda m: m.extract_traffic({"parsed": {"traffic_telemetry":
                                             _TRAFFIC}})),
    ("extract_traffic_none", lambda m: m.extract_traffic({"x": 1})),
    ("calibration_pairs_from_serve_history",
     lambda m: m.calibration_pairs_from_serve_history(_HISTORY)),
    ("calibrate_capacity",
     lambda m: m.calibrate_capacity(
         m.calibration_pairs_from_serve_history(_HISTORY))),
    ("oracle_schedule",
     lambda m: m.oracle_schedule([(0.5, 100.0), (1.2, 900.0), (3.9, 50.0)],
                                 capacity_tokens_per_sec=200.0,
                                 window_s=1.0, max_replicas=3)),
    ("oracle_schedule_horizon",
     lambda m: m.oracle_schedule([(0.1, 10.0)],
                                 capacity_tokens_per_sec=5.0, window_s=2.0,
                                 max_replicas=1, min_replicas=1,
                                 horizon_s=9.0)),
    ("oracle_schedule_bad_capacity",
     lambda m: m.oracle_schedule([], capacity_tokens_per_sec=0.0,
                                 window_s=1.0, max_replicas=1)),
    ("schedule_windows",
     lambda m: m.schedule_windows([(0.5, 2), (2.25, 1), (3.0, 3)],
                                  horizon_s=4.0, window_s=1.0,
                                  initial_replicas=1)),
    ("schedule_windows_bad_window",
     lambda m: m.schedule_windows([], 1.0, 0.0, 1)),
    ("scale_regret",
     lambda m: m.scale_regret([1, 2, 2, 3], m.oracle_schedule(
         [(0.5, 100.0), (1.2, 900.0), (3.9, 50.0)],
         capacity_tokens_per_sec=200.0, window_s=1.0, max_replicas=3))),
    ("scale_regret_length_mismatch",
     lambda m: m.scale_regret([1], m.oracle_schedule(
         [(2.5, 10.0)], capacity_tokens_per_sec=5.0, window_s=1.0,
         max_replicas=2))),
    ("slo_attainment",
     lambda m: m.slo_attainment(_RECORDS, m.parse_slo_classes(_SLO_SPEC))),
    ("slo_attainment_empty", lambda m: m.slo_attainment([], {})),
]


def _outcome(fn, mod):
    try:
        return "ok", json.loads(json.dumps(fn(mod)))
    except Exception as e:  # the same error, typed and worded, counts
        return "raised", type(e).__name__, str(e)


@pytest.mark.parametrize("name,fn", _CASES, ids=[c[0] for c in _CASES])
def test_capacity_function_matches_the_reference(name, fn):
    assert _outcome(fn, capacity) == _outcome(fn, jcapacity)


def _write_rounds(tmp_path):
    for name, doc in _HISTORY + [("SERVE_rx.json", {}),
                                 ("BENCH_r07.json", {"step_seconds": 1.0})]:
        (tmp_path / name).write_text(json.dumps(doc))
    (tmp_path / "SERVE_r10.json").write_text("{torn")
    return str(tmp_path)


def test_load_serve_history_matches_the_reference(tmp_path):
    d = _write_rounds(tmp_path)
    got = capacity.load_serve_history(d)
    assert got == jcapacity.load_serve_history(d)
    assert [name for name, _ in got] == ["SERVE_r01.json", "SERVE_r02.json",
                                         "SERVE_r03.json"]
    assert capacity.plan(_TRAFFIC, _ROOF, device_budget=2, history_dir=d) \
        == jcapacity.plan(_TRAFFIC, _ROOF, device_budget=2, history_dir=d)


def test_planner_load_round_history_matches_the_reference(tmp_path):
    d = _write_rounds(tmp_path)
    for patterns in (("SERVE_r*.json",), ("BENCH_r*.json", "SERVE_r*.json"),
                     ("NONE_r*.json",)):
        assert planner.load_round_history(d, patterns=patterns) == \
            jplanner.load_round_history(d, patterns=patterns)


@pytest.mark.parametrize("pairs,kw", [
    ({"tokens_per_sec": []}, {}),
    ({"m": [{"ratio": 1.5, "config": "a"}, {"ratio": 0.5, "config": "b"},
            {"ratio": 1.1, "config": "a"}]}, {"max_pairs_kept": 2}),
    ({"m": [{"ratio": 2.0, "config": None}]},
     {"link_class_bandwidth": {"ici": {"bus_bytes_per_sec": 1e9}}}),
], ids=["empty", "by_config", "link_classes"])
def test_planner_calibrate_matches_the_reference(pairs, kw):
    assert planner.calibrate(pairs, **kw) == jplanner.calibrate(pairs, **kw)


# -- the autoscaler's act path, over stubs ----------------------------------


class DrainableStub:
    """Replica stub whose healthz reports the drained flag the router's
    drain_replica polls for."""

    def __init__(self, name):
        self.name = name
        self.draining = False
        self.submits = 0

    def submit(self, prompt, max_new_tokens, deadline_s, request_id,
               timeout, trace=None):
        self.submits += 1
        return {"tokens": [1] * max_new_tokens, "cached": False}

    def drain(self, timeout=1.0):
        self.draining = True
        return {"draining": True}

    def healthz(self, timeout=1.0):
        return {"status": "ok",
                "serving": {"draining": self.draining,
                            "drained": self.draining, "queued": 0}}


class TelemetryStub:
    """Canned TrafficTelemetry.snapshot(): the step under test sees
    exactly the demand the test scripted."""

    def __init__(self):
        self.traffic = {}

    def snapshot(self):
        return self.traffic

    def note_arrival(self, klass, now=None):
        pass

    def note_depth(self, *a, **k):
        pass


_AUTO_ROOF = {"legs": {"compute_s": 2e-4, "memory_s": 1e-3,
                       "dispatch_s": 1e-5}, "mean_active": 4.0}


def _traffic(rate_per_s):
    return {"horizons_s": [1.0],
            "classes": {"interactive": {
                "n": 100, "rate_ema": {"1s": float(rate_per_s)},
                "interarrival": {"cv": 1.0}}}}


def _mk(cap_mod, router, spawned, stopped, events=None, **overrides):
    def _spawn(index):
        c = DrainableStub(f"replica{index}")
        spawned.append(c)
        return c

    def _stop(name):
        if events is not None:
            events.append(("stop", name,
                           router.replica_state(name)))
        stopped.append(name)

    kw = dict(device_budget=2, tp=1, max_batch=4,
              slo_classes=cap_mod.parse_slo_classes(_SLO_SPEC),
              min_replicas=1, max_replicas=2, interval_s=0.1,
              cooldown_s=0.0, headroom=0.15, tokens_per_request=8.0,
              tp_degrees=(1,), max_batches=(4,))
    kw.update(overrides)
    return cap_mod.Autoscaler(router, _AUTO_ROOF, spawn_replica=_spawn,
                              stop_replica=_stop, **kw)


def _router(rt_mod):
    router = rt_mod.Router([DrainableStub("replica0")], retries=1,
                           backoff_ms=1.0, hedge_ms=0.0, default_slo_s=5.0,
                           seed=0)
    router.telemetry = TelemetryStub()
    return router


def test_scale_down_drains_before_stopping():
    """On a scale-down the drain is journaled and completed before
    stop_replica fires, and the decision trail rides the router's
    ledger."""
    router = _router(rt)
    spawned, stopped, events = [], [], []
    try:
        auto = _mk(capacity, router, spawned, stopped, events)
        router.telemetry.traffic = _traffic(500.0)
        rec_up = auto.step()
        assert rec_up and rec_up["action"] == "scale_up", rec_up
        assert auto.n_replicas() == 2 and not stopped
        router.telemetry.traffic = _traffic(10.0)
        rec_down = auto.step()
        assert rec_down["action"] == "scale_down", rec_down
        actions = [d["action"] for d in auto.decisions]
        assert actions[actions.index("scale_down") - 1] == "drain_start"
        assert rec_down["drained"] is True
        # when stop fired, the replica had drained and was out of rotation
        assert events == [("stop", "replica1", rt.DRAINING)]
        assert spawned[0].draining and stopped == ["replica1"]
        assert router.replica_names() == ["replica0"]
        auto_doc = router.ledger_doc()["autoscale"]
        assert {d["action"] for d in auto_doc["decisions"]} >= {
            "scale_up", "drain_start", "scale_down"}
        assert auto_doc["plan"]["spec"] == "r1/tp1/mb4"
    finally:
        router.stop()


def test_cooldown_gates_consecutive_scales():
    router = _router(rt)
    spawned, stopped = [], []
    try:
        auto = _mk(capacity, router, spawned, stopped, cooldown_s=120.0)
        router.telemetry.traffic = _traffic(500.0)
        assert auto.step()["action"] == "scale_up"
        router.telemetry.traffic = _traffic(10.0)
        assert auto.step() is None  # cooling down: no action
        assert auto.n_replicas() == 2 and not stopped
        auto._last_scale_mono = -math.inf  # cooldown elapsed
        assert auto.step()["action"] == "scale_down"
        assert stopped == ["replica1"]
    finally:
        router.stop()


def test_finalize_backfills_realized_attainment():
    router = _router(rt)
    try:
        auto = _mk(capacity, router, [], [])
        router.telemetry.traffic = _traffic(500.0)
        auto.step()
        router.telemetry.traffic = _traffic(10.0)
        auto.step()
        t_up = auto.decisions[0]["time_unix"]
        t_down = auto.decisions[-1]["time_unix"]
        mid = (t_up + t_down) / 2.0
        recs = [
            {"traffic_class": "interactive", "ok": True, "latency_s": 0.5,
             "time_unix": mid},
            {"traffic_class": "interactive", "ok": True, "latency_s": 10.0,
             "time_unix": mid},
            {"traffic_class": "interactive", "ok": True, "latency_s": 0.4,
             "time_unix": t_down + 1.0},
        ]
        overall = auto.finalize(recs)
        assert auto.decisions[0]["realized_slo_attainment"][
            "interactive"] == 0.5
        assert auto.decisions[-1]["realized_slo_attainment"][
            "interactive"] == 1.0
        assert overall["overall"] == pytest.approx(2.0 / 3.0, abs=1e-3)
    finally:
        router.stop()


def _journal(cap_mod, rt_mod):
    """Both packages' autoscalers through the same scripted demand: the
    journaled decisions without their clocks."""
    router = _router(rt_mod)
    spawned, stopped = [], []
    try:
        auto = _mk(cap_mod, router, spawned, stopped)
        for rate in (500.0, 500.0, 10.0, 10.0, 200.0):
            router.telemetry.traffic = _traffic(rate)
            auto.step()
        out = []
        for d in auto.decisions:
            d = {k: v for k, v in d.items()
                 if k not in ("time_unix", "boot_seconds")}
            out.append(json.loads(json.dumps(d)))
        plan = {k: v for k, v in auto.current_plan.items()
                if k != "time_unix"}
        return out, plan, stopped, router.replica_names()
    finally:
        router.stop()


def test_autoscaler_journal_matches_the_reference():
    assert _journal(capacity, rt) == _journal(jcapacity, jrt)
