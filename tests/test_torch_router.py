"""The serving front tier (``paddle_tpu_torch/serving/router.py``) on the
port's engines, and against the JAX package's router.

The first part is the JAX package's router suite (``tests/test_router.py``),
case for case, on the port's engines at the tiny config on the CPU:
backoff/jitter bounds, least-loaded selection, re-dispatch after a
replica's death with the bit-match contract, hedging only when the SLO
is at risk (per traffic class), draining, engine-side idempotency and
the serving chaos sites. Replica death is simulated at the transport (a
client wrapper that raises typed Unavailable once killed).

The second part holds the two packages against each other: the
reference Router over reference engines and the port's Router over the
port's engines, on the same numpy parameters, give the same tokens for
one request stream, the same health-event sequence when a replica dies,
and the same ``backoff_delay_s`` over a grid.
"""
import torch_threads  # noqa: F401 (one torch thread a worker)
import time

import numpy as np
import pytest

from paddle_tpu import chaos as jchaos
from paddle_tpu import serving as jserving
from paddle_tpu.framework import errors as _jerrs
from paddle_tpu.serving import ledger as jledger
from paddle_tpu.serving import router as jrt
from paddle_tpu_torch import chaos, monitor, serving
from paddle_tpu_torch.framework import errors as _errs
from paddle_tpu_torch.serving import ledger as serving_ledger
from paddle_tpu_torch.serving import router as rt
from test_torch_serving_model import rich_params

_CFG = dict(vocab_size=128, n_layer=2, n_head=2, d_model=32, max_seq_len=64)
_ENV = dict(max_batch=4, n_blocks=16, block_size=8, prefill_buckets=[16, 32])


@pytest.fixture(scope="module")
def tiny_model():
    cfg = serving.GPTConfig(vocab_size=128, n_layer=2, n_head=2,
                            d_model=32, max_seq_len=64)
    return serving.DecodeModel(cfg, max_batch=4, n_blocks=16,
                               block_size=8, prefill_buckets=[16, 32],
                               seed=1, device="cpu")


def _twin_engine(tiny_model):
    """A second engine over the SAME model (identical params:
    the cross-replica bit-match ground truth). Separate engine state —
    separate pages, allocator, queue — so it behaves as a replica."""
    return serving.ServingEngine(tiny_model)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_CHAOS_SITES", raising=False)
    monkeypatch.delenv("PADDLE_TPU_CHAOS_SEED", raising=False)
    chaos.reset()
    jchaos.reset()
    serving_ledger.reset()
    jledger.reset()
    yield
    chaos.reset()
    jchaos.reset()
    serving_ledger.reset()
    jledger.reset()


class KillableReplica(rt.LocalReplica):
    """LocalReplica with a kill switch: once dead, every call raises
    typed Unavailable (reason=connect) — the wire shape of a replica
    process that just died."""

    def __init__(self, name, engine):
        super().__init__(name, engine)
        self.alive = True

    def _die(self):
        e = _errs.errors.Unavailable(f"{self.name} is dead")
        e.reason = "connect"
        raise e

    def submit(self, *a, **kw):
        if not self.alive:
            self._die()
        return super().submit(*a, **kw)

    def healthz(self, timeout=1.0):
        if not self.alive:
            self._die()
        return super().healthz(timeout)


class SlowReplica(KillableReplica):
    """Submit sleeps before delegating — the wedged replica hedging
    exists for."""

    def __init__(self, name, engine, delay_s):
        super().__init__(name, engine)
        self.delay_s = delay_s

    def submit(self, *a, **kw):
        time.sleep(self.delay_s)
        return super().submit(*a, **kw)


# -- backoff ----------------------------------------------------------------


def test_backoff_bounds_and_determinism():
    """Attempt k's delay sits in [base*2^k/2, base*2^k) (ms->s), is
    identical for the same (seed, request_id, attempt), differs across
    request_ids, and caps at 2000ms."""
    base = 100.0
    for k in range(5):
        raw = min(2000.0, base * 2.0 ** k) / 1e3
        d = rt.backoff_delay_s(k, "req-A", base_ms=base, seed=7)
        assert raw / 2.0 <= d < raw, (k, d, raw)
        assert d == rt.backoff_delay_s(k, "req-A", base_ms=base, seed=7)
    assert rt.backoff_delay_s(2, "req-A", base_ms=base, seed=7) != \
        rt.backoff_delay_s(2, "req-B", base_ms=base, seed=7)
    # the cap binds: attempt 10 raw would be 102400ms
    d10 = rt.backoff_delay_s(10, "req-A", base_ms=base, seed=7)
    assert 1.0 <= d10 < 2.0


def test_backoff_env_default(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_SERVE_BACKOFF_MS", "20")
    d = rt.backoff_delay_s(0, "r")
    assert 0.010 <= d < 0.020


# -- selection --------------------------------------------------------------


def test_least_loaded_pick_and_exclusions(tiny_model):
    ea, eb, ec = (_twin_engine(tiny_model) for _ in range(3))
    router = rt.Router([rt.LocalReplica("a", ea),
                        rt.LocalReplica("b", eb),
                        rt.LocalReplica("c", ec)],
                       retries=0, hedge_ms=0)
    try:
        router._reps["a"].inflight = 2
        router._reps["b"].last_queued = 1
        assert router._pick().name == "c"
        router._reps["c"].state = rt.DRAINING
        assert router._pick().name == "b"
        router._reps["b"].state = rt.DEAD
        assert router._pick().name == "a"
        # a retry prefers a replica it has not failed on
        router._reps["b"].state = rt.HEALTHY
        assert router._pick(prefer_not="b").name == "a"
        router._reps["a"].state = rt.DEAD
        # ...but takes the failed one over nothing
        assert router._pick(prefer_not="b").name == "b"
        router._reps["b"].state = rt.DEAD
        router._reps["c"].state = rt.DEAD
        assert router._pick() is None
    finally:
        router.stop()


# -- failover + the bit-match contract --------------------------------------


def test_redispatch_after_replica_death_bit_matches(tiny_model):
    """The acceptance contract: a request replayed on a second replica
    after its first replica died produces the SAME greedy tokens, under
    the SAME request_id, with the first failure typed."""
    ea, eb = _twin_engine(tiny_model), _twin_engine(tiny_model)
    ea.start()
    eb.start()
    a = KillableReplica("a", ea)
    b = KillableReplica("b", eb)
    router = rt.Router([a, b], retries=2, backoff_ms=2.0, hedge_ms=0,
                       default_slo_s=30.0, seed=5)
    try:
        prompt = [3, 9, 11, 2]
        # reference tokens from replica b directly (same params)
        reference = eb.generate(prompt, max_new_tokens=5)
        a_load = router._reps["a"]
        a_load.last_queued = 0
        router._reps["b"].last_queued = 1  # steer the first pick to a
        a.alive = False  # ...which is dead
        rec = router.dispatch(prompt, max_new_tokens=5,
                              request_id="rd-1")
        assert rec["ok"] and rec["failover"], rec
        assert rec["n_attempts"] == 2, rec
        assert rec["attempts"][0]["replica"] == "a"
        assert rec["attempts"][0]["error_type"] == "UnavailableError"
        assert rec["attempts"][0]["reason"] == "connect"
        assert rec["replica"] == "b"
        assert rec["tokens"] == reference  # the bit-match contract
        assert router.replica_state("a") == rt.DEAD  # typed detection
        assert router.snapshot()["stats"]["retries"] == 1
        assert router.snapshot()["stats"]["failovers"] == 1
        # the dead replica coming back rejoins via the health sweep
        a.alive = True
        router.probe_once()
        assert router.replica_state("a") == rt.HEALTHY
        transitions = [(e["from"], e["to"])
                       for e in router.health_events
                       if e["replica"] == "a"]
        assert ("healthy", "dead") in transitions
        assert ("dead", "healthy") in transitions
    finally:
        router.stop()
        ea.stop(flush=False)
        eb.stop(flush=False)


def test_no_healthy_replica_fails_typed(tiny_model):
    ea = _twin_engine(tiny_model)
    a = KillableReplica("a", ea)
    a.alive = False
    router = rt.Router([a], retries=1, backoff_ms=1.0, hedge_ms=0,
                       default_slo_s=5.0)
    try:
        rec = router.dispatch([1, 2], max_new_tokens=2)
        assert not rec["ok"]
        assert rec["error_type"] == "UnavailableError"
        # after the first connect failure the replica is DEAD, so the
        # retry records a typed no_replica attempt — never a hang
        reasons = [at.get("reason") for at in rec["attempts"]]
        assert reasons == ["connect", "no_replica"], rec
    finally:
        router.stop()


# -- hedging ----------------------------------------------------------------


def test_hedge_fires_only_when_slo_at_risk(tiny_model):
    """A slow primary alone does not hedge: the hedge window must pass
    AND the SLO must be at risk (remaining budget below the latency
    EMA). Both branches pinned."""
    ea, eb = _twin_engine(tiny_model), _twin_engine(tiny_model)
    ea.start()
    eb.start()
    slow = SlowReplica("slow", ea, delay_s=0.25)
    fast = rt.LocalReplica("fast", eb)
    router = rt.Router([slow, fast], retries=0, backoff_ms=1.0,
                       hedge_ms=30.0, default_slo_s=120.0, seed=2)
    try:
        router._reps["fast"].last_queued = 5  # steer primary to slow
        # plenty of budget (120s SLO, no EMA): no hedge despite the
        # 0.25s stall
        rec = router.dispatch([5, 6, 7], max_new_tokens=3,
                              request_id="h-safe")
        assert rec["ok"] and not rec["hedged"], rec
        assert router.snapshot()["stats"]["hedges"] == 0
        # now the EMA says a request needs ~10s: a 0.5s budget is at
        # risk the moment the hedge window passes
        router._latency_ema["default"] = 10.0
        rec2 = router.dispatch([5, 6, 7], max_new_tokens=3,
                               deadline_s=0.8, request_id="h-risk")
        router.wait_hedges()
        snap = router.snapshot()
        assert snap["stats"]["hedges"] == 1, snap
        assert rec2["ok"], rec2
        assert rec2["hedged"], rec2
        # both replicas eventually answered with identical params: the
        # bit-match audit saw no mismatch (the hedge loser may need a
        # beat to be harvested)
        assert snap["stats"]["bitmatch_mismatch"] == 0
        assert snap["stats"]["bitmatch_checked"] >= 1
    finally:
        router.stop()
        ea.stop(flush=False)
        eb.stop(flush=False)


def test_hedge_ema_is_per_traffic_class(tiny_model):
    """The SLO-at-risk test reads THIS class's completed-latency EMA,
    both directions: a batch tenant's pessimistic EMA must not trip
    hedges for interactive requests riding the same router, and the
    interactive stream's healthy EMA must not suppress the hedge the
    batch class needs."""
    ea, eb = _twin_engine(tiny_model), _twin_engine(tiny_model)
    ea.start()
    eb.start()
    slow = SlowReplica("slow", ea, delay_s=0.25)
    fast = rt.LocalReplica("fast", eb)
    router = rt.Router([slow, fast], retries=0, backoff_ms=1.0,
                       hedge_ms=30.0, default_slo_s=120.0, seed=3)
    try:
        # batch completions are slow (10s EMA), interactive ones fast
        router._latency_ema["batch"] = 10.0
        router._latency_ema["interactive"] = 0.001
        # direction 1: an interactive request with comfortable budget
        # does NOT hedge — batch's 10s EMA is not consulted
        router._reps["fast"].last_queued = 5  # steer primary to slow
        rec = router.dispatch([5, 6, 7], max_new_tokens=3,
                              deadline_s=30.0, request_id="cls-int",
                              traffic_class="interactive")
        router.wait_hedges()
        assert rec["ok"] and not rec["hedged"], rec
        assert router.snapshot()["stats"]["hedges"] == 0
        # direction 2: a batch request with the same budget DOES hedge —
        # its own 10s EMA says 0.8s of budget is at risk, and the
        # interactive class's 1ms EMA must not mask that
        router._reps["fast"].last_queued = 5
        rec2 = router.dispatch([5, 6, 7], max_new_tokens=3,
                               deadline_s=0.8, request_id="cls-bat",
                               traffic_class="batch")
        router.wait_hedges()
        snap = router.snapshot()
        assert rec2["ok"] and rec2["hedged"], rec2
        assert snap["stats"]["hedges"] == 1, snap
        # completed latencies fed back under their own class keys
        assert router._latency_ema["interactive"] < 1.0
        assert router._latency_ema["batch"] > 1.0
    finally:
        router.stop()
        ea.stop(flush=False)
        eb.stop(flush=False)


# -- draining ---------------------------------------------------------------


def test_draining_completes_admitted_work(tiny_model):
    """Drain contract: accepted work (queued AND in-slot) retires,
    new submissions bounce typed, the router routes around, and
    drained() flips once idle."""
    ea, eb = _twin_engine(tiny_model), _twin_engine(tiny_model)
    ea.start()
    eb.start()
    router = rt.Router([rt.LocalReplica("a", ea),
                        rt.LocalReplica("b", eb)],
                       retries=1, backoff_ms=1.0, hedge_ms=0,
                       default_slo_s=30.0)
    try:
        handles = [ea.submit([2 + i, 5], max_new_tokens=6)
                   for i in range(6)]  # > max_batch: some stay queued
        assert router.drain_replica("a", timeout_s=20.0)
        for h in handles:
            assert h.result(timeout=10)  # admitted work completed
        assert ea.drained()
        with pytest.raises(_errs.errors.Unavailable):
            ea.submit([1, 2], max_new_tokens=2)
        rec = router.dispatch([1, 2, 3], max_new_tokens=2)
        assert rec["ok"] and rec["replica"] == "b", rec
        assert router.replica_state("a") == rt.DRAINING
        # a cancelled take-down re-opens admission
        ea.undrain()
        router.probe_once()
        assert router.replica_state("a") == rt.HEALTHY
    finally:
        router.stop()
        ea.stop(flush=False)
        eb.stop(flush=False)


# -- engine-side idempotency ------------------------------------------------


def test_engine_idempotent_redispatch(tiny_model):
    """The engine half of idempotent re-dispatch: a completed
    request_id replays from the cache (same tokens, no recompute), an
    in-flight duplicate joins the live request, and a FAILED id stays
    retryable."""
    eng = _twin_engine(tiny_model)
    h1 = eng.submit([7, 8, 9], max_new_tokens=4, request_id="idem-1")
    eng.run_until_idle()
    toks = h1.result(timeout=10)
    seen = eng.requests_seen
    h2 = eng.submit([7, 8, 9], max_new_tokens=4, request_id="idem-1")
    assert h2.cached and h2.result(timeout=1) == toks
    assert eng.requests_seen == seen  # no new work enqueued
    # concurrent duplicate joins the SAME live request
    h3 = eng.submit([1, 2, 3], max_new_tokens=3, request_id="idem-2")
    h4 = eng.submit([1, 2, 3], max_new_tokens=3, request_id="idem-2")
    assert h4._req is h3._req
    eng.run_until_idle()
    assert h3.result(timeout=10) == h4.result(timeout=10)
    # failures are not cached answers
    hf = eng.submit(list(range(40)), max_new_tokens=2,
                    request_id="idem-3")  # exceeds the largest bucket
    eng.run_until_idle()
    with pytest.raises(Exception):
        hf.result(timeout=10)
    assert eng._idempotent_handle("idem-3") is None


# -- serving chaos sites ----------------------------------------------------


def _counter_total(name, label=None, value=None):
    fam = monitor.snapshot().get("metrics", {}).get(name, {})
    total = 0.0
    for s in fam.get("series", []):
        if label and s.get("labels", {}).get(label) != value:
            continue
        total += float(s.get("value", 0.0))
    return total


def test_admit_error_site_deterministic_at_engine(tiny_model,
                                                  monkeypatch):
    """admit_error@rate fails admitted requests typed — and the SAME
    spec+seed fails the SAME requests (the deterministic-replay
    contract)."""
    def run_round():
        chaos.reset()
        eng = _twin_engine(tiny_model)
        handles = [eng.submit([4 + i, 2], max_new_tokens=2,
                              request_id=f"ae-{i}") for i in range(8)]
        eng.run_until_idle()
        out = []
        for h in handles:
            try:
                h.result(timeout=10)
                out.append("ok")
            except _errs.errors.Unavailable:
                out.append("chaos")
        return out

    monkeypatch.setenv("PADDLE_TPU_CHAOS_SITES", "admit_error@rate=0.5")
    monkeypatch.setenv("PADDLE_TPU_CHAOS_SEED", "11")
    first = run_round()
    assert "chaos" in first and "ok" in first, first
    assert run_round() == first  # same seed, same faults
    monkeypatch.setenv("PADDLE_TPU_CHAOS_SEED", "13")
    assert run_round() != first  # a new seed is a new fault schedule


def test_admit_error_site_at_router_dispatch(tiny_model, monkeypatch):
    """The router checks the same site at dispatch: an injected front-
    door fault consumes an attempt and the retry absorbs it."""
    monkeypatch.setenv("PADDLE_TPU_CHAOS_SITES",
                       "admit_error@rate=1.0:times=1")
    chaos.reset()
    eng = _twin_engine(tiny_model)
    eng.start()
    router = rt.Router([rt.LocalReplica("a", eng)], retries=2,
                       backoff_ms=1.0, hedge_ms=0, default_slo_s=30.0)
    try:
        rec = router.dispatch([9, 1, 4], max_new_tokens=2,
                              request_id="rc-1")
        assert rec["ok"], rec
        assert rec["attempts"][0]["reason"] == "chaos", rec
        assert chaos.fire_counts().get("admit_error") == 1
    finally:
        router.stop()
        eng.stop(flush=False)


def test_decode_stall_site_fires_and_counts(tiny_model, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_CHAOS_SITES",
                       "decode_stall@ms=5:times=2")
    chaos.reset()
    before = _counter_total("chaos_injected_total", "site",
                            "decode_stall")
    eng = _twin_engine(tiny_model)
    eng.generate([5, 6], max_new_tokens=6)
    assert chaos.fire_counts().get("decode_stall") == 2
    assert _counter_total("chaos_injected_total", "site",
                          "decode_stall") == before + 2


def test_serving_sites_inert_on_empty_spec(tiny_model):
    """Disabled mode: no fires, no counters, drains nothing — the
    default serving path must be untouched by the chaos layer."""
    before = {s: _counter_total("chaos_injected_total", "site", s)
              for s in ("replica_kill", "decode_stall", "admit_error")}
    eng = _twin_engine(tiny_model)
    eng.start()
    router = rt.Router([rt.LocalReplica("a", eng)], retries=1,
                       backoff_ms=1.0, hedge_ms=0, default_slo_s=30.0)
    try:
        rec = router.dispatch([8, 3], max_new_tokens=3)
        assert rec["ok"] and rec["n_attempts"] == 1
        assert chaos.fire_counts() == {}
        for s, v in before.items():
            assert _counter_total("chaos_injected_total", "site",
                                  s) == v
    finally:
        router.stop()
        eng.stop(flush=False)


def test_replica_kill_spec_parses_and_guards(monkeypatch):
    """replica_kill parses (tick required), arms per elastic attempt
    like kill_rank, and an armed-but-wrong-tick check never fires. The
    actual os._exit path rides the chaos-bench subprocess smokes."""
    sites = chaos.parse_sites("replica_kill@tick=60:rank=1")
    assert sites["replica_kill"]["tick"] == 60
    assert sites["replica_kill"]["attempt"] == 0
    with pytest.raises(_errs.errors.InvalidArgument):
        chaos.parse_sites("replica_kill@rank=1")  # tick is required
    monkeypatch.setenv("PADDLE_TPU_CHAOS_SITES", "replica_kill@tick=60")
    chaos.reset()
    chaos.replica_kill(59)  # wrong tick: returns (else the test dies)
    assert chaos.fire_counts() == {}
    # a respawned incarnation (attempt 1) is immune to the default
    # attempt=0 arming — the warm restart must serve, not re-die
    monkeypatch.setenv("PADDLE_RESPAWN_COUNT", "1")
    chaos.replica_kill(60)
    assert chaos.fire_counts() == {}


def test_replica_kill_dies_at_armed_tick(tiny_model, monkeypatch):
    """The in-engine kill site, without a subprocess: monkeypatch
    os._exit and assert the armed decode tick triggers it."""
    import os as _os

    calls = []
    monkeypatch.setenv("PADDLE_TPU_CHAOS_SITES", "replica_kill@tick=2")
    monkeypatch.setattr(_os, "_exit", lambda code: calls.append(code))
    chaos.reset()
    eng = _twin_engine(tiny_model)
    eng.generate([5, 6], max_new_tokens=5)
    assert calls and calls[0] == chaos.KILL_EXIT_CODE
    assert chaos.fire_counts().get("replica_kill") == 1


def test_draining_replica_still_replays_completed_ids(tiny_model):
    """A duplicate delivery of an ALREADY-COMPLETED
    request_id during drain replays from the idempotency cache (no new
    work) instead of bouncing — only genuinely new submissions are
    rejected."""
    eng = _twin_engine(tiny_model)
    h = eng.submit([4, 5, 6], max_new_tokens=3, request_id="dr-1")
    eng.run_until_idle()
    toks = h.result(timeout=10)
    eng.drain()
    dup = eng.submit([4, 5, 6], max_new_tokens=3, request_id="dr-1")
    assert dup.cached and dup.result(timeout=1) == toks
    with pytest.raises(_errs.errors.Unavailable):
        eng.submit([7, 8], max_new_tokens=2, request_id="dr-2")


# -- the port against the JAX package's router ------------------------------


def _killable(base, errors_mod):
    """``base`` (either package's LocalReplica) with a kill switch whose
    failure is that package's typed Unavailable (reason=connect)."""

    class Killable(base):
        def __init__(self, name, engine):
            super().__init__(name, engine)
            self.alive = True

        def _die(self):
            e = errors_mod.errors.Unavailable(f"{self.name} is dead")
            e.reason = "connect"
            raise e

        def submit(self, *a, **kw):
            if not self.alive:
                self._die()
            return super().submit(*a, **kw)

        def healthz(self, timeout=1.0):
            if not self.alive:
                self._die()
            return super().healthz(timeout)

    return Killable


@pytest.fixture(scope="module")
def twin_models():
    """Both packages' models on the same O(1)-scale numpy parameters."""
    jm = jserving.DecodeModel(jserving.GPTConfig(**_CFG),
                              params=rich_params(), **_ENV)
    tm = serving.DecodeModel(serving.GPTConfig(**_CFG), params=rich_params(),
                             device="cpu", **_ENV)
    return jm, tm


_PACKAGES = {
    "reference": (jserving, jrt, _jerrs),
    "port": (serving, rt, _errs),
}


def _stream():
    r = np.random.RandomState(3)
    return [list(int(t) for t in r.randint(1, 128, size=n))
            for n in (4, 9, 15, 6, 12)]


def _run_stream(which, model):
    """One request stream through a two-replica router of one package,
    replica ``a`` killed after the second request and revived before the
    last: the records' tokens, replicas and attempt reasons, and the
    router's health events."""
    pkg, router_mod, errs = _PACKAGES[which]
    killable = _killable(router_mod.LocalReplica, errs)
    ea, eb = pkg.ServingEngine(model), pkg.ServingEngine(model)
    ea.start()
    eb.start()
    a, b = killable("a", ea), killable("b", eb)
    router = router_mod.Router([a, b], retries=2, backoff_ms=1.0,
                               hedge_ms=0, default_slo_s=60.0, seed=4)
    out = []
    try:
        for i, prompt in enumerate(_stream()):
            if i == 2:
                a.alive = False
            if i == 4:
                a.alive = True
                router.probe_once()
            rec = router.dispatch(prompt, max_new_tokens=5,
                                  request_id=f"s-{i}")
            out.append((rec["ok"], rec["tokens"], rec["replica"],
                        [at.get("reason") for at in rec["attempts"]],
                        rec["failover"]))
        events = [(e["replica"], e["from"], e["to"], e["reason"])
                  for e in router.health_events]
        return out, events, router.snapshot()["stats"]
    finally:
        router.stop()
        ea.stop(flush=False)
        eb.stop(flush=False)


def test_parity_tokens_and_health_events(twin_models):
    """The same request stream, with the same replica death and revival,
    through both packages: equal records (tokens, serving replica,
    attempt reasons, failover), equal health-event sequences and equal
    router stats."""
    jm, tm = twin_models
    want = _run_stream("reference", jm)
    got = _run_stream("port", tm)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[1] == [("a", "healthy", "dead", "connect"),
                      ("a", "dead", "healthy", "healthz_ok")]
    assert got[2] == want[2]
    assert any(rec[4] for rec in got[0])  # a re-dispatch happened
    assert len({tuple(rec[1]) for rec in got[0]}) > 1  # tokens vary


def test_parity_health_event_states_on_probe_sweeps(twin_models):
    """Health sweeps alone: a replica that dies, one that reports
    draining, and both coming back give the same state sequences."""
    jm, tm = twin_models
    seqs = {}
    for which, model in (("reference", jm), ("port", tm)):
        pkg, router_mod, errs = _PACKAGES[which]
        killable = _killable(router_mod.LocalReplica, errs)
        ea, eb = pkg.ServingEngine(model), pkg.ServingEngine(model)
        a, b = killable("a", ea), killable("b", eb)
        router = router_mod.Router([a, b], retries=0, hedge_ms=0)
        try:
            states = [router.probe_once()]
            a.alive = False
            states.append(router.probe_once())
            eb.drain()
            states.append(router.probe_once())
            a.alive = True
            eb.undrain()
            states.append(router.probe_once())
            seqs[which] = (states, [(e["replica"], e["from"], e["to"],
                                     e["reason"])
                                    for e in router.health_events])
        finally:
            router.stop()
    assert seqs["port"] == seqs["reference"]


@pytest.mark.parametrize("base_ms", [1.0, 20.0, 50.0, 333.3])
def test_parity_backoff_delay_grid(base_ms):
    """``backoff_delay_s`` equals the JAX package's over attempts, request
    ids, seeds and the cap."""
    for attempt in range(12):
        for rid in ("", "req-1", "rt-77", "failover-3"):
            for seed in (0, 7):
                for cap in (2000.0, 150.0):
                    assert rt.backoff_delay_s(
                        attempt, rid, base_ms=base_ms, cap_ms=cap,
                        seed=seed) == jrt.backoff_delay_s(
                        attempt, rid, base_ms=base_ms, cap_ms=cap,
                        seed=seed)


def test_parity_traffic_telemetry_snapshot():
    """The same arrivals and depth samples (explicit times) give the
    same telemetry snapshot in both packages."""
    snaps = []
    for mod in (rt, jrt):
        tel = mod.TrafficTelemetry(horizons=[1.0, 10.0], max_series=4)
        t = 1000.0
        for i, dt in enumerate([0.1, 0.5, 0.02, 2.0, 0.3, 0.3]):
            t += dt
            tel.note_arrival("interactive" if i % 3 else "batch", now=t)
            tel.note_depth(i, i % 2, now=t)
        snap = tel.snapshot()
        snap.pop("started_unix")
        snaps.append(snap)
    assert snaps[0] == snaps[1]


def test_parity_oneshot_engine():
    """Both packages' process-wide execute-only engine: model-less, one a
    process, and a thunk's value, or its error, comes back through the
    serving lifecycle alike (the same request record but for its clocks
    and the traceback's file names)."""
    clocks = ("t_", "attribution", "thunk", "done_event", "exception",
              "traceback")
    records = []
    for pkg in (jserving, serving):
        eng = pkg.oneshot_engine()
        assert eng.model is None and pkg.oneshot_engine() is eng

        def bad():
            raise ValueError("boom")

        ok = eng.execute(lambda: [1, 2, 3], request_id="oneshot-ok")
        err = eng.execute(bad, request_id="oneshot-bad")
        assert ok.result(timeout=10) == [1, 2, 3]
        with pytest.raises(ValueError, match="boom"):
            err.result(timeout=10)
        records.append([{k: v for k, v in vars(h._req).items()
                         if not k.startswith(clocks)} for h in (ok, err)])
    assert records[0] == records[1]
    assert [r["status"] for r in records[1]] == ["done", "failed"]
