"""Runtime env-flag registry: the PADDLE_TPU_* variables the port reads.

Port of ``paddle_tpu/flags.py``, cut to the flags this package reads:
the serving engine's and its front tier's ``PADDLE_TPU_SERVE_*`` knobs
(router, capacity planner, autoscaler), the status server's port and
host, the goodput, memwatch and dynamics journals and their detectors,
the compiled-program insight and its dump directory, the numerics
sentinel, the fit loop's checkpoints and asynchronous loss, the monitor
and profiler switches, the chaos sites and
``PADDLE_TPU_EAGER`` (the port's own: the card replays CUDA graphs
unless it is set). The other variable names are the JAX package's own,
so one deployment's environment drives either package.

Every variable is declared here once (name, typed default, help) and
read through :func:`env_flag`. Flags are read live from ``os.environ``:
tests flip them with monkeypatch.setenv and the next read sees the new
value.

The core ``FLAGS_*`` tier (``define_flag``, ``get_flags``,
``set_flags``: Paddle's ``paddle.set_flags``) carries the core flags the
ported executor honors, ``FLAGS_check_nan_inf``. Each initializes from
the environment variable of its name and can be flipped at run time; the
executor reads it at each run.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Iterable, Union

_DEFS: Dict[str, dict] = {}
_VALUES: Dict[str, Any] = {}


def _coerce(value, proto):
    if isinstance(proto, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(proto, int) and not isinstance(proto, bool):
        return int(value)
    if isinstance(proto, float):
        return float(value)
    return str(value)


def define_flag(name: str, default: Any, help_str: str = "") -> None:
    """Register a core flag (Paddle's DEFINE_bool/int32/... in flags.cc)."""
    if not name.startswith("FLAGS_"):
        name = "FLAGS_" + name
    _DEFS[name] = {"default": default, "help": help_str}
    env = os.environ.get(name)
    _VALUES[name] = _coerce(env, default) if env is not None else default


def get_flags(flags: Union[str, Iterable[str]]):
    """``paddle.get_flags``: a name gives its value, a list {name: value}."""
    if isinstance(flags, str):
        name = flags if flags.startswith("FLAGS_") else "FLAGS_" + flags
        if name not in _DEFS:
            raise KeyError(f"unknown flag {name!r}")
        return _VALUES[name]
    return {f: get_flags(f) for f in flags}


def set_flags(flags: Dict[str, Any]) -> None:
    """``paddle.set_flags({name: value})``."""
    for name, value in flags.items():
        if not name.startswith("FLAGS_"):
            name = "FLAGS_" + name
        if name not in _DEFS:
            raise KeyError(f"unknown flag {name!r}")
        _VALUES[name] = _coerce(value, _DEFS[name]["default"])


def all_flags() -> Dict[str, Any]:
    return dict(_VALUES)


_ENV_DEFS: Dict[str, dict] = {}


def define_env_flag(name: str, default: Any, help_str: str = "") -> None:
    """Declare a PADDLE_TPU_* env var (typed default + one-line help)."""
    _ENV_DEFS[name] = {"default": default, "help": help_str}


def _coerce_env(name: str, raw: str, proto: Any) -> Any:
    if isinstance(proto, bool):
        # set-but-disabling values are "0/false/off/no"; anything else
        # set counts as enabled
        return raw.strip().lower() not in ("0", "false", "off", "no", "")
    # malformed numerics must fail LOUDLY: silently falling back to the
    # default would e.g. leave the watchdog the operator armed with
    # PADDLE_TPU_WATCHDOG_SECS=120s switched off
    if isinstance(proto, int) and not isinstance(proto, bool):
        try:
            return int(raw)
        except ValueError as e:
            raise ValueError(
                f"{name}={raw!r} is not a valid integer") from e
    if isinstance(proto, float):
        try:
            return float(raw)
        except ValueError as e:
            raise ValueError(
                f"{name}={raw!r} is not a valid number") from e
    return raw


def env_flag(name: str) -> Any:
    """Current value of a declared env var: live os.environ read, coerced
    to the declared default's type; the default when unset."""
    if name not in _ENV_DEFS:
        raise KeyError(f"undeclared env flag {name!r}")
    raw = os.environ.get(name)
    if raw is None:
        return _ENV_DEFS[name]["default"]
    return _coerce_env(name, raw, _ENV_DEFS[name]["default"])


def env_flag_defs() -> Dict[str, dict]:
    """{name: {default, help, value}} for every declared env var."""
    return {
        name: {**dict(d), "value": env_flag(name)}
        for name, d in sorted(_ENV_DEFS.items())
    }


# -- monitor + profiler ------------------------------------------------------
define_env_flag(
    "PADDLE_TPU_METRICS", True,
    "typed metrics registry on/off; 0 reduces every inc/observe to one "
    "bool check")
define_env_flag(
    "PADDLE_TPU_TRACE", False,
    "enable host-span tracing at import")
define_env_flag(
    "PADDLE_TPU_TRACE_DIR", "",
    "flush each rank's trace to <dir>/trace.rank<k>.json at exit and "
    "enable the flight recorder")
define_env_flag(
    "PADDLE_TPU_TRACE_SAMPLE", 0.0,
    "always-on tracing that records ~every 1/rate-th step (0 < rate <= 1)")
define_env_flag(
    "PADDLE_TPU_TRACE_MAX_EVENTS", 1000000,
    "host-span ring capacity; beyond it the oldest spans drop")
define_env_flag(
    "PADDLE_TPU_WATCHDOG_SECS", 0.0,
    "start the hang watchdog: no step progress for N seconds triggers a "
    "flight-recorder dump")
define_env_flag(
    "PADDLE_TPU_FLIGHT_CAPACITY", 512,
    "flight-recorder ring size (recent span/progress events kept for "
    "hang dumps)")

# -- serving -----------------------------------------------------------------
define_env_flag(
    "PADDLE_TPU_SERVE_MAX_BATCH", 8,
    "continuous-batching decode slots per serving engine: up to this "
    "many requests share one decode tick")
define_env_flag(
    "PADDLE_TPU_SERVE_KV_BLOCKS", 64,
    "paged KV-cache blocks per serving engine (block 0 is the reserved "
    "scratch block); a request that cannot get blocks waits in the "
    "admission queue or triggers an eviction")
define_env_flag(
    "PADDLE_TPU_SERVE_BLOCK_SIZE", 16,
    "tokens per KV-cache block: requests hold ceil(context/block_size) "
    "blocks and grow one block at a time while decoding")
define_env_flag(
    "PADDLE_TPU_SERVE_PREFILL_BUCKETS", "32,128,512",
    "padded prompt lengths prefill runs at (comma-separated, "
    "ascending): a prompt runs at the smallest bucket that holds it")
define_env_flag(
    "PADDLE_TPU_SERVE_RECIPE", "",
    "sharding recipe for serving; multi-device serving is not ported, "
    "so any value raises NotImplementedError; unset = one device")
define_env_flag(
    "PADDLE_TPU_SERVE_SLO_S", 30.0,
    "default per-request latency SLO in seconds: the admission queue "
    "orders by absolute deadline (arrival + SLO), and eviction under "
    "KV pressure victimizes the latest deadline first")
define_env_flag(
    "PADDLE_TPU_SERVE_DIR", "",
    "persist the per-rank serving ledger journal "
    "(serving.rank<k>.json, atomic writes) into this directory; a "
    "restarted replica resumes its cumulative SLO totals from it")
define_env_flag(
    "PADDLE_TPU_SERVE_FLUSH_TICKS", 50,
    "flush the serving journal every N closed engine ticks (plus once "
    "at exit)")
define_env_flag(
    "PADDLE_TPU_SERVE_SPAN_BOUND", 1.5,
    "request-span reconciliation bound: summed per-request decode span "
    "seconds and the engine's slot-seconds (decode bucket x batch "
    "occupancy) must agree within this factor in either direction")
define_env_flag(
    "PADDLE_TPU_SERVE_ROOFLINE_BOUND", 8.0,
    "decode roofline reconciliation bound: measured decode tokens/s "
    "must sit within this factor below the roofline prediction (and no "
    "more than ~25% above it)")
define_env_flag(
    "PADDLE_TPU_SERVE_REAP_GRACE_S", 5.0,
    "serving-engine reaper: an in-flight request still holding its slot "
    "this many seconds past its absolute SLO deadline is failed and its "
    "slot + KV blocks reclaimed (serve_reaped_total); 0 disables")
define_env_flag(
    "PADDLE_TPU_SERVE_SHED", True,
    "admission-time load shedding: a request whose SLO deadline is "
    "already unmeetable at the current queue depth is rejected with "
    "typed errors.Unavailable (serve_shed_total) instead of occupying "
    "a slot it cannot use; 0 admits everything")
define_env_flag(
    "PADDLE_TPU_SERVE_ATTR_BOUND", 0.05,
    "per-request latency-attribution residual bound: "
    "|sum(buckets) - e2e| / e2e at the median must stay below this for "
    "the attribution reconciliation verdict to read within_bound")

# -- serving front tier: router, capacity planner, autoscaler -----------------
define_env_flag(
    "PADDLE_TPU_SERVE_RETRIES", 2,
    "serving router (serving/router.py): re-dispatch a failed request "
    "up to this many times on another replica, with exponential backoff "
    "+ deterministic jitter between attempts; every attempt carries the "
    "same request_id (idempotent re-dispatch, bit-identical greedy "
    "tokens); 0 fails on the first error")
define_env_flag(
    "PADDLE_TPU_SERVE_BACKOFF_MS", 50.0,
    "base of the router's retry backoff: re-dispatch k waits "
    "base*2^k ms (capped at 2000ms), jittered into [1/2, 1) of the raw "
    "delay by a per-(request_id, attempt) hash")
define_env_flag(
    "PADDLE_TPU_SERVE_HEDGE_MS", 0.0,
    "deadline-aware hedging: a dispatch still outstanding after this "
    "many ms whose SLO is at risk (remaining budget below the router's "
    "latency EMA) is duplicated onto a second replica — first success "
    "wins, both results are bit-match audited; 0 disables hedging")
define_env_flag(
    "PADDLE_TPU_SERVE_DRAIN_S", 10.0,
    "connection-draining budget: Router.drain_replica stops routing to "
    "a replica, asks its engine to finish all admitted work "
    "(new submissions rejected with typed Unavailable) and waits up to "
    "this many seconds for it to report drained")
define_env_flag(
    "PADDLE_TPU_SERVE_SLO_CLASSES",
    "interactive:slo=2,weight=3,hedge=1;batch:slo=30,weight=1,hedge=0",
    "multi-tenant SLO classes for the serving plane "
    "(serving/capacity.py): 'name:slo=<s>,weight=<w>,hedge=<0|1>' "
    "entries joined by ';' — slo is the class's default dispatch "
    "deadline and the attainment target the autoscale round grades, "
    "weight its admission share under the router's cap, hedge whether "
    "its SLO-at-risk requests may duplicate onto a second replica")
define_env_flag(
    "PADDLE_TPU_SERVE_TELEMETRY_HORIZONS", "1,10,60",
    "traffic-telemetry EMA horizons in seconds (comma-separated): the "
    "router tracks request-rate EMAs at each horizon per traffic class "
    "— the arrival-rate forecast inputs the serving planner reads")
define_env_flag(
    "PADDLE_TPU_SERVE_TELEMETRY_SERIES", 512,
    "max retained samples in the router's queue-depth / in-flight "
    "time series (ring buffer; oldest samples drop first)")
define_env_flag(
    "PADDLE_TPU_SERVE_TRACE", True,
    "cross-process request tracing on the serving plane: the router "
    "opens a root span per dispatch, pre-mints one span id per attempt "
    "and ships trace_id:span_id as __trace__ on every /generate POST "
    "and LocalReplica call; replicas parent their request-lifecycle "
    "spans under the inbound context (one connected flow per request "
    "in timeline.py --serve). Only active while profiler tracing is on "
    "(PADDLE_TPU_TRACE); 0 strips the propagation")
define_env_flag(
    "PADDLE_TPU_SERVE_PARAMS", "",
    "warm-restart parameter source for serving replicas: an .npz of "
    "named GPT parameters (models/gpt.py naming) every replica loads at "
    "boot — identical params across replicas is what makes router "
    "re-dispatch bit-identical, and reloading beats re-initializing on "
    "respawn; unset = seeded random init")
define_env_flag(
    "PADDLE_TPU_SERVE_AUTOSCALE_INTERVAL_S", 2.0,
    "seconds between autoscaler ticks (forecast -> decide -> at most "
    "one scale action)")
define_env_flag(
    "PADDLE_TPU_SERVE_AUTOSCALE_COOLDOWN_S", 3.0,
    "minimum seconds between consecutive scale ACTIONS (plan changes "
    "still journal during cooldown): long enough for a warm-booted "
    "replica's capacity to show up in the measured rates before the "
    "next decision, so the loop cannot flap")
define_env_flag(
    "PADDLE_TPU_SERVE_AUTOSCALE_HEADROOM", 0.15,
    "capacity headroom the serving planner reserves: a configuration "
    "is feasible only when the CV-widened demand fits inside "
    "(1 - headroom) of its calibrated tokens/s — the burst absorber "
    "between forecast and reality")
define_env_flag(
    "PADDLE_TPU_SERVE_AUTOSCALE_CV_WIDEN", 1.0,
    "demand-forecast burst widening: the planning upper bound is the "
    "blended rate EMA times (1 + cv_widen * interarrival_cv), so a "
    "bursty class (CV >> 1) plans more slack than a metronome one; "
    "0 plans the mean rate")
define_env_flag(
    "PADDLE_TPU_SERVE_AUTOSCALE_MAX_REPLICAS", 4,
    "autoscaler replica ceiling — the warm-restart spawn path is "
    "bounded by this even when the planner's pick asks for more "
    "(the device budget is the other bound)")

# -- status server + goodput ----------------------------------------------------
define_env_flag(
    "PADDLE_TPU_STATUS_PORT", 0,
    "serve /status, /metrics and /healthz on this HTTP port (stdlib "
    "server, one per process; a replica takes its own port); 0 disables")
define_env_flag(
    "PADDLE_TPU_STATUS_HOST", "127.0.0.1",
    "interface the status server binds; loopback by default (the "
    "endpoints are unauthenticated) — set 0.0.0.0 to let external "
    "scrapers reach /metrics")
define_env_flag(
    "PADDLE_TPU_GOODPUT_DIR", "",
    "persist the per-rank goodput ledger journal "
    "(goodput.rank<k>.json, atomic writes) into this directory; a "
    "restarted rank resumes its cumulative totals from it")
define_env_flag(
    "PADDLE_TPU_GOODPUT_FLUSH_STEPS", 50,
    "flush the goodput journal every N closed steps (plus once at exit)")

# -- step-side observability: memwatch, dynamics, compiled-program insight ----
define_env_flag(
    "PADDLE_TPU_XLA_INSIGHT", True,
    "record each executor cache entry's cost on its first eager run "
    "(products counted by torch.utils.flop_counter plus the hand-written "
    "kernels' own counts, allocator peak bytes) and export "
    "program_flops / program_peak_bytes metrics; 0 skips the record")
define_env_flag(
    "PADDLE_TPU_XLA_DUMP_DIR", "",
    "dump per-program artifacts (program.<hash>.{ops,dot,cost.json}: the "
    "op list, the captured CUDA graph's DOT, the cost record, written "
    "last) into this directory")
define_env_flag(
    "PADDLE_TPU_MEMWATCH", True,
    "live device-memory accounting (hbm_* gauges, per-step watermarks, "
    "leak detector, OOM post-mortem enrichment); 0 disables sampling")
define_env_flag(
    "PADDLE_TPU_MEMWATCH_DIR", "",
    "persist the per-rank memory ledger journal (memwatch.rank<k>.json, "
    "atomic writes) into this directory; a restarted rank resumes its "
    "lifetime peak from it")
define_env_flag(
    "PADDLE_TPU_MEMWATCH_FLUSH_STEPS", 50,
    "flush the memwatch journal every N closed steps (plus once at exit)")
define_env_flag(
    "PADDLE_TPU_MEMWATCH_LEAK_STEPS", 30,
    "steady-state leak detector: this many consecutive closed steps of "
    "monotonic bytes_in_use growth raise a leak-suspect event")
define_env_flag(
    "PADDLE_TPU_MEMWATCH_LEAK_MIN_MB", 8.0,
    "minimum total growth (MB) across the leak window before a "
    "leak-suspect event fires (filters allocator jitter)")
define_env_flag(
    "PADDLE_TPU_MEMWATCH_SAMPLE_RUNS", 10,
    "executor memory sampling cadence: query allocator stats every N "
    "steady-state Executor.run calls (compiling runs and explicitly fed "
    "samples are always recorded); 1 queries on every run")
define_env_flag(
    "PADDLE_TPU_DYNAMICS", True,
    "training-dynamics telemetry (per-step loss/grad-norm series, "
    "anomaly detectors); 0 disables recording")
define_env_flag(
    "PADDLE_TPU_DYNAMICS_DIR", "",
    "persist the per-rank training-dynamics journal "
    "(dynamics.rank<k>.jsonl: header line + one JSON line per closed "
    "step, atomic writes) into this directory; a restarted rank resumes "
    "its trajectory from it")
define_env_flag(
    "PADDLE_TPU_DYNAMICS_FLUSH_STEPS", 50,
    "flush the dynamics journal every N closed steps (plus once at exit)")
define_env_flag(
    "PADDLE_TPU_DYNAMICS_SAMPLE", 25,
    "per-layer-prefix grad/weight/update norm breakdown cadence in steps "
    "(one fused reduction per sample) for a step loop that samples it; "
    "0 disables the breakdown")
define_env_flag(
    "PADDLE_TPU_DYNAMICS_SPIKE_Z", 6.0,
    "loss-spike detector: a step whose loss sits more than this many "
    "EMA standard deviations above the loss EMA starts a loss_spike "
    "episode")
define_env_flag(
    "PADDLE_TPU_DYNAMICS_DIVERGE_STEPS", 25,
    "sustained-divergence detector: the loss EMA staying >1% above its "
    "best value for this many consecutive steps starts a divergence "
    "episode")
define_env_flag(
    "PADDLE_TPU_DYNAMICS_PLATEAU_STEPS", 200,
    "plateau detector: this many consecutive steps without a loss-EMA "
    "improvement starts a plateau episode (informational)")

# -- chaos -------------------------------------------------------------------
define_env_flag(
    "PADDLE_TPU_CHAOS_SITES", "",
    "arm deterministic fault injection (chaos.py): comma-separated "
    "site@key=val:key=val entries over the named sites "
    "(e.g. 'replica_kill@tick=60:rank=1'); unset = fully inert")
define_env_flag(
    "PADDLE_TPU_CHAOS_SEED", 0,
    "seed of the chaos injector's deterministic per-site decision "
    "stream: the same spec + seed reproduces the same faults at the "
    "same checks")

# -- compiled execution --------------------------------------------------------
define_env_flag(
    "PADDLE_TPU_EAGER", False,
    "run the card eagerly, op by op (the counterpart of jax.disable_jit): "
    "by default a steady training step (Executor.run) and each serving "
    "program (DecodeModel decode, prefill and score) are captured once "
    "as a CUDA graph and replayed; the CPU always runs eagerly")

# -- static-graph training ---------------------------------------------------
define_env_flag(
    "PADDLE_TPU_DEFAULT_DEVICE", "",
    "the default place before any set_device call (framework/core.py): "
    "'gpu', 'cuda' or 'tpu' (optionally ':<index>') for the card, 'cpu' "
    "for the host; unset = CUDAPlace(0)")
define_env_flag(
    "PADDLE_TPU_OP_CALLSTACK", True,
    "record the Python build-site callstack on every Operator (op "
    "provenance on errors); 0 skips the capture")
define_env_flag(
    "PADDLE_TPU_FUSED_LMHEAD", "auto",
    "GPT training loss path (models/gpt.py): 'auto' (default) and "
    "'pallas' lower the tied lm-head + cross-entropy as the fused kernels "
    "that never write the [tokens, vocab] logits (on the card: "
    "csrc/lmhead_ce.cu); 'off' the materialized-logits "
    "softmax_with_cross_entropy path; 'on'/'chunked' the token-chunked "
    "path that recomputes each chunk's logits in the backward")
define_env_flag(
    "PADDLE_TPU_CHECK_NUMERICS", False,
    "numerics sentinel: probe every float op output right after its op "
    "(inside the captured graph on the card) and raise a typed "
    "InvalidArgument naming the first op that produced nan/inf (op "
    "provenance attached)")


# -- the eager fit loop (hapi/model.py, checkpoint.py) -----------------------
define_env_flag(
    "PADDLE_TPU_CKPT_DIR", "",
    "enable periodic atomic training checkpoints in the hapi fit loop: "
    "params + optimizer state + step counter + data/RNG cursor persist to "
    "<dir>/trainckpt.rank<k>.step<N>.pdz and a respawned rank "
    "auto-resumes from the newest one")
define_env_flag(
    "PADDLE_TPU_CKPT_STEPS", 25,
    "training-checkpoint cadence: write one every N closed fit steps")
define_env_flag(
    "PADDLE_TPU_CKPT_KEEP", 2,
    "training-checkpoint retention window: newer writes sweep all but "
    "the latest N checkpoints of this rank")
define_env_flag(
    "PADDLE_TPU_ASYNC_LOSS", True,
    "pipelined fit-loop loss readback: each step's loss is copied to "
    "pinned host memory behind a CUDA event and read a step later, so "
    "the next step's dispatch overlaps the card finishing this one "
    "(detectors and step logs run one step behind; the epoch tail is "
    "flushed exactly); 0 restores the blocking per-step readback")


# -- core flag set (the subset of flags.cc the port's executor honors) -------
define_flag(
    "FLAGS_check_nan_inf", False,
    "executor debug mode: after every op, check that all float outputs "
    "are finite and report the first offending op as FloatingPointError "
    "(Paddle's operator.cc CheckNanInf)")
