"""Runtime env-flag registry: the PADDLE_TPU_* variables the port reads.

Port of ``paddle_tpu/flags.py``, cut to the flags this package reads:
the serving engine's ``PADDLE_TPU_SERVE_*`` knobs, the monitor and
profiler switches, the chaos sites and ``PADDLE_TPU_EAGER`` (the port's
own: the card replays CUDA graphs unless it is set). The other variable
names are the JAX package's own, so one deployment's environment drives
either package.

Every variable is declared here once (name, typed default, help) and
read through :func:`env_flag`. Flags are read live from ``os.environ``:
tests flip them with monkeypatch.setenv and the next read sees the new
value.
"""
from __future__ import annotations

import os
from typing import Any, Dict

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
    "PADDLE_TPU_OP_CALLSTACK", True,
    "record the Python build-site callstack on every Operator (op "
    "provenance on errors); 0 skips the capture")
define_env_flag(
    "PADDLE_TPU_FUSED_LMHEAD", "auto",
    "GPT training loss path (models/gpt.py): 'auto' (default) and "
    "'pallas' lower the tied lm-head + cross-entropy as the fused kernels "
    "that never write the [tokens, vocab] logits (on the card: "
    "csrc/lmhead_ce.cu); 'off' the materialized-logits "
    "softmax_with_cross_entropy path; 'on'/'chunked' (the JAX package's "
    "lax-loop path) is not ported and raises at run time")
define_env_flag(
    "PADDLE_TPU_CHECK_NUMERICS", False,
    "numerics sentinel of the JAX executor; not ported: a run with it "
    "set raises errors.Unimplemented")
