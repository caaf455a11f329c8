"""Deterministic chaos injection: named fault sites in the hot paths.

Port of ``paddle_tpu/chaos.py``; it holds no device code, so only
its imports changed.

The fault plane's measurement problem is that real failures are rare and
unreproducible; a recovery path nobody can trigger on demand is a
recovery path nobody has tested. This module makes failure a first-class,
*deterministic* input: a flags-registry-gated spec
(``PADDLE_TPU_CHAOS_SITES``) arms named sites wired into the code paths
that actually fail at pod scale, and every decision derives from
``PADDLE_TPU_CHAOS_SEED`` + the site's per-process check counter — the
same spec and seed reproduce the same faults at the same points, which
is what lets tools/chaos_bench.py and the tier-1 kill-one-rank test
certify recovery instead of hoping for it.

Sites (each check is one potential injection point):

  kill_rank         hapi fit loop, at the OPEN of a global step:
                    ``os._exit`` — the SIGKILL-shaped loss of one rank
                    (params: step, rank, exit, attempt — default
                    attempt=0 fires on the FIRST elastic incarnation
                    only, so the respawned run recovers instead of
                    re-dying at the same step; -1 = every attempt)
  collective_delay  sleep before a collective payload exchange — the
                    straggler (params: ms, prob, rank, after, times)
  collective_abort  raise typed ``errors.Unavailable`` instead of the
                    exchange — the torn fabric (prob, rank, after, times)
  rpc_error         PSClient.call raises ``errors.Unavailable`` before
                    sending — the dead pserver (prob, rank, after, times)
  io_stall          sleep inside atomic journal/checkpoint writes — the
                    wedged filesystem (ms, prob, rank, after, times)

Serving sites (the serving-plane fault surface; wired into the engine
tick loop and the router dispatch path):

  replica_kill      serving engine, at the open of the armed decode
                    tick: ``os._exit`` — the SIGKILL-shaped loss of one
                    replica mid-batch, in-flight requests and KV state
                    included (params: tick, rank, exit, attempt —
                    attempt defaults to 0 like kill_rank, so a warm-
                    restarted replica serves instead of re-dying)
  decode_stall      sleep before a decode tick's device dispatch — the
                    wedged replica whose requests blow their SLO
                    (params: ms, prob, rank, after, times)
  admit_error       raise typed ``errors.Unavailable`` at engine
                    admission / router dispatch — the flaky front door
                    retry+failover must absorb (params: rate (alias of
                    prob), rank, after, times)

Spec grammar: comma-separated ``site@key=val[:key=val...]`` entries, e.g.

  PADDLE_TPU_CHAOS_SITES='kill_rank@step=5:rank=1'
  PADDLE_TPU_CHAOS_SITES='collective_delay@ms=40:prob=0.25,io_stall@ms=20'

Common params: ``rank`` (-1 = every rank), ``prob`` (0..1, default 1),
``after`` (skip the first N checks of the site), ``times`` (max fires
per process; kill_rank and collective_abort default to 1, the rest
unbounded). Unknown sites or params raise ``InvalidArgument`` at parse —
a typoed chaos spec silently injecting nothing would certify nothing.

Every fired injection is self-describing: a ``chaos_injected_total{site}``
counter increment plus a typed flight-recorder event carrying the site,
step and parameters, so a chaos run's record states what was done to it.
Disabled mode (the default, empty spec) is inert: one cached dict lookup
per check, no counters, no events — asserted by tests.
"""
from __future__ import annotations

import os
import threading
import time
import zlib
from typing import Any, Dict, Optional

from . import flags as _flags

__all__ = [
    "SITES", "parse_sites", "plan", "armed", "enabled", "fire_counts",
    "reset", "kill_rank", "delay", "abort", "rpc_error", "io_stall",
    "replica_kill", "admit_error", "KILL_EXIT_CODE",
]

KILL_EXIT_CODE = 43  # distinct from interpreter/signal codes: assertable

# site -> {param: (default, type)}; `step` None = required when the site
# is armed (a kill with no target step would fire on step 0 of every
# run, which is never what an operator means)
SITES: Dict[str, Dict[str, Any]] = {
    # attempt: the elastic attempt (PADDLE_RESTART_COUNT +
    # PADDLE_RESPAWN_COUNT) the kill is armed for. Default 0 = first
    # incarnation only — the checkpoint resume re-runs the killed step,
    # so a kill that re-fired every attempt would defeat every elastic
    # retry by construction. -1 = every attempt (the persistent-failure
    # experiment).
    "kill_rank": {"step": None, "rank": -1, "exit": KILL_EXIT_CODE,
                  "attempt": 0},
    "collective_delay": {"ms": 50.0, "prob": 1.0, "rank": -1,
                         "after": 0, "times": -1},
    "collective_abort": {"prob": 1.0, "rank": -1, "after": 0, "times": 1},
    "rpc_error": {"prob": 1.0, "rank": -1, "after": 0, "times": 1},
    "io_stall": {"ms": 50.0, "prob": 1.0, "rank": -1, "after": 0,
                 "times": -1},
    # the serving-plane sites: tick is to replica_kill what step
    # is to kill_rank; admit_error's `rate` is the probability (alias of
    # prob — the spec grammar operators actually write)
    "replica_kill": {"tick": None, "rank": -1, "exit": KILL_EXIT_CODE,
                     "attempt": 0},
    "decode_stall": {"ms": 50.0, "prob": 1.0, "rank": -1, "after": 0,
                     "times": -1},
    "admit_error": {"rate": 1.0, "rank": -1, "after": 0, "times": -1},
}

_INT_PARAMS = ("step", "tick", "rank", "exit", "after", "times",
               "attempt")


def elastic_attempt() -> int:
    """This process's elastic incarnation: whole-set restarts plus
    per-rank respawns (the launcher exports both counts)."""
    return (int(os.environ.get("PADDLE_RESTART_COUNT", "0") or 0)
            + int(os.environ.get("PADDLE_RESPAWN_COUNT", "0") or 0))

_lock = threading.Lock()
_checks: Dict[str, int] = {}   # per-site check counter (determinism key)
_fires: Dict[str, int] = {}    # per-site fired-injection counter
_plan_cache: Optional[tuple] = None  # (raw_spec, parsed)


def _invalid(msg: str):
    from .framework import errors as _errors

    return _errors.errors.InvalidArgument(msg)


def _unavailable(msg: str):
    from .framework import errors as _errors

    return _errors.errors.Unavailable(msg)


def parse_sites(text: str) -> Dict[str, Dict[str, Any]]:
    """Parse a chaos spec into {site: params}; loud on anything unknown."""
    out: Dict[str, Dict[str, Any]] = {}
    for entry in (e.strip() for e in (text or "").split(",") if e.strip()):
        name, _, rest = entry.partition("@")
        name = name.strip()
        if name not in SITES:
            raise _invalid(
                f"PADDLE_TPU_CHAOS_SITES: unknown site {name!r} "
                f"(known: {', '.join(sorted(SITES))})")
        params = {k: v for k, v in SITES[name].items() if v is not None}
        for kv in (p for p in rest.split(":") if p.strip()):
            k, sep, v = kv.partition("=")
            k = k.strip()
            if not sep or k not in SITES[name]:
                raise _invalid(
                    f"PADDLE_TPU_CHAOS_SITES: site {name!r} does not "
                    f"take {kv.strip()!r} (params: "
                    f"{', '.join(sorted(SITES[name]))})")
            try:
                params[k] = (int(v) if k in _INT_PARAMS else float(v))
            except ValueError as e:
                raise _invalid(
                    f"PADDLE_TPU_CHAOS_SITES: {name}@{k}={v!r} is not "
                    f"a number") from e
        for k, default in SITES[name].items():
            if default is None and k not in params:
                raise _invalid(
                    f"PADDLE_TPU_CHAOS_SITES: site {name!r} requires "
                    f"{k}= (e.g. {name}@{k}=5)")
        out[name] = params
    return out


def plan() -> Dict[str, Dict[str, Any]]:
    """The armed sites, parsed from the live env (cached on the raw
    string, so monkeypatched tests re-arm and the hot-path cost of the
    disabled mode stays one string compare)."""
    global _plan_cache
    raw = str(_flags.env_flag("PADDLE_TPU_CHAOS_SITES"))
    cached = _plan_cache
    if cached is not None and cached[0] == raw:
        return cached[1]
    parsed = parse_sites(raw)
    _plan_cache = (raw, parsed)
    return parsed


def enabled() -> bool:
    return bool(plan())


def armed(site: str) -> bool:
    return site in plan()


def reset() -> None:
    """Drop per-process counters (tests)."""
    global _plan_cache
    with _lock:
        _checks.clear()
        _fires.clear()
    _plan_cache = None


def fire_counts() -> Dict[str, int]:
    with _lock:
        return dict(_fires)


def _rank() -> int:
    from . import monitor as _monitor

    return _monitor.trainer_rank()


def _uniform(seed: int, site: str, rank: int, n: int) -> float:
    """Deterministic U[0,1) for the n-th check of a site on a rank:
    crc32 over the identity tuple — stable across processes and python
    hash seeds, the property the 'same seed, same faults' contract
    needs."""
    h = zlib.crc32(f"{seed}/{site}/{rank}/{n}".encode())
    return h / 2.0 ** 32


def _record(site: str, **detail) -> None:
    """One fired injection: counter + typed flight event + one stderr
    line (the run's self-description — a chaos record must say what was
    done to it even when the process dies before any journal flush)."""
    import sys

    from . import monitor as _monitor

    _monitor.counter(
        "chaos_injected_total",
        "chaos faults fired by site", ("site",)).labels(site=site).inc()
    _monitor.flight_record("chaos", site, **detail)
    print(f"[chaos] {site} fired: "
          + " ".join(f"{k}={v}" for k, v in sorted(detail.items())),
          file=sys.stderr, flush=True)


def _decide(site: str, step: Optional[int] = None) -> Optional[Dict[str, Any]]:
    """Shared arming/decision path: returns the site params when this
    check fires, None otherwise. Bumps the check counter either way so
    probabilistic decisions stay aligned with the check sequence."""
    p = plan().get(site)
    if p is None:
        return None
    rank = _rank()
    if p.get("rank", -1) not in (-1, rank):
        return None
    if "attempt" in p and int(p["attempt"]) != -1 \
            and int(p["attempt"]) != elastic_attempt():
        return None
    # one lock window from check-count bump to fire-count bump: two
    # concurrent checks (the comms thread + the main thread) must never
    # both pass a times=1 cap — the same-spec-same-faults contract
    with _lock:
        n = _checks[site] = _checks.get(site, 0) + 1
        # `tick` is the serving sites' step: one armed scheduler tick
        for key in ("step", "tick"):
            if key in p and (step is None or int(step) != int(p[key])):
                return None
        if n <= int(p.get("after", 0)):
            return None
        times = int(p.get("times", -1))
        if times >= 0 and _fires.get(site, 0) >= times:
            return None
        prob = float(p.get("prob", p.get("rate", 1.0)))
        if prob < 1.0:
            seed = int(_flags.env_flag("PADDLE_TPU_CHAOS_SEED"))
            if _uniform(seed, site, rank, n) >= prob:
                return None
        _fires[site] = _fires.get(site, 0) + 1
    return p


# ---------------------------------------------------------------------------
# the sites
# ---------------------------------------------------------------------------


def kill_rank(step: int) -> None:
    """The fit loop's per-step check: at the armed (step, rank) the
    process dies NOW, unflushed — the honest SIGKILL shape recovery has
    to survive. ``os._exit`` skips atexit so journals and checkpoints
    hold exactly what the cadence flushes persisted, like a real crash."""
    p = _decide("kill_rank", step=step)
    if p is None:
        return
    _record("kill_rank", step=int(step), rank=_rank(),
            exit=int(p["exit"]))
    os._exit(int(p["exit"]))


def delay(site: str = "collective_delay", where: str = "") -> float:
    """Sleep at an armed delay site; returns the injected seconds."""
    p = _decide(site)
    if p is None:
        return 0.0
    secs = float(p.get("ms", 50.0)) / 1e3
    _record(site, ms=float(p.get("ms", 50.0)), where=where, rank=_rank())
    time.sleep(secs)
    return secs


def abort(site: str = "collective_abort", where: str = "") -> None:
    """Raise typed ``errors.Unavailable`` at an armed abort site — the
    injected fabric failure the coordinated-detection path must surface,
    never swallow."""
    if _decide(site) is None:
        return
    _record(site, where=where, rank=_rank())
    raise _unavailable(
        f"chaos {site} injected at {where or 'collective'} "
        f"(rank {_rank()})")


def rpc_error(method: str = "") -> None:
    """PS client site: the armed call dies before any bytes move."""
    if _decide("rpc_error") is None:
        return
    _record("rpc_error", method=method, rank=_rank())
    raise _unavailable(
        f"chaos rpc_error injected before rpc/{method} (rank {_rank()})")


def replica_kill(tick: int) -> None:
    """The serving engine's per-decode-tick check: at the armed
    (tick, rank) the replica process dies NOW — in-flight requests, KV
    state and unflushed ledger ticks all lost, the honest shape the
    router's failover and the warm-restart path have to survive."""
    p = _decide("replica_kill", step=tick)
    if p is None:
        return
    _record("replica_kill", tick=int(tick), rank=_rank(),
            exit=int(p["exit"]))
    os._exit(int(p["exit"]))


def admit_error(where: str = "") -> None:
    """Serving admission / router dispatch site: the armed check raises
    typed ``errors.Unavailable`` — the flaky front door the retry path
    must absorb (the engine fails the one request, never the batch)."""
    if _decide("admit_error") is None:
        return
    _record("admit_error", where=where, rank=_rank())
    raise _unavailable(
        f"chaos admit_error injected at {where or 'admission'} "
        f"(rank {_rank()})")


def io_stall(path: str = "") -> float:
    """Checkpoint/journal write site: the wedged disk. Sleeps; the write
    itself still completes (a stall, not a loss)."""
    p = _decide("io_stall")
    if p is None:
        return 0.0
    secs = float(p.get("ms", 50.0)) / 1e3
    _record("io_stall", ms=float(p.get("ms", 50.0)),
            path=os.path.basename(path), rank=_rank())
    time.sleep(secs)
    return secs
