"""Compiled-program insight: each executor program's cost, counted by torch.

The port's counterpart of ``paddle_tpu/framework/xla_insight.py``, under
the same name so a reader finds it. The JAX package asks XLA, at the one
compile of a cache entry, for its cost analysis, memory analysis, jaxpr
and HLO. The port has no compiler to ask, so it counts the entry's first
eager run (:func:`recording`, which the executor wraps around it; never
a capture):

- **FLOPs**: the products that ``torch.utils.flop_counter.FlopCounterMode``
  counts (matmuls, on the tape's backward too), plus each hand-written
  kernel's own count, which its wrapper reports at each launch through
  :func:`note_kernel` (a ``ctypes`` launch never reaches a dispatch
  mode): the lm-head + CE forward 2NVD, dx and dW 4NVD each (the JAX
  package's own ``CostEstimate``s), flash attention 2D FLOPs per visible
  score for each of its products (2 forward, 3 dq, 4 dk/dv), Adam 15 per
  element. On the CPU a wrapper runs its plain version, whose products
  the counter sees, and reports nothing. Elementwise work is not
  counted; XLA's count includes it.
- **Peak bytes**: on the card, the caching allocator's peak over the run
  (reset before it) above what was allocated before it, plus the bytes
  of the values the run reads (``argument_bytes``): what the program
  holds live at once, as XLA's arguments + outputs + temps. The CPU has
  no allocator statistics: None.
- **Artifacts** under ``PADDLE_TPU_XLA_DUMP_DIR``:
  ``program.<hash>.ops`` (the op list, in place of the jaxpr),
  ``program.<hash>.dot`` (the captured CUDA graph's DOT,
  ``CUDAGraph.debug_dump``, in place of the HLO; written at the capture,
  so only on the card's compiled route) and ``program.<hash>.cost.json``,
  written last and again after the DOT.

Fields with no torch twin stay None: ``bytes_accessed`` (XLA counts the
bytes of each fused computation; torch runs no fusion pass to count, and
the kernels' own bytes are under ``cost_raw``), ``alias_bytes`` (XLA's
donated outputs; the port's persistables are updated in place by
construction, nothing is aliased by a compiler), ``generated_code_bytes``
(no code is generated: the kernels are built ahead and a CUDA graph holds
launches, not code) and ``collectives`` (a one-card program has none;
multi-card programs wait for ROADMAP A10/A12). ``n_jaxpr_eqns`` holds the
number of ops the program runs.

Env knobs (declared in ``flags.py``):
  PADDLE_TPU_XLA_INSIGHT=0    no record (no counting on the first run)
  PADDLE_TPU_XLA_DUMP_DIR=d   dump per-program artifacts into d
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from .. import flags as _flags
from .. import monitor as _monitor

__all__ = [
    "ProgramInsight", "enabled", "dump_dir", "key_hash", "recording",
    "active", "note_kernel", "record", "dump_artifacts", "dot_path",
    "load_dump_dir", "recent", "clear_recent", "program_footprint",
    "value_bytes", "new_footprint_row", "footprint_report", "COST_SCHEMA",
    "FOOTPRINT_SCHEMA",
]

COST_SCHEMA = "paddle_tpu.xla_cost/1"

_M_FLOPS = _monitor.gauge(
    "program_flops",
    "FLOPs of one execution of a program: products counted by "
    "FlopCounterMode plus the hand-written kernels' own counts",
    labelnames=("program",))
_M_PEAK = _monitor.gauge(
    "program_peak_bytes",
    "device bytes a program holds live at once: its inputs plus the "
    "allocator's peak growth over its first run", labelnames=("program",))
_M_CAPTURE = _monitor.counter(
    "xla_insight_captures_total",
    "program cost records by outcome", labelnames=("result",))


def enabled() -> bool:
    return bool(_flags.env_flag("PADDLE_TPU_XLA_INSIGHT"))


def dump_dir() -> Optional[str]:
    return _flags.env_flag("PADDLE_TPU_XLA_DUMP_DIR") or None


def key_hash(key: Any) -> str:
    """Short content hash — the label that ties a metric series, a dump
    artifact, and a cache entry to one program. Callers must feed it
    process-stable material (op-type sequence, feed spec, fetch names —
    NOT id()s), so the same program hashes the same across runs and a
    reused dump dir overwrites rather than accumulates."""
    return hashlib.sha1(repr(key).encode()).hexdigest()[:12]


@dataclass
class ProgramInsight:
    """Everything counted about one cache entry (the JAX package's
    fields; see the module docstring for those that stay None)."""

    key_hash: str
    label: str = ""
    fetch_names: Tuple[str, ...] = ()
    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    argument_bytes: Optional[int] = None
    output_bytes: Optional[int] = None
    temp_bytes: Optional[int] = None
    alias_bytes: Optional[int] = None
    generated_code_bytes: Optional[int] = None
    peak_bytes: Optional[int] = None
    donated_peak_bytes: Optional[int] = None
    n_jaxpr_eqns: Optional[int] = None
    time_unix: float = 0.0
    cost_raw: Dict[str, float] = field(default_factory=dict)
    artifacts: Dict[str, str] = field(default_factory=dict)  # kind -> path
    collectives: Optional[dict] = None

    def to_dict(self) -> dict:
        d = asdict(self)
        d["schema"] = COST_SCHEMA
        d["fetch_names"] = list(self.fetch_names)
        return d


_RECENT: List[ProgramInsight] = []
_RECENT_MAX = 128
_RECENT_LOCK = threading.Lock()


def recent() -> List[ProgramInsight]:
    """Insights recorded by this process, oldest first (bounded ring)."""
    with _RECENT_LOCK:
        return list(_RECENT)


def clear_recent() -> None:
    with _RECENT_LOCK:
        del _RECENT[:]


# ---------------------------------------------------------------------------
# counting (the executor's first-run hook)
# ---------------------------------------------------------------------------


class Recording:
    """What one run launched: the kernels' reported FLOPs, bytes and
    launches by kernel name, the products ``FlopCounterMode`` counted
    (``product_flops``) and, on the card, the allocator's bytes before
    the run and its peak over it."""

    def __init__(self):
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.product_flops = 0.0
        self.base_bytes: Optional[int] = None
        self.peak_bytes: Optional[int] = None
        self._lock = threading.Lock()

    def add(self, name: str, flops: float, nbytes: float) -> None:
        with self._lock:
            row = self.kernels.setdefault(
                name, {"flops": 0.0, "bytes": 0.0, "launches": 0})
            row["flops"] += float(flops)
            row["bytes"] += float(nbytes)
            row["launches"] += 1

    @property
    def kernel_flops(self) -> float:
        return sum(r["flops"] for r in self.kernels.values())

    @property
    def growth_bytes(self) -> Optional[int]:
        if self.peak_bytes is None or self.base_bytes is None:
            return None
        return max(0, self.peak_bytes - self.base_bytes)


# one recording at a time, process-wide: the backward's kernels launch on
# autograd's device thread, which a thread-local would not see
_ACTIVE: Optional[Recording] = None


def active() -> bool:
    """Whether a :func:`recording` is open (a wrapper skips computing its
    cost otherwise)."""
    return _ACTIVE is not None


def note_kernel(name: str, flops: float, nbytes: float) -> None:
    """A hand-written kernel's wrapper reports one launch's analytic
    FLOPs and bytes (each input read once, each output written once);
    counted only while a :func:`recording` is open."""
    rec = _ACTIVE
    if rec is not None:
        rec.add(name, flops, nbytes)


@contextlib.contextmanager
def recording(device: torch.device):
    """Count what the enclosed run does (see the module docstring).
    Resets the card's peak-memory statistics first."""
    from torch.utils.flop_counter import FlopCounterMode

    global _ACTIVE
    rec = Recording()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        rec.base_bytes = int(torch.cuda.memory_allocated(device))
    counter = FlopCounterMode(display=False)
    _ACTIVE = rec
    try:
        with counter:
            yield rec
    finally:
        _ACTIVE = None
    rec.product_flops = float(counter.get_total_flops())
    if cuda:
        torch.cuda.synchronize(device)
        rec.peak_bytes = int(torch.cuda.max_memory_allocated(device))


def value_bytes(value: Any) -> int:
    """Device bytes of one tensor or array-like (params, accumulators)."""
    if isinstance(value, torch.Tensor):
        return int(value.element_size()) * int(value.numel())
    try:
        import numpy as np

        return int(np.dtype(value.dtype).itemsize) * int(np.prod(value.shape))
    except (AttributeError, TypeError, ValueError):
        return 0


def record(rec: Recording, *, key_hash: str, label: str = "",
           fetch_names=(), n_ops: Optional[int] = None,
           argument_bytes: Optional[int] = None,
           output_bytes: Optional[int] = None) -> ProgramInsight:
    """The cost record of one counted run: gauges set, a flight-recorder
    event, and the record kept in :func:`recent`."""
    insight = ProgramInsight(key_hash=key_hash, label=label,
                             fetch_names=tuple(fetch_names),
                             time_unix=time.time(), n_jaxpr_eqns=n_ops,
                             argument_bytes=argument_bytes,
                             output_bytes=output_bytes)
    insight.flops = rec.product_flops + rec.kernel_flops
    insight.cost_raw = {"flops": insight.flops,
                        "product flops": rec.product_flops,
                        "kernel flops": rec.kernel_flops}
    for name, row in sorted(rec.kernels.items()):
        for k, v in row.items():
            insight.cost_raw[f"{name} {k}"] = float(v)
    growth = rec.growth_bytes
    if growth is not None:
        insight.temp_bytes = max(0, growth - (output_bytes or 0))
        insight.peak_bytes = (argument_bytes or 0) + growth
        insight.donated_peak_bytes = insight.peak_bytes
    _M_FLOPS.labels(program=key_hash).set(insight.flops)
    if insight.peak_bytes is not None:
        _M_PEAK.labels(program=key_hash).set(insight.peak_bytes)
    _monitor.flight_record("compile", f"program.{key_hash}",
                           flops=insight.flops,
                           peak_bytes=insight.peak_bytes)
    _M_CAPTURE.labels(result="ok").inc()
    with _RECENT_LOCK:
        _RECENT.append(insight)
        del _RECENT[:-_RECENT_MAX]
    return insight


# ---------------------------------------------------------------------------
# artifact dump / load
# ---------------------------------------------------------------------------


def dump_artifacts(insight: ProgramInsight, out_dir: str,
                   ops_text: Optional[str] = None) -> Dict[str, str]:
    """Write ``program.<hash>.ops`` (when given) and then
    ``program.<hash>.cost.json`` into ``out_dir``. The cost.json is
    written LAST so a reader that sees it can rely on the sibling text
    artifacts being complete; a later artifact (the DOT, written at the
    capture) calls this again to rewrite it."""
    os.makedirs(out_dir, exist_ok=True)
    base = os.path.join(out_dir, f"program.{insight.key_hash}")
    if ops_text:
        with open(base + ".ops", "w") as f:
            f.write(ops_text)
        insight.artifacts["ops"] = base + ".ops"
    with open(base + ".cost.json", "w") as f:
        json.dump(insight.to_dict(), f, indent=1)
    insight.artifacts["cost"] = base + ".cost.json"
    return dict(insight.artifacts)


def dot_path(insight: ProgramInsight, out_dir: str) -> str:
    """Where the captured graph's DOT of this program goes."""
    return os.path.join(out_dir, f"program.{insight.key_hash}.dot")


def load_dump_dir(dump_dir: str) -> Dict[str, dict]:
    """``PADDLE_TPU_XLA_DUMP_DIR`` -> {key_hash: cost record}. Records
    are the ``ProgramInsight.to_dict()`` JSONs; sibling .ops/.dot paths
    are filled into ``artifacts`` when present on disk."""
    import glob

    out: Dict[str, dict] = {}
    for path in sorted(glob.glob(os.path.join(dump_dir,
                                              "program.*.cost.json"))):
        try:
            with open(path) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            continue
        h = rec.get("key_hash") or os.path.basename(path).split(".")[1]
        base = path[: -len(".cost.json")]
        arts = dict(rec.get("artifacts") or {})
        for kind, suffix in (("ops", ".ops"), ("dot", ".dot")):
            if os.path.exists(base + suffix):
                arts[kind] = base + suffix
        rec["artifacts"] = arts
        out[h] = rec
    return out


# ---------------------------------------------------------------------------
# model footprint (static-graph side)
# ---------------------------------------------------------------------------


FOOTPRINT_SCHEMA = "paddle_tpu.footprint/1"


def new_footprint_row() -> dict:
    return {
        "param_bytes": 0, "opt_state_bytes": 0, "other_bytes": 0,
        "n_params": 0, "n_elements": 0,
    }


def footprint_report(layers: Dict[str, dict], total_param_bytes: int,
                     total_opt_state_bytes: int,
                     total_other_bytes: int = 0) -> dict:
    """Assemble the footprint result and publish the totals to the stat
    gauges (the run-report hook)."""
    out = {
        "schema": FOOTPRINT_SCHEMA,
        "total_param_bytes": total_param_bytes,
        "total_opt_state_bytes": total_opt_state_bytes,
        "total_other_bytes": total_other_bytes,
        "total_bytes": (total_param_bytes + total_opt_state_bytes
                        + total_other_bytes),
        "layers": dict(sorted(layers.items())),
    }
    _monitor.stat_set("model_param_bytes", total_param_bytes)
    _monitor.stat_set("model_opt_state_bytes", total_opt_state_bytes)
    return out


def program_footprint(program, scope, depth: int = 1) -> dict:
    """Byte accounting of a program's scope-resident state, aggregated by
    layer prefix (the segment of the variable name before the first '.',
    e.g. ``gpt`` owns ``gpt.wte`` and its ``gpt.wte_moment1_0``
    accumulator). Parameters are told apart from optimizer state via
    ``program.all_parameters()``; everything else persistable lands in
    ``other_bytes``."""
    param_names = {p.name for p in program.all_parameters()}
    layers: Dict[str, dict] = {}

    def row(name: str) -> dict:
        prefix = ".".join(name.split(".")[:depth]) or name
        return layers.setdefault(prefix, new_footprint_row())

    def is_accumulator(name: str) -> bool:
        # accumulators are named <param.name>_<acc>[_N]: test the prefix
        # at each '_' boundary against the param-name set
        i = name.find("_")
        while i != -1:
            if name[:i] in param_names:
                return True
            i = name.find("_", i + 1)
        return False

    total_p = total_o = total_x = 0
    for var in program.global_block().vars.values():
        if not getattr(var, "persistable", False):
            continue
        value = scope.get(var.name) if scope.has(var.name) else None
        if value is None:
            continue
        b = value_bytes(value)
        r = row(var.name)
        if var.name in param_names:
            r["param_bytes"] += b
            r["n_params"] += 1
            r["n_elements"] += int(value.numel()) if isinstance(
                value, torch.Tensor) else int(getattr(value, "size", 0))
            total_p += b
        elif is_accumulator(var.name):
            r["opt_state_bytes"] += b
            total_o += b
        else:
            r["other_bytes"] += b
            total_x += b
    return footprint_report(layers, total_p, total_o, total_x)
