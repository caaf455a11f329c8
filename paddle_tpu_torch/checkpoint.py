"""Atomic full-state training checkpoints and auto-resume for the fit
loop.

Port of ``paddle_tpu/checkpoint.py``. A checkpoint holds everything the
fit loop needs to continue as if no crash had happened: the parameters
(``network.state_dict()``), every optimizer accumulator (Adam's moments
and beta powers ...) with the LR scheduler's state, the global step and
the data/RNG cursor (epoch, step in the epoch and the numpy global RNG
state, so shuffles and data order continue) and the eager tracer's
(seed, step), the key of the next step's dropout masks: the port draws
new masks each step (``dygraph/tracer.py``), so a resumed run must draw
where the crashed one would have. The data-parallel comms
residuals (``__dp_comms__``) wait for A10 with the comms layer.

Writes are atomic (``monitor.atomic_write``: a same-directory temp file
and ``os.replace``; a crash mid-write leaves the previous checkpoint) and
carry a content digest (:func:`state_digest`) so a resume can assert bit
identity. A retention window (``PADDLE_TPU_CKPT_KEEP``) sweeps older
checkpoints as new ones land.

Restore pre-seeds the optimizer's accumulator store (eager optimizers
create accumulators at their first step), so the first resumed update
already runs on the restored moments. Values are copied onto the
parameters' device, in their dtype.

Env knobs (``flags.py``): ``PADDLE_TPU_CKPT_DIR`` turns on the fit loop's
checkpoints and resume, ``PADDLE_TPU_CKPT_STEPS`` their cadence,
``PADDLE_TPU_CKPT_KEEP`` the retention window.
"""
from __future__ import annotations

import glob
import hashlib
import os
import pickle
import re
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import flags as _flags
from . import monitor as _monitor
from .framework import core
from .framework import program as _framework

__all__ = [
    "SCHEMA", "TrainCheckpointer", "from_env", "state_digest",
    "atomic_write_bytes", "latest_path", "load",
]

SCHEMA = "paddle_tpu.trainckpt/1"

_FILE_RE = re.compile(r"trainckpt\.rank(\d+)\.step(\d+)\.pdz$")

_M_SAVED = _monitor.counter(
    "train_checkpoint_saved_total", "training checkpoints written")
_M_RESUMED = _monitor.counter(
    "train_checkpoint_resumed_total", "training resumes from a checkpoint")


def atomic_write_bytes(path: str, data: bytes) -> str:
    """Binary checkpoint writes ride THE one atomicity implementation
    (monitor.atomic_write: same-dir temp + os.replace + the io_stall
    chaos site — a checkpoint flush is exactly the write a wedged disk
    stalls)."""
    return _monitor.atomic_write(path, data)


def _to_numpy(v) -> np.ndarray:
    """A value (an eager Tensor, a torch tensor, an array) as numpy on the
    host; bfloat16 as its exact float32."""
    inner = getattr(v, "_value", None)
    v = inner if inner is not None else v
    if isinstance(v, torch.Tensor):
        return core.host_numpy(v)
    return np.asarray(v)


def _digest_update(h, obj, prefix: str = "") -> None:
    if isinstance(obj, dict):
        for k in sorted(obj):
            _digest_update(h, obj[k], f"{prefix}/{k}")
        return
    if isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _digest_update(h, v, f"{prefix}[{i}]")
        return
    if isinstance(obj, np.ndarray) or hasattr(obj, "shape"):
        a = np.ascontiguousarray(np.asarray(obj))
        h.update(f"{prefix}:{a.dtype}:{a.shape}:".encode())
        h.update(a.tobytes())
        return
    h.update(f"{prefix}={obj!r};".encode())


def state_digest(*states: Any) -> str:
    """Content digest over nested state containers (arrays hashed by
    dtype+shape+bytes, scalars by repr) — equal iff the states are
    bit-identical. The chaos test's resume-equality oracle."""
    h = hashlib.sha1()
    for s in states:
        _digest_update(h, s)
    return h.hexdigest()


def _content_digest(params: Dict[str, Any], accumulators: Dict[str, Any],
                    opt_state: Dict[str, Any]) -> str:
    """The checkpoint digest: params + accumulator VALUES (keyed by the
    process-independent structured name — the raw framework names a
    respawn re-generates must not perturb equality) + the __dp_comms__
    error-feedback residuals."""
    acc_values = {
        slot: {key: rec.get("value") for key, rec in per.items()}
        for slot, per in (accumulators or {}).items()
    }
    return state_digest(params, acc_values,
                        (opt_state or {}).get("__dp_comms__", {}))


def _tracer_seed_step():
    """The eager tracer's (seed, step): the key of its next step's random
    draws (dropout masks), or None in static mode."""
    tracer = _framework._current_tracer()
    return None if tracer is None else list(tracer.seed_step)


def latest_path(dir: str, rank: Optional[int] = None) -> Optional[str]:
    """Newest (highest-step) checkpoint of `rank` in `dir`, or None."""
    rank = _monitor.trainer_rank() if rank is None else int(rank)
    best: Optional[tuple] = None
    for p in glob.glob(os.path.join(dir, "trainckpt.rank*.step*.pdz")):
        m = _FILE_RE.search(os.path.basename(p))
        if not m or int(m.group(1)) != rank:
            continue
        step = int(m.group(2))
        if best is None or step > best[0]:
            best = (step, p)
    return best[1] if best else None


def load(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        doc = pickle.load(f)
    if not isinstance(doc, dict) or doc.get("schema") != SCHEMA:
        raise ValueError(f"{path}: not a training checkpoint (schema "
                         f"{doc.get('schema') if isinstance(doc, dict) else None!r})")
    return doc


class TrainCheckpointer:
    """Periodic atomic checkpoints for one rank's fit loop."""

    def __init__(self, dir: str, every_steps: Optional[int] = None,
                 keep: Optional[int] = None, rank: Optional[int] = None):
        self.dir = dir
        self.every_steps = max(1, int(
            every_steps if every_steps is not None
            else _flags.env_flag("PADDLE_TPU_CKPT_STEPS")))
        self.keep = max(1, int(
            keep if keep is not None
            else _flags.env_flag("PADDLE_TPU_CKPT_KEEP")))
        self.rank = _monitor.trainer_rank() if rank is None else int(rank)
        self.last_saved_step: Optional[int] = None

    def path_for(self, step: int) -> str:
        return os.path.join(
            self.dir, f"trainckpt.rank{self.rank}.step{int(step):08d}.pdz")

    # -- save -----------------------------------------------------------

    def save(self, network, optimizer, step: int,
             data_cursor: Optional[Dict[str, Any]] = None,
             rng_state=None) -> str:
        """Write one checkpoint: everything the resumed rank needs to
        continue bit-identically from `step` completed steps.
        ``rng_state`` is the numpy RNG state to restore BEFORE resuming
        the data iteration (the fit loop passes the epoch-start state,
        from before the loader drew its shuffle permutation); default:
        the current state."""
        params = {name: _to_numpy(p)
                  for name, p in network.state_dict().items()}
        opt_state, accumulators = self._optimizer_state(
            optimizer, network=network)
        doc = {
            "schema": SCHEMA,
            "rank": self.rank,
            "pid": os.getpid(),
            "time_unix": time.time(),
            "step": int(step),
            "params": params,
            "optimizer": opt_state,
            "accumulators": accumulators,
            "data_cursor": dict(data_cursor or {}),
            "numpy_rng": (rng_state if rng_state is not None
                          else np.random.get_state()),
            "dygraph_rng": _tracer_seed_step(),
        }
        doc["digest"] = _content_digest(params, accumulators, opt_state)
        path = self.path_for(step)
        atomic_write_bytes(path, pickle.dumps(doc, protocol=4))
        self.last_saved_step = int(step)
        _M_SAVED.inc()
        _monitor.flight_record("checkpoint", "saved", step=int(step),
                               path=os.path.basename(path))
        self._sweep()
        return path

    def maybe_save(self, network, optimizer, step: int,
                   data_cursor: Optional[Dict[str, Any]] = None,
                   rng_state=None) -> Optional[str]:
        """Cadence gate: save when `step` completed steps hit the
        every_steps boundary (and only once per boundary)."""
        if step <= 0 or step % self.every_steps != 0:
            return None
        if self.last_saved_step == step:
            return None
        return self.save(network, optimizer, step, data_cursor,
                         rng_state=rng_state)

    @staticmethod
    def _optimizer_state(optimizer, network=None) -> tuple:
        """(flat state_dict, structured {slot: {param_key: {name,
        value}}}). The structured half is what lets restore pre-seed the
        lazily-created accumulator store on a fresh process. Keys prefer
        the network's STRUCTURED parameter names (``0.weight``), which
        survive the process-global unique-name counter a respawn (or a
        rebuilt model) re-winds; the raw framework name is kept alongside
        for translation back."""
        if optimizer is None:
            return {}, {}
        flat = {}
        for k, v in optimizer.state_dict().items():
            flat[k] = v if k in ("LR_Scheduler", "__dp_comms__") \
                else np.asarray(v)
        qual_of = {}
        if network is not None:
            qual_of = {getattr(p, "name", qual): qual
                       for qual, p in network.named_parameters()}
        structured: Dict[str, Dict[str, dict]] = {}
        for slot, per_param in getattr(optimizer, "_accumulators",
                                       {}).items():
            structured[slot] = {
                qual_of.get(pname, pname): {
                    "name": getattr(var, "name", None),
                    "param_name": pname,
                    "value": _to_numpy(var)}
                for pname, var in per_param.items()
            }
        return flat, structured

    def _sweep(self) -> None:
        """Retention: keep the newest `keep` checkpoints of this rank."""
        mine = []
        for p in glob.glob(os.path.join(
                self.dir, f"trainckpt.rank{self.rank}.step*.pdz")):
            m = _FILE_RE.search(os.path.basename(p))
            if m and int(m.group(1)) == self.rank:
                mine.append((int(m.group(2)), p))
        for _, p in sorted(mine)[:-self.keep]:
            try:
                os.unlink(p)
            except OSError:
                pass  # a raced unlink must not kill the training loop

    # -- restore --------------------------------------------------------

    def load_latest(self) -> Optional[Dict[str, Any]]:
        path = latest_path(self.dir, self.rank)
        if path is None:
            return None
        try:
            return load(path)
        except (OSError, ValueError, pickle.UnpicklingError):
            return None  # a torn file cannot happen (atomic); an alien can

    def restore(self, network, optimizer, doc: Dict[str, Any],
                restore_rng: bool = True) -> int:
        """Apply a checkpoint: params, optimizer accumulators (pre-seeded
        into the lazy store so the FIRST resumed step updates on the
        restored moments), LR scheduler + __dp_comms__ residuals, and
        the numpy RNG cursor. Returns the completed-step count."""
        network.set_state_dict(doc["params"])
        if optimizer is not None:
            self._restore_accumulators(optimizer, doc.get("accumulators"),
                                       network=network)
            optimizer.set_state_dict(doc.get("optimizer") or {})
        if restore_rng and doc.get("numpy_rng") is not None:
            np.random.set_state(doc["numpy_rng"])
        tracer = _framework._current_tracer()
        if (restore_rng and tracer is not None
                and doc.get("dygraph_rng") is not None):
            tracer.set_seed_step(*doc["dygraph_rng"])
        self.last_saved_step = int(doc["step"])
        _M_RESUMED.inc()
        _monitor.flight_record("checkpoint", "resumed",
                               step=int(doc["step"]),
                               digest=doc.get("digest"))
        return int(doc["step"])

    @staticmethod
    def _restore_accumulators(optimizer, structured, network=None) -> None:
        if not structured:
            return
        from .dygraph.varbase import Tensor

        # translate structured parameter keys back to THIS process's
        # framework names (a respawn may wind the unique-name counter
        # differently than the dead attempt)
        params = {}
        if network is not None:
            params = {qual: p for qual, p in network.named_parameters()}
        for slot, per_param in structured.items():
            store = optimizer._accumulators.setdefault(slot, {})
            for key, rec in per_param.items():
                p = params.get(key)
                pname = getattr(p, "name", None) or rec.get("param_name", key)
                value = torch.from_numpy(np.ascontiguousarray(rec["value"]))
                existing = store.get(pname)
                if getattr(existing, "_value", None) is not None:
                    with torch.no_grad():
                        existing._value.copy_(value)
                    continue
                store[pname] = Tensor(
                    value, name=rec.get("name") or f"{pname}_{slot}_resume",
                    place=getattr(p, "place", None), stop_gradient=True,
                    persistable=True)

    def current_digest(self, network, optimizer) -> str:
        """Digest of the LIVE state, shaped exactly like the saved one —
        the equality oracle the bit-identical-resume tests compare."""
        params = {name: _to_numpy(p)
                  for name, p in network.state_dict().items()}
        opt_state, accumulators = self._optimizer_state(
            optimizer, network=network)
        return _content_digest(params, accumulators, opt_state)


def from_env() -> Optional[TrainCheckpointer]:
    """The fit loop's wiring: a TrainCheckpointer when
    PADDLE_TPU_CKPT_DIR is set, else None."""
    dir = str(_flags.env_flag("PADDLE_TPU_CKPT_DIR")).strip()
    if not dir:
        return None
    try:
        os.makedirs(dir, exist_ok=True)
    except OSError:
        return None  # unwritable dir: checkpointing stays off
    return TrainCheckpointer(dir)
