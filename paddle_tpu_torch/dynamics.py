"""Training-dynamics observability: loss/grad telemetry + divergence judge.

Port of ``paddle_tpu/dynamics.py``. The ledger, its series, EMA
statistics and anomaly detectors, the journal and the cross-rank desync
probe are the JAX package's text; the one device computation, the fused
gradient reduction, is torch here:

- **per-step series**: a step loop calls :func:`feed` with each step's
  loss, global gradient norm, update-to-weight ratio and learning rate
  into the open step; :func:`end_step` (riding ``goodput.end_step``, so
  a loop that closes goodput steps closes dynamics steps with no new
  hook) freezes the record into a bounded in-memory series and the
  per-rank journal. The JAX package's main feeder, the hapi fit loop,
  waits for ROADMAP A8; until then a static-graph loop feeds it (the
  gradients are fetched from ``Executor.run``).
- **fused reductions**: the global grad norm and the per-layer-prefix
  grad/weight/update norm breakdown come from ONE reduction over the
  whole tensor list (:func:`grad_health`, :func:`layer_breakdown`): per
  tensor the fp32 sum of squares and an all-finite flag, stacked into one
  (2, n) tensor on the tensors' device and read by the host in one
  transfer. It is a plain torch reduction, not a kernel of the JAX
  package's (that one is a ``jax.jit`` program, not a Pallas kernel).
- **anomaly detectors** (memwatch-leak style: typed counters, flight
  recorder, one stderr warning per episode): loss spike vs. EMA z-score,
  sustained divergence (EMA above its best for N steps), plateau, grad
  explosion/vanish, non-finite values.
- **journal**: per-rank ``PADDLE_TPU_DYNAMICS_DIR/dynamics.rank<k>.jsonl``
  (atomic whole-file writes: header line + one JSON line per closed
  step; restart resume; rank re-anchor via monitor.set_trainer_rank;
  a launcher's supervisor sheds persistence).
- **cross-rank desync probe**: :func:`merge_ledgers` compares final-window
  losses across ranks — under data parallelism every rank optimizes the
  same global objective, so a rank whose loss curve drifts from the
  others is a cheap, free correctness probe for broken gradient
  synchronization.

Env knobs (declared in ``flags.py``):
  PADDLE_TPU_DYNAMICS                series + detectors on/off (default on)
  PADDLE_TPU_DYNAMICS_DIR            journal directory (enables persistence)
  PADDLE_TPU_DYNAMICS_FLUSH_STEPS    journal flush cadence in steps (50)
  PADDLE_TPU_DYNAMICS_SAMPLE         per-layer breakdown cadence in steps (25)
  PADDLE_TPU_DYNAMICS_SPIKE_Z        loss-spike z-score threshold (6)
  PADDLE_TPU_DYNAMICS_DIVERGE_STEPS  sustained-divergence window (25 steps)
  PADDLE_TPU_DYNAMICS_PLATEAU_STEPS  no-improvement plateau window (200)
"""
from __future__ import annotations

import atexit
import collections
import glob
import json
import math
import os
import re
import sys
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from . import flags as _flags
from . import monitor as _monitor

__all__ = [
    "DynamicsLedger", "enabled", "ledger", "reset",
    "feed", "end_step", "totals", "summary", "status",
    "should_sample_layers", "grad_health", "layer_breakdown",
    "configure", "disable_persistence", "flush", "journal_path",
    "load_journal", "load_journals", "merge_ledgers", "check_desync",
    "render_summary", "trajectory",
    "SCHEMA", "ANOMALY_KINDS",
]

SCHEMA = "paddle_tpu.dynamics/1"

# recent closed steps kept in memory / persisted per journal rewrite.
# 4096 steps of ~120B records is ~0.5MB — cheap enough to keep whole.
_SERIES_CAP = 4096

# EMA smoothing for loss mean/variance (~ last 20 steps dominate): slow
# enough that a one-step spike stands out of the variance it feeds
_EMA_ALPHA = 0.05
# detectors stay quiet until the EMA has seen this many steps — the
# first steps of a run legitimately move fast
_WARMUP_STEPS = 20
# sustained divergence: EMA this fraction above its best-so-far counts
# as a rising step
_DIVERGE_MARGIN = 0.01
# plateau: an EMA improvement below this fraction of the best loss does
# not reset the no-progress window
_PLATEAU_MIN_DELTA = 1e-4
# gradient-norm episode thresholds (vs. the grad-norm EMA / absolute)
_GRAD_EXPLODE_FACTOR = 25.0
_GRAD_VANISH_FLOOR = 1e-10

ANOMALY_KINDS = ("loss_spike", "divergence", "plateau",
                 "grad_explode", "grad_vanish", "nonfinite")

# the dynamics metric series (mirror of the goodput/memwatch gauges)
_M_LOSS_EMA = _monitor.gauge(
    "dynamics_loss_ema", "EMA of the per-step training loss")
_M_LOSS_Z = _monitor.gauge(
    "dynamics_loss_zscore",
    "z-score of the last closed step's loss against the loss EMA/std")
_M_GRAD_EMA = _monitor.gauge(
    "dynamics_grad_norm_ema", "EMA of the global gradient norm")
_M_UPDATE_RATIO = _monitor.gauge(
    "dynamics_update_ratio",
    "last sampled update-to-weight norm ratio (lr*|grad| / |weight|)")
_M_ANOM = _monitor.counter(
    "dynamics_anomalies_total",
    "training-dynamics anomaly episodes by kind (loss_spike, divergence, "
    "plateau, grad_explode, grad_vanish, nonfinite)", ("kind",))


def enabled() -> bool:
    return _monitor.enabled() and bool(_flags.env_flag("PADDLE_TPU_DYNAMICS"))


def _spike_z() -> float:
    return float(_flags.env_flag("PADDLE_TPU_DYNAMICS_SPIKE_Z"))


def _diverge_steps() -> int:
    return max(2, int(_flags.env_flag("PADDLE_TPU_DYNAMICS_DIVERGE_STEPS")))


def _plateau_steps() -> int:
    return max(2, int(_flags.env_flag("PADDLE_TPU_DYNAMICS_PLATEAU_STEPS")))


def should_sample_layers(step: int) -> bool:
    """Is `step` a per-layer-breakdown sampling step? Every
    PADDLE_TPU_DYNAMICS_SAMPLE-th step (and step 0, so short runs still
    get at least one breakdown). 0 disables the breakdown entirely."""
    if not enabled():
        return False
    every = int(_flags.env_flag("PADDLE_TPU_DYNAMICS_SAMPLE"))
    if every <= 0:
        return False
    return int(step) % every == 0


# the staged scalar keys that may arrive lazy (device futures /
# callables) from the async-loss fit loop
_SCALAR_KEYS = ("loss", "grad_norm", "update_ratio", "lr")


def _is_lazy(v) -> bool:
    """A staged value that is not yet a host scalar: a zero-arg callable
    or a device value (a torch tensor). Host numerics
    (python / numpy scalars, numpy arrays) are never lazy."""
    import numpy as np

    if v is None or isinstance(v, (int, float, np.number, np.bool_,
                                   np.ndarray)):
        return False
    return True


def _stage_scalar(v):
    """feed() staging: host scalars are floated immediately (the
    historical behavior every sync caller keeps); lazy values pass
    through untouched so no device sync happens on the hot path."""
    return v if _is_lazy(v) else float(v)


def _force_scalar(v) -> Optional[float]:
    """Materialize a lazy scalar on the host. A failed force degrades to
    None (an absent reading) — telemetry must never kill the step."""
    import numpy as np

    try:
        if callable(v):
            v = v()
        v = _as_array(v)
        return float(v if hasattr(v, "dim") else np.asarray(v))
    except Exception:  # noqa: BLE001
        return None


class DynamicsLedger:
    """Per-process training-dynamics ledger: the open step's staged
    telemetry, the closed-step series, EMA statistics and the anomaly
    episode state. Thread-safe; `base` holds the journal a restarted
    rank resumed from (its series prefixes this incarnation's, so the
    persisted trajectory spans restarts)."""

    def __init__(self):
        self._lock = threading.RLock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.steps = 0
            self.current_step: Optional[int] = None
            self.open: Dict[str, Any] = {}
            # one-deep finalization pipeline for lazy-fed steps (the
            # async-loss fit loop): the record whose device scalars have
            # not been forced to the host yet
            self._pending: Optional[tuple] = None
            self.last_step: Optional[dict] = None
            self.step_series: collections.deque = collections.deque(
                maxlen=_SERIES_CAP)
            self.loss_ema: Optional[float] = None
            self.loss_var = 0.0
            self.best_loss_ema: Optional[float] = None
            self.grad_ema: Optional[float] = None
            self.diverge_run = 0
            self.plateau_run = 0
            self.anomaly_counts: Dict[str, int] = {
                k: 0 for k in ANOMALY_KINDS}
            self._active: Dict[str, bool] = {k: False for k in ANOMALY_KINDS}
            self.base: Optional[dict] = None
            self.started_unix = time.time()

    # -- recording ------------------------------------------------------
    def feed(self, loss: Optional[float] = None,
             grad_norm: Optional[float] = None,
             update_ratio: Optional[float] = None,
             lr: Optional[float] = None,
             layers: Optional[Dict[str, dict]] = None) -> None:
        """Stage telemetry for the OPEN step; end_step freezes it. Only
        keys actually passed are updated, so producers at different call
        sites (loss from the fit loop, the sampled layer breakdown from
        the grads-alive window) compose into one record."""
        with self._lock:
            if loss is not None:
                self.open["loss"] = _stage_scalar(loss)
            if grad_norm is not None:
                self.open["grad_norm"] = _stage_scalar(grad_norm)
            if update_ratio is not None:
                self.open["update_ratio"] = _stage_scalar(update_ratio)
            if lr is not None:
                self.open["lr"] = _stage_scalar(lr)
            if layers is not None:
                self.open["layers"] = layers

    def _begin_episode(self, kind: str, record: dict, **fields) -> bool:
        """Count an anomaly episode once while its condition holds (the
        memwatch-leak contract). Returns True when this step STARTED the
        episode (the caller emits the one warning)."""
        if self._active[kind]:
            return False
        self._active[kind] = True
        self.anomaly_counts[kind] += 1
        record.setdefault("anomalies", []).append(
            {"kind": kind, **fields})
        return True

    def _end_episode(self, kind: str) -> None:
        self._active[kind] = False

    def end_step(self, step: Optional[int] = None,
                 spike_z: Optional[float] = None,
                 diverge_steps: Optional[int] = None,
                 plateau_steps: Optional[int] = None,
                 warmup: int = _WARMUP_STEPS) -> Optional[dict]:
        """Close the in-flight step: freeze the staged telemetry into the
        series and run every detector against the pre-update EMA stats.
        Returns the closed record (with any started anomaly episodes),
        or None when nothing was fed (an executor-only run: inert)."""
        spike_z = _spike_z() if spike_z is None else float(spike_z)
        diverge_steps = (_diverge_steps() if diverge_steps is None
                         else int(diverge_steps))
        plateau_steps = (_plateau_steps() if plateau_steps is None
                         else int(plateau_steps))
        with self._lock:
            if not self.open:
                return None
            staged, self.open = self.open, {}
            self.steps += 1
            self.current_step = (int(step) if step is not None
                                 else (self.current_step or 0) + 1)
            record: Dict[str, Any] = {
                "step": self.current_step, "t": time.time(), **staged}
            # keep the pipeline FIFO: whatever is still pending finalizes
            # before this step enters it (or before this step finalizes)
            self._drain_locked()
            args = (record, spike_z, diverge_steps, plateau_steps, warmup)
            if any(_is_lazy(record.get(k)) for k in _SCALAR_KEYS):
                # async-loss mode: the step's scalars are still device
                # futures — defer the host force, the EMAs and the
                # detectors one step so the next dispatch overlaps the
                # device finishing this one. The returned record is the
                # un-finalized shell (series/gauges update at drain).
                self._pending = args
                return record
            return self._finalize_record(*args)

    def drain(self) -> None:
        """Force the pending lazy step (if any) through finalization —
        every external view (series/totals/flush) calls this first, so
        readers never observe the one-step pipeline."""
        with self._lock:
            self._drain_locked()

    def _drain_locked(self) -> None:
        pending, self._pending = self._pending, None
        if pending is not None:
            self._finalize_record(*pending)

    def _finalize_record(self, record, spike_z, diverge_steps,
                         plateau_steps, warmup) -> dict:
        """Force any lazy scalars to host floats, then run the sanitize +
        EMA + detector pass and append to the series. Lock held."""
        for k in _SCALAR_KEYS:
            if _is_lazy(record.get(k)):
                record[k] = _force_scalar(record[k])
        staged = record
        # sanitize EVERY non-finite scalar independently (a NaN loss
        # usually comes with NaN grads): poisoned values must not
        # corrupt the EMAs, and the record must stay strict-JSON
        # (json.dumps would emit a bare NaN token that breaks /status
        # and Perfetto consumers) — the episode fields carry the
        # offending values as strings instead
        bad = {k: record[k]
               for k in ("loss", "grad_norm", "update_ratio", "lr")
               if record.get(k) is not None
               and not math.isfinite(float(record[k]))}
        for k in bad:
            record[k] = None
        loss = None if "loss" in bad else staged.get("loss")
        grad = None if "grad_norm" in bad else staged.get("grad_norm")

        if "loss" in bad or "grad_norm" in bad:
            self._begin_episode(
                "nonfinite", record,
                **{k: str(v) for k, v in bad.items()})
        else:
            self._end_episode("nonfinite")

        if loss is not None:
            if self.loss_ema is None:
                self.loss_ema = loss
                self.loss_var = 0.0
            else:
                # z-score against the PRE-update stats: the spike must
                # not dilute the mean/std it is judged against
                std = math.sqrt(max(self.loss_var, 0.0))
                floor = 1e-3 * max(1.0, abs(self.loss_ema))
                z = (loss - self.loss_ema) / max(std, floor)
                record["loss_z"] = round(z, 3)
                if self.steps > warmup and z > spike_z:
                    self._begin_episode("loss_spike", record,
                                        z=round(z, 2), loss=loss)
                else:
                    self._end_episode("loss_spike")
                delta = loss - self.loss_ema
                self.loss_ema += _EMA_ALPHA * delta
                self.loss_var = (1.0 - _EMA_ALPHA) * (
                    self.loss_var + _EMA_ALPHA * delta * delta)
            record["loss_ema"] = self.loss_ema

            # sustained divergence / plateau against the best EMA
            best = self.best_loss_ema
            if best is None:
                self.best_loss_ema = self.loss_ema
            else:
                margin = _DIVERGE_MARGIN * max(abs(best), 1e-12)
                if self.loss_ema > best + margin:
                    self.diverge_run += 1
                else:
                    self.diverge_run = 0
                    self._end_episode("divergence")
                if self.loss_ema < best - _PLATEAU_MIN_DELTA * max(
                        abs(best), 1e-12):
                    self.best_loss_ema = self.loss_ema
                    self.plateau_run = 0
                    self._end_episode("plateau")
                else:
                    self.plateau_run += 1
                if (self.steps > warmup
                        and self.diverge_run >= diverge_steps):
                    self._begin_episode(
                        "divergence", record,
                        steps=self.diverge_run,
                        loss_ema=self.loss_ema, best=best)
                if (self.steps > warmup
                        and self.plateau_run >= plateau_steps):
                    self._begin_episode(
                        "plateau", record, steps=self.plateau_run,
                        best=self.best_loss_ema)

        if grad is not None:
            if grad < _GRAD_VANISH_FLOOR:
                self._begin_episode("grad_vanish", record,
                                    grad_norm=grad)
            else:
                self._end_episode("grad_vanish")
            if self.grad_ema is None:
                self.grad_ema = grad
            else:
                if (self.steps > warmup and self.grad_ema > 0
                        and grad > _GRAD_EXPLODE_FACTOR * self.grad_ema):
                    self._begin_episode(
                        "grad_explode", record, grad_norm=grad,
                        ema=self.grad_ema)
                else:
                    self._end_episode("grad_explode")
                self.grad_ema += _EMA_ALPHA * (grad - self.grad_ema)

        self.last_step = record
        self.step_series.append(record)
        hook = self.on_finalize
        if hook is not None:
            try:
                hook(record)
            except Exception:  # noqa: BLE001 - telemetry must not kill
                pass
        return record

    # the module wires gauge/flight-record/stderr processing here so a
    # deferred (async-loss) record reports its anomalies when its values
    # actually land, not when the shell closed
    on_finalize = None

    # -- views ----------------------------------------------------------
    def series(self, limit: Optional[int] = None) -> List[dict]:
        """The recorded trajectory: resumed-journal prefix + this
        incarnation's closed steps, bounded at the series cap. `limit`
        keeps only the tail — and only copies that much, so a /status
        poll is not 4096 dict copies under the ledger lock."""
        with self._lock:
            self._drain_locked()
            live = list(self.step_series)
        full = list((self.base or {}).get("series", [])) + live
        cap = _SERIES_CAP if limit is None else max(0, int(limit))
        return [dict(s) for s in full[-cap:]] if cap else []

    def totals(self, series_limit: Optional[int] = None) -> Dict[str, Any]:
        with self._lock:
            self._drain_locked()
            steps = self.steps
            counts = dict(self.anomaly_counts)
            doc: Dict[str, Any] = {
                "schema": SCHEMA,
                "rank": _monitor.trainer_rank(),
                "pid": os.getpid(),
                "time_unix": time.time(),
                "current_step": self.current_step,
                "last_step": dict(self.last_step) if self.last_step else None,
                "loss_ema": self.loss_ema,
                "loss_std": math.sqrt(max(self.loss_var, 0.0)),
                "best_loss_ema": self.best_loss_ema,
                "grad_norm_ema": self.grad_ema,
                "active_episodes": [k for k, v in self._active.items() if v],
            }
        if self.base:
            steps += int(self.base.get("steps", 0))
            for k, v in (self.base.get("anomaly_counts") or {}).items():
                if k in counts:
                    counts[k] += int(v)
            doc["resumed_from_journal"] = True
        doc["steps"] = steps
        doc["anomaly_counts"] = counts
        doc["anomalies_total"] = sum(counts.values())
        doc["series"] = self.series(limit=series_limit)
        return doc


_LEDGER = DynamicsLedger()
_JOURNAL_DIR: Optional[str] = None
_FLUSH_STEPS = max(1, int(_flags.env_flag("PADDLE_TPU_DYNAMICS_FLUSH_STEPS")))
_steps_since_flush = 0
_atexit_registered = False


def ledger() -> DynamicsLedger:
    return _LEDGER


def reset() -> None:
    """Drop everything recorded (journal base included); tests."""
    global _steps_since_flush
    _LEDGER.reset()
    _steps_since_flush = 0


def feed(loss: Optional[float] = None, grad_norm: Optional[float] = None,
         update_ratio: Optional[float] = None, lr: Optional[float] = None,
         layers: Optional[Dict[str, dict]] = None) -> None:
    """Stage telemetry for the open step (fit loop, bench, custom
    loops). No-op when dynamics is disabled."""
    if not enabled():
        return
    _LEDGER.feed(loss=loss, grad_norm=grad_norm,
                 update_ratio=update_ratio, lr=lr, layers=layers)


def end_step(step: Optional[int] = None) -> Optional[dict]:
    """Close the dynamics step (called by goodput.end_step, so every
    step loop participates for free). Feeds the metric series, the
    flight recorder and the journal flush cadence; emits ONE stderr
    warning per started anomaly episode."""
    global _steps_since_flush
    if not enabled():
        return None
    closed = _LEDGER.end_step(step=step)
    if closed is None:
        return None
    # gauges, flight records and the one-warning-per-episode stderr line
    # run from the ledger's on_finalize hook (_post_finalize below): for
    # sync steps that already happened inside end_step; an async-loss
    # step reports when its device scalars land (the next step / drain)
    if _JOURNAL_DIR is not None:
        _steps_since_flush += 1
        if _steps_since_flush >= _FLUSH_STEPS:
            _steps_since_flush = 0
            try:
                flush()
            except OSError:
                pass  # a full disk must not kill the training loop
    return closed


def drain() -> None:
    """Finalize the async-loss pipeline's pending step (no-op
    otherwise). Drivers call this at epoch/run boundaries; every
    internal view (totals/series/flush) drains on its own."""
    _LEDGER.drain()


def _post_finalize(closed: dict) -> None:
    if closed.get("loss_ema") is not None:
        _M_LOSS_EMA.set(closed["loss_ema"])
    if closed.get("loss_z") is not None:
        _M_LOSS_Z.set(closed["loss_z"])
    if _LEDGER.grad_ema is not None:
        _M_GRAD_EMA.set(_LEDGER.grad_ema)
    if closed.get("update_ratio") is not None:
        _M_UPDATE_RATIO.set(closed["update_ratio"])
    for a in closed.get("anomalies", ()):
        _M_ANOM.labels(kind=a["kind"]).inc()
        _monitor.flight_record("dynamics", a["kind"], step=closed["step"],
                               **{k: v for k, v in a.items() if k != "kind"})
        detail = ", ".join(f"{k}={v:.4g}" if isinstance(v, float)
                           else f"{k}={v}"
                           for k, v in a.items() if k != "kind")
        print(f"[paddle_tpu_torch.dynamics] {a['kind']} at step "
              f"{closed['step']}: {detail}", file=sys.stderr)


_LEDGER.on_finalize = _post_finalize


def totals(series_limit: Optional[int] = None) -> Dict[str, Any]:
    return _LEDGER.totals(series_limit=series_limit)


def trajectory() -> Dict[str, List[float]]:
    """The recorded loss trajectory as parallel step/loss lists — the
    candidate format tools/curve_gate.py consumes. A resumed run's step
    counter restarts at 0 (the journal prefix keeps the old numbering),
    so a non-monotonic step axis falls back to the record index — the
    interpolation in the gate requires monotonic x."""
    steps, losses = [], []
    for s in _LEDGER.series():
        if s.get("loss") is not None:
            steps.append(s["step"])
            losses.append(s["loss"])
    if any(b <= a for a, b in zip(steps, steps[1:])):
        steps = list(range(len(losses)))
    return {"steps": steps, "loss": losses}


def summary() -> Dict[str, Any]:
    doc = totals(series_limit=0)
    doc.pop("series", None)
    return doc


def status() -> Dict[str, Any]:
    """The /status `dynamics` section: EMA/anomaly state + the recent
    trajectory tail (bounded — the full series stays in the journal)."""
    doc = totals(series_limit=20)
    doc["trajectory_tail"] = doc.pop("series", [])
    return doc


# ---------------------------------------------------------------------------
# fused reductions (global grad norm, per-layer breakdown)
# ---------------------------------------------------------------------------


def _fused_norms(arrays: Sequence[Any]):
    """ONE reduction over the whole tensor list: per tensor the sum of
    squares accumulated in fp32 and the all-finite flag (1.0 or 0.0),
    stacked into one (2, n) fp32 tensor on the first tensor's device
    (numpy arrays are read as CPU tensors, a bfloat16 one widened
    exactly), so the host reads both vectors in one transfer regardless
    of parameter count."""
    import numpy as np
    import torch

    ts = []
    for a in arrays:
        a = _as_array(a)
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a)
            if a.dtype.name == "bfloat16":  # numpy has no bfloat16 of its own
                a = a.astype(np.float32)
            a = torch.from_numpy(np.ascontiguousarray(a))
        ts.append(a)
    dev = ts[0].device
    with torch.no_grad():
        cols = []
        for t in ts:
            x = t.detach().to(device=dev, dtype=torch.float32)
            cols.append(torch.stack([torch.sum(x * x),
                                     torch.isfinite(x).all().float()]))
        return torch.stack(cols, dim=1)


def _host_norms(both):
    """The host's (sum of squares as float64, clamped; finite mask) of a
    :func:`_fused_norms` result, read in one transfer."""
    import numpy as np

    h = both.cpu().double().numpy()
    return _clamp_overflow(h[0]), h[1] > 0.5


def _as_array(value):
    """A gradient or weight as given: a torch tensor, a numpy array, or
    an object that holds its value in ``_value``."""
    inner = getattr(value, "_value", None)
    return inner if inner is not None else value


def _clamp_overflow(sq):
    """f32 sum-of-squares can overflow to inf on explosion-scale grads
    whose every ELEMENT is still finite (f64 accumulation is unavailable
    under the x64-disabled JAX config this runs on). Clamp to f32-max so
    the norm stays finite-huge: the episode classifies as grad_explode —
    the truth — instead of nonfinite, and the value stays strict-JSON."""
    import numpy as np

    return np.where(np.isfinite(sq), sq, float(np.finfo(np.float32).max))


def grad_health_deferred(named_grads: Iterable[Tuple[str, Any]]):
    """Launch the fused grad-norm reduction NOW, pay the host transfer
    LATER: returns a memoized zero-arg callable -> (norm, bad_names).
    A loop can force it one step behind, overlapping the device's work
    with the next step's launch."""
    names, arrays = [], []
    for name, g in named_grads:
        if g is None:
            continue
        names.append(name)
        arrays.append(_as_array(g))
    if not arrays:
        return lambda: (0.0, [])
    both = _fused_norms(arrays)  # device launches only — no transfer

    cell: List[Tuple[float, List[str]]] = []

    def force() -> Tuple[float, List[str]]:
        if not cell:
            import numpy as np

            sq_h, fin_h = _host_norms(both)
            bad = [n for n, ok in zip(names, fin_h) if not ok]
            # a non-finite square can still sum to a finite garbage value
            # on some backends; trust the explicit finite mask, not the sum
            norm = (float(np.sqrt(sq_h[fin_h].sum()))
                    if fin_h.any() else 0.0)
            cell.append((norm, bad))
        return cell[0]

    return force


def grad_health(named_grads: Iterable[Tuple[str, Any]]
                ) -> Tuple[float, List[str]]:
    """Global gradient norm + the names of non-finite gradients, via the
    fused reduction (replaces the per-tensor host loop between backward
    and step). Non-finite tensors are excluded from the norm so the
    gauge stays useful while the poisoned names are reported."""
    return grad_health_deferred(named_grads)()


def layer_breakdown(named_params: Iterable[Tuple[str, Any, Any]],
                    lr: Optional[float] = None,
                    depth: int = 1) -> Dict[str, dict]:
    """Per-layer-prefix grad/weight/update norms in ONE fused
    reduction: `named_params` yields (qualified_name, weight, grad)
    triples; groups are the first `depth` dotted segments (the
    footprint() convention). The update norm is the SGD-style
    ``lr * grad_norm`` estimate (optimizer-family-exact update vectors
    would need a param snapshot per step); ``update_ratio`` =
    update_norm / weight_norm is the per-group learning-velocity signal
    (healthy training sits around 1e-3; ~0 means frozen, ~1e-1 means
    thrashing). Returns {group: {grad_norm, weight_norm, update_norm,
    update_ratio, n_tensors}}."""
    groups: List[str] = []
    arrays: List[Any] = []
    kinds: List[str] = []  # "w" or "g", interleaved in one device call
    for qual, w, g in named_params:
        group = ".".join(qual.split(".")[:depth]) or qual
        if w is not None:
            groups.append(group)
            arrays.append(_as_array(w))
            kinds.append("w")
        if g is not None:
            groups.append(group)
            arrays.append(_as_array(g))
            kinds.append("g")
    if not arrays:
        return {}
    sq, fin = _host_norms(_fused_norms(arrays))
    out: Dict[str, dict] = {}
    acc: Dict[str, Dict[str, float]] = {}
    for group, kind, s, ok in zip(groups, kinds, sq, fin):
        a = acc.setdefault(group, {"w": 0.0, "g": 0.0, "n": 0})
        a["n"] += 1
        if ok:
            a[kind] += float(s)
    for group, a in acc.items():
        wn = math.sqrt(a["w"])
        gn = math.sqrt(a["g"])
        row = {"grad_norm": round(gn, 8), "weight_norm": round(wn, 8),
               "n_tensors": a["n"]}
        if lr is not None:
            un = abs(float(lr)) * gn
            row["update_norm"] = round(un, 10)
            row["update_ratio"] = round(un / wn, 10) if wn > 0 else None
        out[group] = row
    return out


# ---------------------------------------------------------------------------
# journal persistence (the goodput/memwatch contract, line-oriented:
# header line + one JSON line per closed step)
# ---------------------------------------------------------------------------


def journal_path(dir: Optional[str] = None) -> str:
    base = dir or _JOURNAL_DIR or "."
    return os.path.join(base,
                        f"dynamics.rank{_monitor.trainer_rank()}.jsonl")


def configure(dir: Optional[str] = None,
              flush_steps: Optional[int] = None,
              resume: bool = True) -> None:
    """Set up journal persistence; with `resume`, an existing journal
    seeds the step count, anomaly totals and the trajectory prefix — but
    only while the in-process ledger is still pristine (the goodput
    double-count guard)."""
    global _JOURNAL_DIR, _FLUSH_STEPS, _atexit_registered
    if dir:
        _JOURNAL_DIR = dir
        pristine = (_LEDGER.base is None and _LEDGER.steps == 0
                    and not _LEDGER.open)
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
    if flush_steps is not None:
        _FLUSH_STEPS = max(1, int(flush_steps))


def disable_persistence() -> None:
    """Supervisor hook (a launcher): its own exit must never clobber a
    real rank's journal."""
    global _JOURNAL_DIR
    _JOURNAL_DIR = None


def _rank_changed() -> None:
    """monitor.set_trainer_rank() notification — mirror of
    goodput._rank_changed: drop the old identity's base, re-resume
    against the new rank's journal while still pristine."""
    if _JOURNAL_DIR is None:
        return
    _LEDGER.base = None
    if _LEDGER.steps == 0 and not _LEDGER.open:
        path = journal_path()
        if os.path.exists(path):
            try:
                _LEDGER.base = load_journal(path)
            except (OSError, ValueError):
                _LEDGER.base = None


def _flush_at_exit() -> None:
    try:
        flush()
    except OSError:
        pass


def flush(path: Optional[str] = None) -> Optional[str]:
    """Write the journal (atomic temp + os.replace, like every other
    ledger): line 1 is the header doc, each following line one closed
    step — greppable, tail-able, and append-shaped without sacrificing
    the atomicity whole-file replacement buys. No-op when persistence is
    unconfigured and no path given."""
    if path is None:
        if _JOURNAL_DIR is None:
            return None
        path = journal_path()
    doc = totals()
    series = doc.pop("series", [])
    lines = [json.dumps(doc)]
    lines.extend(json.dumps(s) for s in series)
    return _monitor.atomic_write_text(path, "\n".join(lines) + "\n")


def load_journal(path: str) -> Dict[str, Any]:
    """Read a dynamics journal back into one doc: the header fields plus
    the step records under "series"."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    if not lines:
        raise ValueError(f"{path}: empty dynamics journal")
    header = json.loads(lines[0])
    if header.get("schema") != SCHEMA:
        raise ValueError(f"{path}: not a dynamics journal (schema "
                         f"{header.get('schema')!r})")
    header["series"] = [json.loads(ln) for ln in lines[1:]]
    return header


_JOURNAL_FILE_RE = re.compile(r"dynamics\.rank(\d+)\.jsonl$")


def load_journals(dir: str,
                  ranks: Optional[Sequence[int]] = None
                  ) -> Optional[Dict[str, Any]]:
    """Merge per-rank dynamics journals in `dir` (launch teardown,
    obs_report --dynamics). `ranks` limits to this job's membership."""
    want = set(int(r) for r in ranks) if ranks is not None else None
    docs = []
    for path in sorted(glob.glob(os.path.join(dir, "dynamics.rank*.jsonl"))):
        try:
            doc = load_journal(path)
        except (OSError, ValueError):
            continue
        if want is None or int(doc.get("rank", -1)) in want:
            docs.append(doc)
    return merge_ledgers(docs) if docs else None


# the desync probe's final-comparison window (closed steps per rank) and
# the default relative spread tolerance: under data parallelism every
# rank sees the same allreduced gradients, so curves should agree to
# well under 5% — a larger spread means the ranks are optimizing
# different objectives (broken grad sync, skewed sharding, a bad host)
DESYNC_WINDOW = 5
DESYNC_TOLERANCE = 0.05


def _final_window_loss(doc: Dict[str, Any],
                       window: int = DESYNC_WINDOW) -> Optional[float]:
    losses = [s["loss"] for s in doc.get("series", [])
              if s.get("loss") is not None
              and math.isfinite(float(s["loss"]))]
    if not losses:
        return None
    tail = losses[-window:]
    return sum(tail) / len(tail)


def check_desync(docs: List[Dict[str, Any]],
                 tolerance: float = DESYNC_TOLERANCE,
                 window: int = DESYNC_WINDOW) -> Dict[str, Any]:
    """Cross-rank loss-spread probe: compare each rank's final-window
    mean loss against the cross-rank median. Ranks deviating more than
    `tolerance` (relative) are desync suspects. Needs >= 2 ranks with
    recorded losses; `checked` is False otherwise."""
    finals: Dict[str, float] = {}
    for d in docs:
        val = _final_window_loss(d, window)
        if val is not None:
            finals[str(d.get("rank", len(finals)))] = val
    if len(finals) < 2:
        return {"checked": False, "n_ranks": len(finals),
                "tolerance": tolerance}
    ordered = sorted(finals.values())
    mid = len(ordered) // 2
    median = (ordered[mid] if len(ordered) % 2
              else 0.5 * (ordered[mid - 1] + ordered[mid]))
    scale = max(abs(median), 1e-12)
    deviation = {r: abs(v - median) / scale for r, v in finals.items()}
    suspects = sorted((r for r, dev in deviation.items()
                       if dev > tolerance), key=int)
    return {
        "checked": True,
        "n_ranks": len(finals),
        "window": window,
        "tolerance": tolerance,
        "median_loss": median,
        "spread": (max(ordered) - min(ordered)) / scale,
        "per_rank_loss": {r: finals[r] for r in sorted(finals, key=int)},
        "suspects": suspects,
        "ok": not suspects,
    }


def merge_ledgers(docs: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Cross-rank view: per-rank final losses and anomaly counts listed
    individually, anomaly totals summed, plus the desync probe verdict
    (the cheap DP-correctness check a launcher prints at teardown)."""
    per_rank: Dict[str, dict] = {}
    counts: Dict[str, int] = {k: 0 for k in ANOMALY_KINDS}
    steps = 0
    for d in docs:
        r = str(d.get("rank", len(per_rank)))
        rc = d.get("anomaly_counts") or {}
        per_rank[r] = {
            "steps": int(d.get("steps", 0)),
            "final_loss": _final_window_loss(d, 1),
            "final_window_loss": _final_window_loss(d),
            "loss_ema": d.get("loss_ema"),
            "anomalies_total": sum(int(v) for v in rc.values()),
        }
        for k in ANOMALY_KINDS:
            counts[k] += int(rc.get(k, 0))
        steps = max(steps, per_rank[r]["steps"])
    return {
        "schema": SCHEMA,
        "ranks": sorted(per_rank, key=int),
        "steps": steps,
        "anomaly_counts": counts,
        "anomalies_total": sum(counts.values()),
        "per_rank": dict(sorted(per_rank.items(), key=lambda kv: int(kv[0]))),
        "desync": check_desync(docs),
    }


def render_summary(doc: Dict[str, Any], title: str = "dynamics") -> str:
    """Human-readable one-glance table (launch teardown, obs_report)."""
    lines = [f"== {title}: {doc.get('steps', 0)} step(s), "
             f"{doc.get('anomalies_total', 0)} anomaly episode(s) =="]
    if doc.get("per_rank"):
        for r, row in doc["per_rank"].items():
            fl = row.get("final_window_loss")
            lines.append(
                f"  rank{r}: final_loss="
                f"{'-' if fl is None else f'{fl:.5f}'} "
                f"steps={row['steps']} anomalies={row['anomalies_total']}")
    elif doc.get("loss_ema") is not None:
        lines.append(f"  loss_ema={doc['loss_ema']:.5f} "
                     f"grad_norm_ema={doc.get('grad_norm_ema') or 0:.4g}")
    counts = {k: v for k, v in (doc.get("anomaly_counts") or {}).items()
              if v}
    if counts:
        lines.append("  episodes: " + ", ".join(
            f"{k}={v}" for k, v in sorted(counts.items())))
    desync = doc.get("desync")
    if desync and desync.get("checked"):
        if desync["suspects"]:
            lines.append(
                f"  DESYNC: rank(s) {','.join(desync['suspects'])} "
                f"deviate >{desync['tolerance'] * 100:.0f}% from the "
                f"cross-rank median loss (spread "
                f"{desync['spread'] * 100:.1f}%) — check gradient "
                f"synchronization")
        else:
            lines.append(
                f"  desync probe: OK ({desync['n_ranks']} rank(s), "
                f"loss spread {desync['spread'] * 100:.2f}%)")
    return "\n".join(lines)


# env-driven wiring: under a launcher (or a user export) every rank
# persists its dynamics journal with no code change
_env_dir = _flags.env_flag("PADDLE_TPU_DYNAMICS_DIR")
if _env_dir:
    try:
        os.makedirs(_env_dir, exist_ok=True)
        configure(dir=_env_dir)
    except OSError:
        pass  # unwritable dir: telemetry stays in-process only
