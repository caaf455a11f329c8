"""High-level Model API: prepare / fit / evaluate / predict / save / load.

Port of ``paddle_tpu/hapi/model.py``: ``Model`` over an eager
``nn.Layer``, its step primitives (``train_batch``, ``eval_batch``,
``predict_batch``), the fit loop with its callbacks, and the loop's
feeds of the step-side layer: the goodput ledger's step windows, memwatch
samples, the dynamics series (with ``_grad_health`` and the sampled layer
breakdown), the chaos ``kill_rank`` site, the hang watchdog's heartbeat
and the full-state checkpoints of ``checkpoint.py``
(``PADDLE_TPU_CKPT_DIR``).

The asynchronous loss (``PADDLE_TPU_ASYNC_LOSS``, on by default) starts a
non-blocking copy of each step's loss into pinned host memory behind a
CUDA event and reads it when a consumer forces it (a step later, in the
loop), so the loop never waits on the card for a per-step ``.item()``.

A network with the data-parallel hooks (``scale_loss``,
``apply_collective_grads``) raises ``errors.Unimplemented``: the
dygraph ``DataParallel`` waits in ROADMAP queue A, item A10.
"""
from __future__ import annotations

import os
import sys
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import chaos as _chaos
from .. import checkpoint as _checkpoint
from .. import dynamics as _dynamics
from .. import flags as _flags
from .. import goodput as _goodput
from .. import memwatch as _memwatch
from .. import monitor as _monitor
from .. import nn
from .. import profiler as _profiler
from ..dygraph.varbase import Tensor
from ..framework import errors as _errs
from ..io import DataLoader
from ..metric import Metric
from .model_io import load as _load
from .model_io import save as _save

# fit-loop telemetry: per-step wall time and instantaneous throughput
_M_STEP_T = _monitor.histogram(
    "fit_step_seconds", "Model.fit train_batch wall time",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0, 30.0))
_M_STEPS = _monitor.counter("fit_steps_total", "Model.fit train steps run")
_M_TPS = _monitor.gauge(
    "fit_samples_per_sec", "throughput of the most recent fit step")
# loss/grad health (the numerics-sentinel counterpart for the dygraph
# engine, where no compiled-block probes exist): always-on loss gauges,
# plus a global grad-norm scan when PADDLE_TPU_CHECK_NUMERICS=1
_M_LOSS = _monitor.gauge("fit_loss", "loss of the most recent fit step")
_M_LOSS_BAD = _monitor.counter(
    "fit_loss_nonfinite_total", "fit steps whose loss came back nan/inf")
_M_GRAD_NORM = _monitor.gauge(
    "fit_grad_norm", "global gradient norm of the last checked fit step")
_M_GRAD_BAD = _monitor.counter(
    "fit_grad_nonfinite_total",
    "parameters whose gradient held nan/inf at a checked fit step")
_M_LOSS_DEFER = _monitor.counter(
    "fit_loss_readback_deferred_total",
    "fit steps whose loss readback was pipelined one step behind the "
    "dispatch (PADDLE_TPU_ASYNC_LOSS) instead of blocking the loop")


class Input:
    """Static-graph input spec (reference hapi InputSpec equivalent)."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = shape
        self.dtype = dtype
        self.name = name


class Callback:
    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass


class ProgBarLogger(Callback):
    """Reference hapi/callbacks.py ProgBarLogger (line-per-epoch variant)."""

    def __init__(self, log_freq: int = 100, verbose: int = 1):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._t0 = time.time()

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            items = " - ".join(f"{k}: {v:.4f}" for k, v in (logs or {}).items())
            print(f"epoch {self._epoch} step {step}: {items}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            items = " - ".join(f"{k}: {v:.4f}" for k, v in (logs or {}).items())
            print(f"epoch {epoch} done in {time.time() - self._t0:.1f}s - {items}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq: int = 1, save_dir: Optional[str] = None):
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            self.model.save(os.path.join(self.save_dir, str(epoch)))


class EarlyStopping(Callback):
    """Reference hapi/callbacks.py EarlyStopping: stop fit() when the
    monitored metric stops improving for `patience` epochs; optionally
    keep the best weights on disk."""

    def __init__(self, monitor: str = "loss", mode: str = "auto",
                 patience: int = 0, verbose: int = 1, min_delta: float = 0.0,
                 baseline: Optional[float] = None,
                 save_best_model: bool = False, save_dir: Optional[str] = None):
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        self.save_dir = save_dir
        if mode == "max" or (mode == "auto" and ("acc" in monitor
                                                 or monitor.endswith("auc"))):
            self._better = lambda cur, best: cur > best + self.min_delta
            self.best = -np.inf
        else:
            self._better = lambda cur, best: cur < best - self.min_delta
            self.best = np.inf
        if baseline is not None:
            self.best = baseline
        self.wait = 0
        self.stopped_epoch = -1

    def on_train_begin(self, logs=None):
        self.wait = 0

    def on_epoch_end(self, epoch, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        if self._better(float(cur), self.best):
            self.best = float(cur)
            self.wait = 0
            if self.save_best_model and self.save_dir:
                self.model.save(os.path.join(self.save_dir, "best_model"))
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped_epoch = epoch
                self.model.stop_training = True
                if self.verbose:
                    print(f"Epoch {epoch}: early stopping "
                          f"(best {self.monitor}={self.best:.5f})")


class LRSchedulerCallback(Callback):
    """Reference hapi/callbacks.py LRScheduler: drive the optimizer's
    LRScheduler once per epoch (default) or per `by_step` batches;
    ReduceOnPlateau consumes the monitored metric."""

    def __init__(self, by_step: bool = False, by_epoch: bool = True,
                 monitor: str = "loss"):
        self.by_step = by_step
        self.by_epoch = by_epoch
        self.monitor = monitor

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if hasattr(lr, "step") else None

    def on_train_batch_end(self, step, logs=None):
        sched = self._sched()
        if self.by_step and sched is not None:
            sched.step()

    def on_epoch_end(self, epoch, logs=None):
        sched = self._sched()
        if not self.by_epoch or sched is None:
            return
        try:  # ReduceOnPlateau steps on the monitored metric
            from ..optimizer.lr import ReduceOnPlateau

            if isinstance(sched, ReduceOnPlateau):
                cur = (logs or {}).get(self.monitor)
                if cur is not None:
                    sched.step(metrics=float(cur))
                return
        except ImportError:
            pass
        sched.step()


# reference name alias (paddle.callbacks.LRScheduler)
LRScheduler = LRSchedulerCallback


class _LazyLossValue:
    """Float-like view of a step's loss: a non-blocking copy to pinned
    host memory started at the step, behind a CUDA event; the first
    numeric use (float()/format()/call) waits on the event and reads it.
    Memoized: every consumer (metrics gauge, dynamics record, ProgBar
    format, epoch logs) pays the wait at most once, and by the time
    anyone forces it the card has had a whole step of lead."""

    __slots__ = ("_host", "_event", "_val")

    def __init__(self, tensor):
        t = getattr(tensor, "_value", tensor)
        self._val = None
        self._event = None
        if isinstance(t, torch.Tensor) and t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype,
                                     pin_memory=True)
            self._host.copy_(t.detach(), non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t

    def value(self) -> float:
        if self._val is None:
            if self._event is not None:
                self._event.synchronize()
            t = self._host
            self._val = float(t.detach().float().cpu().reshape(-1)[0]
                              if isinstance(t, torch.Tensor)
                              else np.asarray(t).reshape(-1)[0])
            self._host = self._event = None  # drop the buffer once read
        return self._val

    __float__ = value
    __call__ = value  # the dynamics lazy-scalar protocol

    def __format__(self, spec):
        return format(self.value(), spec)

    def __repr__(self):
        return repr(self.value())

    # the pre-async logs["loss"] contract was a plain float: user
    # callbacks comparing or accumulating it must keep working (each
    # numeric use forces the memoized value)
    def __lt__(self, other):
        return self.value() < other

    def __le__(self, other):
        return self.value() <= other

    def __gt__(self, other):
        return self.value() > other

    def __ge__(self, other):
        return self.value() >= other

    def __eq__(self, other):
        return self.value() == other

    def __ne__(self, other):
        return self.value() != other

    def __hash__(self):
        return hash(self.value())

    def __add__(self, other):
        return self.value() + other

    __radd__ = __add__

    def __sub__(self, other):
        return self.value() - other

    def __rsub__(self, other):
        return other - self.value()

    def __mul__(self, other):
        return self.value() * other

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self.value() / other

    def __rtruediv__(self, other):
        return other / self.value()

    def __neg__(self):
        return -self.value()

    def __abs__(self):
        return abs(self.value())


class Model:
    """Model(network) -> prepare(optimizer, loss, metrics) -> fit(...)."""

    def __init__(self, network: nn.Layer, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self.stop_training = False
        self._global_step = 0
        # per-step dynamics telemetry staged by train_batch (grads are
        # alive only there), consumed by the fit loop's feed
        self._last_grad_norm = None
        self._last_update_ratio = None
        self._last_layer_breakdown = None

    # -- setup ----------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is None:
            self._metrics = []
        else:
            self._metrics = list(metrics) if isinstance(metrics, (list, tuple)) else [metrics]
        return self

    # -- step primitives (reference model.py train_batch/eval_batch) ----
    def train_batch(self, inputs, labels=None):
        losses, metrics = self._train_batch_raw(inputs, labels, sync=True)
        return losses, metrics

    def _train_batch_raw(self, inputs, labels=None, sync: bool = True):
        """One training step. With ``sync`` the returned loss is a host
        float (the public train_batch contract — a blocking device
        readback); without it the loss stays a device future wrapped in
        :class:`_LazyLossValue` and the grad-health reduction's transfer
        defers with it — the async fit loop's host-sync purge."""
        # a DataParallel network takes the reference's collective path
        # (pre-scaled loss, bucketed grad hooks), which waits for A10
        if hasattr(self.network, "scale_loss") and \
                hasattr(self.network, "apply_collective_grads"):
            raise _errs.errors.Unimplemented(
                "Model.fit over a DataParallel network is not ported to "
                "paddle_tpu_torch yet (ROADMAP.md queue A, item A10)")
        self.network.train()
        inputs, labels = self._split(inputs, labels)
        preds = self.network(*inputs)
        loss = self._compute_loss(preds, labels)
        loss.backward()
        # grads exist only in this window (step/clear_grad consume them):
        # the numerics sentinel and the dynamics telemetry scan them
        # here, before the update — one fused reduction (in async
        # mode only the dispatch happens here; the small host transfer
        # rides the deferred force)
        check = bool(_flags.env_flag("PADDLE_TPU_CHECK_NUMERICS"))
        self._last_grad_norm = None
        self._last_update_ratio = None
        self._last_layer_breakdown = None
        if check or _dynamics.enabled():
            self._last_grad_norm = self._grad_health(
                raise_on_bad=check, defer=not sync and not check)
            if _dynamics.should_sample_layers(self._global_step):
                self._sample_layer_breakdown()
        self._optimizer.step()
        self._optimizer.clear_grad()
        metrics = self._update_metrics(preds, labels)
        if sync:
            return [float(np.asarray(loss.numpy()))], metrics
        return [_LazyLossValue(loss)], metrics

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs, labels = self._split(inputs, labels)
        preds = self.network(*inputs)
        loss = self._compute_loss(preds, labels)
        metrics = self._update_metrics(preds, labels)
        return [float(np.asarray(loss.numpy()))], metrics

    def predict_batch(self, inputs):
        self.network.eval()
        inputs, _ = self._split(inputs, None)
        preds = self.network(*inputs)
        if isinstance(preds, (list, tuple)):
            return [np.asarray(p.numpy()) for p in preds]
        return [np.asarray(preds.numpy())]

    # -- loops ----------------------------------------------------------
    def fit(
        self,
        train_data=None,
        eval_data=None,
        batch_size: int = 1,
        epochs: int = 1,
        eval_freq: int = 1,
        log_freq: int = 100,
        save_dir: Optional[str] = None,
        save_freq: int = 1,
        verbose: int = 1,
        drop_last: bool = False,
        shuffle: bool = True,
        num_workers: int = 0,
        callbacks: Optional[Sequence[Callback]] = None,
    ):
        assert self._optimizer is not None, "call prepare() first"
        if train_data is None:
            raise ValueError("Model.fit requires train_data (a Dataset or DataLoader)")
        loader = self._to_loader(train_data, batch_size, shuffle, drop_last)
        eval_loader = (
            self._to_loader(eval_data, batch_size, False, False) if eval_data is not None else None
        )
        cbs = list(callbacks or []) + [ProgBarLogger(log_freq, verbose)]
        if save_dir:
            cbs.append(ModelCheckpoint(save_freq, save_dir))
        for cb in cbs:
            cb.set_model(self)

        history = {"loss": []}
        self.stop_training = False  # a prior EarlyStopping must not leak
        # fault-plane wiring: with PADDLE_TPU_CKPT_DIR set, fit
        # checkpoints the FULL training state (params + optimizer incl.
        # __dp_comms__ EF residuals + step counter + data/RNG cursor)
        # every PADDLE_TPU_CKPT_STEPS closed steps, and a respawned rank
        # auto-resumes from the newest checkpoint instead of step 0
        ckpt = _checkpoint.from_env()
        start_epoch, skip_steps = 0, 0
        if ckpt is not None:
            doc = ckpt.load_latest()
            if doc is not None:
                self._global_step = ckpt.restore(
                    self.network, self._optimizer, doc)
                cursor = doc.get("data_cursor") or {}
                start_epoch = int(cursor.get("epoch", 0))
                skip_steps = int(cursor.get("step_in_epoch", 0))
                print(f"[checkpoint] resumed at step {self._global_step} "
                      f"(epoch {start_epoch}, step-in-epoch {skip_steps}, "
                      f"digest {doc.get('digest', '')[:12]})",
                      file=sys.stderr, flush=True)
        for cb in cbs:
            cb.on_train_begin()
        # pipelined loss readback (the host-sync purge): the per-step
        # float() of the loss blocks the loop until the device finishes
        # the step; in async mode the readback defers one step — the
        # NEXT step's dispatch overlaps the device draining this one,
        # and consumers (gauges, dynamics, ProgBar) force the memoized
        # value when they actually need it. The numerics sentinel
        # implies sync semantics (its raise must name the right step).
        async_loss = (
            bool(_flags.env_flag("PADDLE_TPU_ASYNC_LOSS"))
            and not bool(_flags.env_flag("PADDLE_TPU_CHECK_NUMERICS")))
        self._pending_loss: Optional[_LazyLossValue] = None

        def flush_pending_loss():
            pend, self._pending_loss = self._pending_loss, None
            if pend is None:
                return
            v = pend.value()
            _M_LOSS.set(v)
            if not np.isfinite(v):
                _M_LOSS_BAD.inc()
        for epoch in range(start_epoch, epochs):
            for cb in cbs:
                cb.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            # the data/RNG cursor's anchor: the loader draws this
            # epoch's shuffle permutation from the global numpy RNG when
            # iteration starts, so the checkpoint must carry the state
            # from BEFORE that draw — a resumed rank then re-draws the
            # SAME permutation and the fast-forward skips exactly the
            # samples the crashed run already trained
            epoch_rng = np.random.get_state() if ckpt is not None else None
            # goodput step window: opens before the loader take, so the
            # DataLoader's input_wait lands inside the step it stalls;
            # attribution from outside any window (an eval pass between
            # epochs, a warmup predict) is discarded, not folded in
            _goodput.discard_open()
            iter_t0 = time.perf_counter()
            for step, batch in enumerate(loader):
                if epoch == start_epoch and step < skip_steps:
                    # resume fast-forward: these batches completed before
                    # the crash — consume (never train) them so the data
                    # order stays aligned with the uninterrupted run,
                    # and keep their wait out of the first real step
                    _goodput.discard_open()
                    iter_t0 = time.perf_counter()
                    continue
                ins, labels = self._unpack(batch)
                # step-scoped tracing: the global step survives epochs so
                # merged timelines stay monotonic per rank
                gstep = self._global_step
                # chaos site: an armed kill_rank@step dies HERE, at the
                # open of the target global step — deterministic rank
                # loss for the recovery tests (chaos.py)
                _chaos.kill_rank(gstep)
                _profiler.set_step(gstep)
                gp_mark = _goodput.mark()
                t0 = time.perf_counter()
                with _profiler.span("fit/step", cat="step"):
                    losses, metrics = self._train_batch_raw(
                        ins, labels, sync=not async_loss)
                dt = time.perf_counter() - t0
                # the train_batch window is device compute, minus any
                # bucketed time recorded inside it (a compile, an eager
                # collective) so nothing counts twice
                _goodput.add("device_compute",
                             dt - (_goodput.mark() - gp_mark))
                # device-memory watermark at the point the step's
                # activations+grads are (or were just) live; the ledger
                # step closes inside goodput.end_step below
                _memwatch.sample()
                self._global_step = gstep + 1
                _monitor.note_progress(gstep)  # hang-watchdog heartbeat
                _M_STEP_T.observe(dt)
                _M_STEPS.inc()
                if async_loss:
                    # force LAST step's loss (a full step of device lead:
                    # usually ready, ~0 wait), then stage this one
                    flush_pending_loss()
                    self._pending_loss = losses[0]
                    loss_val = losses[0]  # lazy float-like
                    _M_LOSS_DEFER.inc()
                else:
                    loss_val = float(losses[0])
                    _M_LOSS.set(loss_val)
                    if not np.isfinite(loss_val):
                        _M_LOSS_BAD.inc()
                        if bool(_flags.env_flag(
                                "PADDLE_TPU_CHECK_NUMERICS")):
                            raise _errs.errors.InvalidArgument(
                                f"check_numerics: non-finite loss "
                                f"{loss_val!r} at global step {gstep}")
                first = ins[0] if isinstance(ins, (list, tuple)) else ins
                n = getattr(first, "shape", None)
                if n and dt > 0:
                    _M_TPS.set(float(n[0]) / dt)
                # training-dynamics series: the step's loss/grad/lr
                # telemetry staged here closes with the ledger step in
                # goodput.end_step below (shared step boundary)
                if _dynamics.enabled():
                    try:
                        lr = float(self._optimizer.get_lr())
                    except Exception:
                        lr = None
                    _dynamics.feed(
                        loss=loss_val,
                        grad_norm=self._last_grad_norm,
                        update_ratio=self._last_update_ratio,
                        lr=lr,
                        layers=self._last_layer_breakdown)
                logs = {"loss": losses[0], **metrics}
                for cb in cbs:
                    cb.on_train_batch_end(step, logs)
                # close the ledger step over the full loop iteration
                # (loader wait + batch + callbacks); remainder of the
                # wall clock becomes host_other
                _goodput.end_step(
                    time.perf_counter() - iter_t0,
                    samples=float(n[0]) if n else None, step=gstep)
                if ckpt is not None:
                    # cadence checkpoint AFTER the ledger step closes, so
                    # a kill between here and the next step loses only
                    # steps the next resume will honestly re-run
                    ckpt.maybe_save(
                        self.network, self._optimizer,
                        step=self._global_step,
                        data_cursor={"epoch": epoch,
                                     "step_in_epoch": step + 1},
                        rng_state=epoch_rng)
                iter_t0 = time.perf_counter()
            # epoch boundary: the pipeline's tail flushes EXACTLY — the
            # last step's loss lands in the gauges/dynamics series and
            # the epoch-end logs are real floats, not futures
            flush_pending_loss()
            if async_loss:
                _dynamics.drain()
            if isinstance(logs.get("loss"), _LazyLossValue):
                logs = dict(logs, loss=logs["loss"].value())
            history["loss"].append(logs.get("loss"))
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                logs.update(self.evaluate_with_loader(eval_loader, verbose=0))
            for cb in cbs:
                cb.on_epoch_end(epoch, logs)
            if self.stop_training:
                break
        for cb in cbs:
            cb.on_train_end()
        # the final epoch's eval pass (and anything after the last step)
        # ran outside a step window: drop it so the exit-flushed journal
        # and the live bucket view stay consistent with the closed wall
        _goodput.discard_open()
        return history

    def evaluate(self, eval_data, batch_size: int = 1, verbose: int = 1, num_workers: int = 0):
        loader = self._to_loader(eval_data, batch_size, False, False)
        return self.evaluate_with_loader(loader, verbose)

    def evaluate_with_loader(self, loader, verbose: int = 1):
        for m in self._metrics:
            m.reset()
        losses = []
        metrics = {}
        for batch in loader:
            ins, labels = self._unpack(batch)
            l, metrics = self.eval_batch(ins, labels)
            losses.append(l[0])
        out = {"eval_loss": float(np.mean(losses)) if losses else 0.0}
        out.update({f"eval_{k}": v for k, v in metrics.items()})
        if verbose:
            print(" - ".join(f"{k}: {v:.4f}" for k, v in out.items()))
        return out

    def predict(self, test_data, batch_size: int = 1, num_workers: int = 0, stack_outputs: bool = False):
        import inspect

        loader = self._to_loader(test_data, batch_size, False, False)
        # a labeled dataset may be passed for prediction (reference hapi
        # allows it); feed only as many leading elements as forward accepts
        try:
            n_in = len(
                [
                    p for p in inspect.signature(self.network.forward).parameters.values()
                    if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                ]
            )
        except (TypeError, ValueError):
            n_in = None
        outputs = []
        for batch in loader:
            ins, _ = self._unpack(batch, has_label=False)
            if n_in is not None and len(ins) > n_in:
                ins = ins[:n_in]
            outputs.append(self.predict_batch(ins))
        n_out = len(outputs[0])
        grouped = [[o[i] for o in outputs] for i in range(n_out)]
        if stack_outputs:
            grouped = [np.concatenate(g) for g in grouped]
        return grouped

    # -- save/load -------------------------------------------------------
    def save(self, path: str, training: bool = True):
        _save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path: str, skip_mismatch: bool = False, reset_optimizer: bool = False):
        self.network.set_state_dict(_load(path + ".pdparams"))
        opt_path = path + ".pdopt"
        if not reset_optimizer and self._optimizer is not None and os.path.exists(opt_path):
            self._optimizer.set_state_dict(_load(opt_path))

    def parameters(self):
        return self.network.parameters()

    # -- numerics / footprint -------------------------------------------
    def _grad_health(self, raise_on_bad: bool = False,
                     defer: bool = False):
        """Global grad norm + non-finite scan over every parameter grad,
        computed by ONE fused reduction (dynamics.grad_health) —
        a single device dispatch and one small host transfer instead of
        the per-tensor host loop this used to run. Feeds the fit_grad_*
        series; with raise_on_bad, a poisoned grad surfaces as a typed
        error naming the parameters it hit. With ``defer`` (async fit
        loop) only the reduction dispatches here — a memoized zero-arg
        callable carries the transfer + gauge updates to the point the
        value is actually consumed."""
        force = _dynamics.grad_health_deferred(
            (name, getattr(p, "grad", None))
            for name, p in self.network.named_parameters())
        if defer and not raise_on_bad:
            cell: list = []

            def lazy_norm() -> float:
                if not cell:
                    norm, bad = force()
                    _M_GRAD_NORM.set(norm)
                    if bad:
                        _M_GRAD_BAD.inc(len(bad))
                    cell.append(norm)
                return cell[0]

            return lazy_norm
        norm, bad = force()
        _M_GRAD_NORM.set(norm)
        if bad:
            _M_GRAD_BAD.inc(len(bad))
            if raise_on_bad:
                raise _errs.errors.InvalidArgument(
                    f"check_numerics: non-finite gradient for "
                    f"parameter(s) {bad[:5]}"
                    + (f" (+{len(bad) - 5} more)" if len(bad) > 5 else ""))
        return norm

    def _sample_layer_breakdown(self) -> None:
        """Per-layer-prefix grad/weight/update norms (dynamics sampling
        step): one more fused reduction over params+grads, staged for
        the dynamics record this step closes. Telemetry must never take
        down a training step."""
        try:
            lr = float(self._optimizer.get_lr())
        except Exception:
            lr = None
        try:
            bd = _dynamics.layer_breakdown(
                ((name, p, getattr(p, "grad", None))
                 for name, p in self.network.named_parameters()), lr=lr)
        except Exception:
            return
        if not bd:
            return
        self._last_layer_breakdown = bd
        gsq = sum(r["grad_norm"] ** 2 for r in bd.values())
        wsq = sum(r["weight_norm"] ** 2 for r in bd.values())
        if lr is not None and wsq > 0:
            self._last_update_ratio = abs(lr) * float(
                np.sqrt(gsq) / np.sqrt(wsq))

    def footprint(self, depth: int = 1) -> dict:
        """Byte accounting of the model's device-resident state: parameter
        and optimizer-accumulator bytes aggregated by layer prefix (the
        first `depth` segments of the qualified sublayer name). Row/schema
        assembly and the model_param_bytes / model_opt_state_bytes gauge
        publication are shared with the static-graph
        `xla_insight.program_footprint` (one footprint contract)."""
        from ..framework import xla_insight as _xi

        layers: dict = {}
        pname_to_group: dict = {}

        def row(group: str) -> dict:
            return layers.setdefault(group, _xi.new_footprint_row())

        total_p = 0
        for qual, p in self.network.named_parameters():
            group = ".".join(qual.split(".")[:depth]) or qual
            r = row(group)
            b = _xi.value_bytes(p)
            r["param_bytes"] += b
            r["n_params"] += 1
            r["n_elements"] += int(np.prod(p.shape))
            total_p += b
            pname_to_group[getattr(p, "name", qual)] = group

        total_o = 0
        accs = getattr(self._optimizer, "_accumulators", None) or {}
        for per_param in accs.values():
            for pname, acc in per_param.items():
                b = _xi.value_bytes(acc)
                total_o += b
                # accumulators key on the framework param name; fold each
                # into its owning layer (or a catch-all when untraceable)
                row(pname_to_group.get(pname, "optimizer"))[
                    "opt_state_bytes"] += b

        return _xi.footprint_report(layers, total_p, total_o)

    def summary(self, input_size=None, dtype="float32"):
        """Per-layer table via forward hooks (reference hapi model_summary
        / paddle.summary): Layer (type) | Output Shape | Param #. Without
        input_size only the parameter totals are reported."""
        rows = []
        total = int(sum(np.prod(p.shape) for p in self.network.parameters()))
        trainable = int(sum(
            np.prod(p.shape) for p in self.network.parameters()
            if not getattr(p, "stop_gradient", False)))
        if input_size is not None:
            handles = []

            def make_hook(name, layer):
                def hook(lyr, args, out):
                    o = out[0] if isinstance(out, (list, tuple)) else out
                    shape = list(getattr(o, "shape", []))
                    n = int(sum(np.prod(p.shape)
                                for p in lyr.parameters(include_sublayers=False))
                            ) if hasattr(lyr, "parameters") else 0
                    rows.append((f"{name} ({type(lyr).__name__})",
                                 str(shape), n))
                return hook

            for name, sub in self.network.named_sublayers():
                if not list(sub.children()):  # leaves only
                    handles.append(sub.register_forward_post_hook(
                        make_hook(name, sub)))
            sizes = (input_size if isinstance(input_size, (list, tuple))
                     and isinstance(input_size[0], (list, tuple))
                     else [input_size])
            ins = [Tensor(np.zeros(sz, dtype)) for sz in sizes]
            was_training = self.network.training
            self.network.eval()
            try:
                self.network(*ins)
            finally:
                if was_training:
                    self.network.train()
                for h in handles:  # leaked hooks would fire forever
                    if hasattr(h, "remove"):
                        h.remove()
        width = max([len(r[0]) for r in rows] + [24])
        lines = [f"{'Layer (type)':<{width}}  {'Output Shape':<20}  Param #",
                 "-" * (width + 32)]
        for nm, shape, n in rows:
            lines.append(f"{nm:<{width}}  {shape:<20}  {n:,}")
        fp = self.footprint()
        lines += ["-" * (width + 32),
                  f"Total params: {total:,}",
                  f"Trainable params: {trainable:,}",
                  f"Params size: {fp['total_param_bytes'] / 1e6:.3f} MB",
                  f"Optimizer state size: "
                  f"{fp['total_opt_state_bytes'] / 1e6:.3f} MB"]
        print("\n".join(lines))
        return {"total_params": total, "trainable_params": trainable,
                "param_bytes": fp["total_param_bytes"],
                "opt_state_bytes": fp["total_opt_state_bytes"]}

    # -- helpers ---------------------------------------------------------
    def _to_loader(self, data, batch_size, shuffle, drop_last):
        if data is None:
            return None
        if isinstance(data, DataLoader):
            return data
        return DataLoader(
            data, batch_size=batch_size, shuffle=shuffle, drop_last=drop_last
        )

    def _unpack(self, batch, has_label=True):
        if isinstance(batch, (list, tuple)):
            if has_label and len(batch) >= 2:
                return list(batch[:-1]), batch[-1]
            return list(batch), None
        return [batch], None

    def _split(self, inputs, labels):
        ins = [
            x if isinstance(x, Tensor) else Tensor(np.asarray(x))
            for x in (inputs if isinstance(inputs, (list, tuple)) else [inputs])
        ]
        if labels is not None and not isinstance(labels, Tensor):
            labels = Tensor(np.asarray(labels))
        return ins, labels

    def _compute_loss(self, preds, labels):
        assert self._loss is not None, "prepare() with a loss first"
        if labels is not None:
            return self._loss(preds, labels)
        return self._loss(preds)

    def _update_metrics(self, preds, labels):
        out = {}
        for m in self._metrics:
            res = m.compute(preds, labels)
            if isinstance(res, (list, tuple)):
                m.update(*[np.asarray(r.numpy() if hasattr(r, "numpy") else r) for r in res])
            else:
                m.update(np.asarray(res.numpy() if hasattr(res, "numpy") else res))
            acc = m.accumulate()
            if isinstance(acc, (list, tuple)):
                for nm, v in zip(m.name() if isinstance(m.name(), (list, tuple)) else [m.name()], acc):
                    out[nm] = float(v)
            else:
                out[m.name() if isinstance(m.name(), str) else m.name()[0]] = float(acc)
        return out
