"""Continuous-batching serving engine: the request plane, fully observed.

Port of ``paddle_tpu/serving/engine.py``. The scheduler is host code and
unchanged; the two places that waited for the device
(``jax.block_until_ready``) call ``DecodeModel.synchronize`` instead, so
the ledger's prefill/decode windows time device work, and the scheduler
thread binds the model's CUDA device before it issues any.

The scheduler the ROADMAP's "production serving engine on the mesh"
item asks for: an SLO-ordered admission queue feeding up to
``max_batch`` decode slots over a paged KV cache, prefill and decode as
separate model calls (``serving/model.py``), and — because this repo
builds its planes observable from birth — every request leaving a
complete lifecycle trail:

- **spans**: ``serve/admit -> serve/queue -> serve/prefill ->
  serve/decode_tick* -> serve/done`` emitted through the profiler with
  the request_id (and tick number) in the span args and parent links
  chaining the lifecycle, so ``tools/timeline.py`` renders each request
  as a flow arrow threading across batch ticks;
- **ledger**: every closed scheduler tick attributes its wall into the
  serving goodput buckets (``serving/ledger.py``), and every finished
  request lands in the TTFT / latency histograms;
- **reconciliation**: the per-request span seconds and the per-tick
  slot-seconds are accumulated by DIFFERENT code paths and must agree
  (``ledger.reconcile_spans``) — the plumbing audits itself.

Two request kinds share one code path (the point of the predictor
satellite — the legacy single-request bridge is a batch-of-one client,
not a second engine):

- ``generate``: prompt -> greedy tokens via prefill + decode ticks;
- ``execute``: an arbitrary thunk admitted, queued, timed and retired
  through the same lifecycle, charged to ``prefill_compute`` (it IS a
  prompt-shaped one-shot pass).

Under KV pressure the engine preempts: the running request with the
LATEST absolute deadline loses its blocks and re-queues with its
generated prefix folded into the prompt (recompute-on-resume), so tight
SLOs survive loose ones — the test observes both the eviction and the
freed blocks' reuse.

Threading: ``start()`` runs the scheduler on a daemon thread (the
serve_bench / replica mode); without ``start()`` the engine is driven
synchronously (``run_until_idle`` / ``drive``), which is how tests and
the predictor get deterministic behavior with the same code path.

Compiled programs (the card's default, ``serving/model.py``): the
model's prefill and decode graphs are bound to the pages tensor they
were captured on, and the model returns the pages it was given, so
``self.pages`` stays that one tensor for the engine's life. ``warm()``
captures them on these pages before traffic, from the calling thread;
an engine that serves unwarmed captures on its first ticks, on the
scheduler thread (the capture's error mode is thread-local, so other
threads go on undisturbed).
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from .. import chaos as _chaos
from .. import flags as _flags
from .. import monitor as _monitor
from .. import profiler as _profiler
from . import ledger as _ledger
from .kv_cache import BlockAllocator, blocks_for_tokens

__all__ = ["ServeRequest", "RequestHandle", "AdmissionQueue",
           "ServingEngine"]

# completed generate results kept for idempotent re-dispatch: a router
# replaying request_id X on this replica (duplicate delivery, a hedge
# that lost the race, a retry whose first answer was dropped on the
# wire) gets the SAME tokens back without recomputing
_IDEM_CACHE_CAP = 512

# robustness counters: admission-time load shedding and the stale-slot
# reaper (the serving half of the fault plane)
_M_SHED = _monitor.counter(
    "serve_shed_total",
    "requests rejected at admission: SLO deadline already unmeetable")
_M_REAPED = _monitor.counter(
    "serve_reaped_total",
    "in-flight requests reaped past their SLO deadline grace (slot + "
    "KV blocks reclaimed)")

_req_counter = itertools.count(1)

QUEUED, RUNNING, DONE, FAILED = "queued", "running", "done", "failed"


@dataclass
class ServeRequest:
    """One admitted unit of work and its full lifecycle record."""

    request_id: str
    kind: str = "generate"  # or "execute"
    prompt: Optional[np.ndarray] = None
    max_new_tokens: int = 16
    deadline_s: float = 30.0
    thunk: Optional[Callable[[], Any]] = None
    # inbound cross-process trace context ("trace_id:span_id", the
    # __trace__ convention): lifecycle spans parent under it so a
    # routed request renders as ONE flow across processes
    trace: Optional[str] = None
    # engine-side latency decomposition, filled at retirement
    # (ATTRIBUTION_BUCKETS names -> seconds, summing to engine e2e)
    attribution: Optional[Dict[str, float]] = None
    # lifecycle timestamps (perf_counter_ns, shared clock with spans)
    t_submit: int = 0
    t_admit: int = 0
    t_prefill0: int = 0
    t_prefill1: int = 0
    t_first_token: int = 0
    t_done: int = 0
    tick_windows: List[tuple] = field(default_factory=list)  # (t0,t1,tick)
    out_tokens: List[int] = field(default_factory=list)
    # tokens generated BEFORE a preemption: folded into the prompt for
    # recompute-on-resume, but still part of the request's output
    generated_prefix: List[int] = field(default_factory=list)
    blocks: List[int] = field(default_factory=list)
    context_len: int = 0
    prompt_len: int = 0
    slot: int = -1
    status: str = QUEUED
    cached: bool = False  # served from the idempotency cache, not work
    error: Optional[str] = None
    exception: Optional[BaseException] = None
    result: Any = None
    evictions: int = 0
    done_event: threading.Event = field(default_factory=threading.Event)

    @property
    def deadline_abs(self) -> float:
        return self.t_submit / 1e9 + self.deadline_s


class RequestHandle:
    """What submit() returns: a waitable view of one request."""

    def __init__(self, req: ServeRequest, engine: "ServingEngine"):
        self._req = req
        self._engine = engine

    @property
    def request_id(self) -> str:
        return self._req.request_id

    @property
    def done(self) -> bool:
        return self._req.done_event.is_set()

    @property
    def cached(self) -> bool:
        """True when this handle was served from the idempotency cache
        (a re-dispatched request_id) instead of fresh compute."""
        return self._req.cached

    @property
    def attribution(self) -> Optional[Dict[str, float]]:
        """The engine-side latency decomposition (None until retired,
        and for idempotent cache replays — a replay did no work)."""
        return self._req.attribution

    @property
    def engine_e2e_s(self) -> Optional[float]:
        """Engine-measured submit -> retired wall the attribution
        buckets reconstruct (None until retired / for cache replays)."""
        if not self._req.t_done:
            return None
        return (self._req.t_done - self._req.t_submit) / 1e9

    def result(self, timeout: Optional[float] = None):
        """Block until the request retires; the engine is driven inline
        when no scheduler thread runs (the batch-of-one client path).
        Returns generated tokens (generate) or the thunk's value
        (execute); raises the request's error."""
        from ..framework import errors as _errors

        if not self._engine.running_thread():
            self._engine.drive(self)
        if not self._req.done_event.wait(timeout):
            raise _errors.errors.ExecutionTimeout(
                f"request {self._req.request_id} still pending after "
                f"{timeout}s")
        if self._req.status == FAILED:
            if self._req.exception is not None:
                # execute thunks re-raise their ORIGINAL exception: the
                # engine is a scheduler, not an error translator (the
                # predictor's callers match on executor error types)
                raise self._req.exception
            raise _errors.errors.InvalidArgument(
                f"request {self._req.request_id} failed: {self._req.error}")
        if self._req.kind == "execute":
            return self._req.result
        return list(self._req.generated_prefix) + list(self._req.out_tokens)


class AdmissionQueue:
    """SLO-ordered admission: earliest absolute deadline first, arrival
    order breaking ties — the queue discipline the ordering test pins."""

    def __init__(self):
        self._heap: List[tuple] = []
        self._seq = itertools.count()
        self._lock = threading.Lock()

    def push(self, req: ServeRequest) -> None:
        with self._lock:
            heapq.heappush(self._heap, (req.deadline_abs, next(self._seq),
                                        req))

    def pop(self) -> Optional[ServeRequest]:
        with self._lock:
            if not self._heap:
                return None
            return heapq.heappop(self._heap)[2]

    def requeue_front(self, req: ServeRequest) -> None:
        """Put back a request that could not be admitted (keeps its
        deadline key, so it stays at its SLO position)."""
        self.push(req)

    def depth(self) -> int:
        with self._lock:
            return len(self._heap)


class ServingEngine:
    """The continuous-batching scheduler over one DecodeModel."""

    def __init__(self, model=None,
                 max_batch: Optional[int] = None,
                 n_blocks: Optional[int] = None,
                 block_size: Optional[int] = None,
                 default_slo_s: Optional[float] = None):
        self.model = model
        if model is not None:
            self.max_batch = model.max_batch
            self.block_size = model.block_size
            n_kv = model.n_blocks
        else:
            self.max_batch = int(
                max_batch if max_batch is not None
                else _flags.env_flag("PADDLE_TPU_SERVE_MAX_BATCH"))
            self.block_size = int(
                block_size if block_size is not None
                else _flags.env_flag("PADDLE_TPU_SERVE_BLOCK_SIZE"))
            n_kv = int(n_blocks if n_blocks is not None
                       else _flags.env_flag("PADDLE_TPU_SERVE_KV_BLOCKS"))
        self.default_slo_s = float(
            default_slo_s if default_slo_s is not None
            else _flags.env_flag("PADDLE_TPU_SERVE_SLO_S"))
        self.allocator = BlockAllocator(n_kv, self.block_size)
        self.queue = AdmissionQueue()
        self.pages = model.init_pages() if model is not None else None
        self._slots: List[Optional[ServeRequest]] = [None] * self.max_batch
        # admitted one-shot executes waiting for a thread to claim them
        self._exec_ready: List[ServeRequest] = []
        self._tick_no = 0
        self._step_lock = threading.RLock()
        self._wake = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._draining = False
        self.requests_seen = 0
        # EMA of completed requests' in-slot service seconds: the
        # admission shedder's forward estimate of the minimum time a
        # newly-admitted request will need. Until the first retirement
        # teaches it (cold start, warm restart) the estimate falls back
        # to the decode roofline installed on the ledger — see
        # _service_estimate.
        self._service_ema = 0.0
        # idempotent re-dispatch: request_id -> live request (dedup) and
        # request_id -> finished tokens (replay without recompute)
        self._idem_lock = threading.Lock()
        self._inflight_ids: Dict[str, ServeRequest] = {}
        self._completed_ids: "OrderedDict[str, List[int]]" = OrderedDict()

    # -- submission ----------------------------------------------------

    def submit(self, prompt: Sequence[int],
               max_new_tokens: int = 16,
               deadline_s: Optional[float] = None,
               request_id: Optional[str] = None,
               trace: Optional[str] = None) -> RequestHandle:
        """Enqueue a generation request (greedy decode). ``trace`` is
        the inbound cross-process span context ("trace_id:span_id") the
        request's lifecycle spans parent under."""
        from ..framework import errors as _errors

        if self.model is None:
            raise _errors.errors.InvalidArgument(
                "this engine has no model; only execute() is available")
        # idempotency BEFORE the draining gate: replaying a finished
        # request_id (or joining a live one) adds no new work, so a
        # draining replica still answers duplicates it already owns
        if request_id is not None:
            replay = self._idempotent_handle(request_id)
            if replay is not None:
                return replay
        self._reject_if_draining(request_id)
        req = ServeRequest(
            request_id=request_id or f"req-{next(_req_counter)}",
            kind="generate",
            prompt=np.asarray(list(prompt), np.int32),
            max_new_tokens=int(max_new_tokens),
            deadline_s=float(deadline_s if deadline_s is not None
                             else self.default_slo_s),
            t_submit=time.perf_counter_ns(),
            trace=trace)
        req.prompt_len = int(req.prompt.shape[0])
        if request_id is not None:
            with self._idem_lock:
                live = self._inflight_ids.get(request_id)
                if live is not None:  # lost a submit race: join, don't fork
                    return RequestHandle(live, self)
                self._inflight_ids[request_id] = req
        return self._enqueue(req)

    def execute(self, thunk: Callable[[], Any],
                deadline_s: Optional[float] = None,
                request_id: Optional[str] = None) -> RequestHandle:
        """Enqueue a one-shot execute request (the predictor's
        batch-of-one client path — same queue, same lifecycle)."""
        self._reject_if_draining(request_id)
        req = ServeRequest(
            request_id=request_id or f"req-{next(_req_counter)}",
            kind="execute", thunk=thunk,
            deadline_s=float(deadline_s if deadline_s is not None
                             else self.default_slo_s),
            t_submit=time.perf_counter_ns())
        return self._enqueue(req)

    def _reject_if_draining(self, request_id: Optional[str]) -> None:
        from ..framework import errors as _errors

        if self._draining:
            raise _errors.errors.Unavailable(
                f"replica draining: request "
                f"{request_id or '<new>'} rejected (admitted work is "
                f"completing; dispatch elsewhere)")

    def _idempotent_handle(self, request_id: str
                           ) -> Optional[RequestHandle]:
        """A request_id this replica already finished (or is running)
        returns the SAME result instead of recomputing — the contract
        that makes router re-dispatch safe against duplicate delivery."""
        with self._idem_lock:
            tokens = self._completed_ids.get(request_id)
            if tokens is None:
                live = self._inflight_ids.get(request_id)
                return RequestHandle(live, self) if live is not None \
                    else None
        req = ServeRequest(request_id=request_id, kind="generate",
                           t_submit=time.perf_counter_ns())
        req.out_tokens = list(tokens)
        req.status = DONE
        req.cached = True
        req.done_event.set()
        return RequestHandle(req, self)

    def _note_retired(self, req: ServeRequest) -> None:
        """Retirement hook for the idempotency maps: successful generates
        become replayable, everything leaves the in-flight set (a FAILED
        request_id stays retryable — failure is not a cacheable answer)."""
        with self._idem_lock:
            self._inflight_ids.pop(req.request_id, None)
            if req.kind == "generate" and req.status == DONE \
                    and not req.cached:
                self._completed_ids[req.request_id] = (
                    list(req.generated_prefix) + list(req.out_tokens))
                while len(self._completed_ids) > _IDEM_CACHE_CAP:
                    self._completed_ids.popitem(last=False)

    def _enqueue(self, req: ServeRequest) -> RequestHandle:
        self.requests_seen += 1
        self.queue.push(req)
        with self._wake:
            self._wake.notify_all()
        return RequestHandle(req, self)

    def generate(self, prompt: Sequence[int], max_new_tokens: int = 16,
                 deadline_s: Optional[float] = None) -> List[int]:
        """Submit + wait: the convenience the tests and bench use."""
        return self.submit(prompt, max_new_tokens, deadline_s).result()

    # -- scheduler thread ----------------------------------------------

    def running_thread(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> None:
        if self.running_thread():
            return
        self._stop = False
        self._thread = threading.Thread(target=self._serve_loop,
                                        name="paddle-tpu-serve",
                                        daemon=True)
        self._thread.start()

    def warm(self, full: bool = False) -> None:
        """Run the model's programs ahead of traffic on this engine's own
        pages (``DecodeModel.warm``): on the card that captures them, so
        requests only replay. The calls write only the scratch block 0."""
        self.model.warm(full=full, pages=self.pages)

    def stop(self, flush: bool = True) -> None:
        self._stop = True
        with self._wake:
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        if flush:
            try:
                _ledger.flush()
            except OSError:
                pass

    # -- connection draining -------------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining

    def drain(self) -> None:
        """Begin connection draining: new submissions are rejected with
        typed Unavailable, but every request already admitted OR queued
        runs to completion — the replica can be taken out of a router's
        rotation without dropping accepted work."""
        self._draining = True
        _monitor.flight_record("serve", "draining",
                               queued=self.queue.depth(),
                               active=len(self.active()))
        with self._wake:
            self._wake.notify_all()

    def drained(self) -> bool:
        """True once draining was requested and all accepted work has
        retired (the take-me-down-now signal)."""
        return (self._draining and self.queue.depth() == 0
                and not self.active() and not self._exec_ready)

    def undrain(self) -> None:
        """Re-open admission (a cancelled take-down)."""
        self._draining = False
        with self._wake:
            self._wake.notify_all()

    def healthz_info(self) -> Dict[str, Any]:
        """The /healthz `serving` sub-document: what a router needs for
        health + least-loaded decisions, cheap enough to poll."""
        return {
            "draining": self._draining,
            "drained": self.drained(),
            "active": len(self.active()),
            "queued": self.queue.depth(),
            "max_batch": self.max_batch,
            "inflight_executes": len(self._exec_ready),
            "kv_free": self.allocator.available(),
            "requests_seen": self.requests_seen,
            # the shedder's per-request service EMA (0.0 while cold —
            # readers fall back to the roofline floor): the autoscaler's
            # measured-service input, exported so the forecast can ride
            # real completions instead of guessing
            "service_ema_s": round(self._service_ema, 6),
        }

    def _serve_loop(self) -> None:
        # CUDA's current device is per thread: issue this thread's work
        # on the model's card, not on device 0
        if self.model is not None:
            self.model.bind_thread()
        while not self._stop:
            worked = self.step()
            if self._draining and self.drained():
                # drained replicas idle instead of spinning; stop() (or
                # undrain) is the only way forward from here
                with self._wake:
                    if self._stop or not self._draining:
                        continue
                    self._wake.wait(timeout=0.05)
                continue
            if not worked:
                # nothing runnable: wait for a submit. A non-empty queue
                # here means admission is blocked (KV/slots) with an
                # empty batch — that wait IS queue_wait badput.
                t0 = time.perf_counter()
                with self._wake:
                    if self._stop:
                        break
                    self._wake.wait(timeout=0.05)
                queued = self.queue.depth()
                if queued:
                    wall = time.perf_counter() - t0
                    _ledger.add("queue_wait", wall)
                    _ledger.end_tick(wall, queued=queued)

    # -- the scheduler tick --------------------------------------------

    def active(self) -> List[ServeRequest]:
        return [r for r in self._slots if r is not None]

    def step(self) -> bool:
        """One scheduler iteration: admit, prefill, decode tick, retire
        (the locked phase), then drain any admitted one-shot executes on
        THIS thread. Returns False when nothing was runnable (the ledger
        tick is only closed when work happened — idle engines are
        inert)."""
        with self._step_lock:
            worked = self._step_locked()
        while self._claim_execute():
            worked = True
        return worked

    def _step_locked(self) -> bool:
        """The generate half of a scheduler iteration; caller holds the
        step lock. Admitted executes land in _exec_ready for whoever
        claims them (the stepping thread in step(), each request's OWN
        waiting thread in drive())."""
        t0 = time.perf_counter()
        self._reap_stale()
        admitted = self._admit()
        gen_work = False
        for req in admitted:
            if req.kind == "generate":
                gen_work = True
                self._run_prefill(req)
            else:
                self._exec_ready.append(req)
        decoded = 0
        if any(r is not None and r.status == RUNNING and
               r.kind == "generate" for r in self._slots):
            gen_work = True
            decoded = self._decode_tick()
        active = len([r for r in self.active() if r.kind == "generate"])
        self._retire_finished()
        if gen_work:
            _ledger.end_tick(
                time.perf_counter() - t0,
                decoded_tokens=decoded,
                active=active,
                max_batch=self.max_batch,
                kv_used=self.allocator.used(),
                kv_total=self.allocator.capacity,
                queued=self.queue.depth())
        return gen_work or bool(admitted)

    def _claim_execute(self, prefer: Optional[ServeRequest] = None) -> bool:
        """Claim ONE admitted execute request and run its thunk on the
        calling thread, lock-free (its ledger tick is atomic). With
        `prefer`, only that request is claimed — the drive() fast path
        that keeps N predictor clones running N thunks in parallel."""
        with self._step_lock:
            if prefer is not None:
                if prefer not in self._exec_ready:
                    return False
                self._exec_ready.remove(prefer)
                req = prefer
            elif self._exec_ready:
                req = self._exec_ready.pop(0)
            else:
                return False
        self._run_execute(req)
        with self._step_lock:
            self._retire_finished()
        return True

    def run_until_idle(self, max_steps: int = 100000) -> None:
        """Drive synchronously until queue and batch drain (tests, and
        the inline predictor path)."""
        for _ in range(max_steps):
            with self._step_lock:
                worked = self._step_locked()
            while self._claim_execute():
                worked = True
            with self._step_lock:
                if not worked and self.queue.depth() == 0 \
                        and not self.active():
                    return

    def drive(self, handle: RequestHandle, max_steps: int = 100000) -> None:
        """Drive until ONE handle retires (thread-safe: concurrent
        predictor clones each claim and run their OWN execute thunk, so
        clone-per-thread parallelism survives the shared engine)."""
        own = handle._req
        for _ in range(max_steps):
            if handle.done:
                return
            if self._claim_execute(prefer=own):
                continue
            with self._step_lock:
                if handle.done:
                    return
                worked = self._step_locked()
            if worked or handle.done:
                continue
            # nothing of ours to run: help drain orphaned executes
            # (fire-and-forget submissions with no driving thread)
            if self._claim_execute():
                continue
            time.sleep(0.0005)  # another thread holds the work

    # -- admission -----------------------------------------------------

    def _reap_stale(self) -> int:
        """The engine-side reaper: an in-flight request still holding
        its slot (or parked in the execute claim queue) past its
        absolute SLO deadline + PADDLE_TPU_SERVE_REAP_GRACE_S is failed
        with typed Unavailable and its slot + KV blocks reclaimed. This
        is the orphan guard — a client whose driving thread died (or a
        decode loop wedged on one request) must not leak engine capacity
        forever."""
        grace = float(_flags.env_flag("PADDLE_TPU_SERVE_REAP_GRACE_S"))
        if grace <= 0:
            return 0
        now = time.perf_counter_ns() / 1e9
        reaped = 0
        for i, req in enumerate(self._slots):
            if req is None or req.status != RUNNING:
                continue
            if now <= req.deadline_abs + grace:
                continue
            self._slots[i] = None
            req.slot = -1
            if req.blocks:
                self.allocator.free(req.blocks)
                req.blocks = []
            self._reap(req, now, grace)
            reaped += 1
        for req in list(self._exec_ready):
            if now > req.deadline_abs + grace:
                self._exec_ready.remove(req)
                self._reap(req, now, grace)
                reaped += 1
        return reaped

    def _reap(self, req: ServeRequest, now: float, grace: float) -> None:
        from ..framework import errors as _errors

        if _monitor.enabled():
            _M_REAPED.inc()
        _monitor.flight_record("serve", "reaped",
                               request_id=req.request_id,
                               overdue_s=round(now - req.deadline_abs, 3))
        req.exception = _errors.errors.Unavailable(
            f"request {req.request_id} reaped: "
            f"{now - req.deadline_abs:.2f}s past its SLO deadline "
            f"(grace {grace}s) with its slot/KV blocks still held")
        self._fail(req, "reaped past SLO deadline", outcome="reaped")

    def _service_estimate(self, req: ServeRequest) -> float:
        """The shedder's forward estimate of this request's minimum
        service time. Warm path: the retirement EMA. Cold path (first
        requests after start/warm-restart, EMA still empty): the
        decode roofline installed on the serving ledger — per-tick
        floor x the request's token budget — so a freshly restarted
        replica sheds on physics instead of admitting everything."""
        if self._service_ema > 0.0:
            return self._service_ema
        if req.kind != "generate":
            return 0.0
        roof = _ledger.ledger().roofline
        floor = float((roof or {}).get("tick_seconds_floor") or 0.0)
        if floor <= 0.0:
            return 0.0
        return floor * max(1, int(req.max_new_tokens))

    def _should_shed(self, req: ServeRequest) -> bool:
        """Admission-time load shedding: a request whose deadline is
        already unmeetable — the queue depth ahead of it ate its SLO
        budget, or the minimum service estimate (retirement EMA, seeded
        by the decode roofline at cold start) cannot fit in what
        remains — is rejected with typed Unavailable instead of
        occupying a slot it cannot use. Keeps overload failing the
        requests that were ALREADY lost instead of everyone."""
        if not bool(_flags.env_flag("PADDLE_TPU_SERVE_SHED")):
            return False
        now = time.perf_counter_ns() / 1e9
        estimate = self._service_estimate(req)
        if now + estimate <= req.deadline_abs:
            return False
        from ..framework import errors as _errors

        if _monitor.enabled():
            _M_SHED.inc()
        _monitor.flight_record("serve", "shed",
                               request_id=req.request_id,
                               queued=self.queue.depth(),
                               late_s=round(now + estimate
                                            - req.deadline_abs, 3))
        req.exception = _errors.errors.Unavailable(
            f"request {req.request_id} shed at admission: deadline "
            f"unmeetable (deficit "
            f"{now + estimate - req.deadline_abs:.2f}s at "
            f"queue depth {self.queue.depth()}, service estimate "
            f"{estimate:.3f}s"
            + ("" if self._service_ema > 0.0
               else ", roofline-seeded cold start") + ")")
        self._fail(req, "shed: SLO deadline unmeetable at admission",
                   outcome="shed")
        return True

    def _admit(self) -> List[ServeRequest]:
        admitted: List[ServeRequest] = []
        deferred: List[ServeRequest] = []
        while True:
            slot = next((i for i, r in enumerate(self._slots) if r is None),
                        None)
            if slot is None:
                break
            req = self.queue.pop()
            if req is None:
                break
            if _chaos.armed("admit_error"):
                from ..framework import errors as _errors

                try:
                    _chaos.admit_error(where=f"admit/{req.request_id}")
                except _errors.errors.Unavailable as e:
                    # the injected fault fails the ONE request, typed —
                    # never the batch, never a silent hang
                    req.exception = e
                    self._fail(req, f"chaos admit_error injected: {e}")
                    continue
            if self._should_shed(req):
                continue
            if req.kind == "generate":
                need = blocks_for_tokens(req.prompt_len + 1, self.block_size)
                if req.prompt_len >= self.model.cfg.max_seq_len or \
                        self.model.bucket_for(req.prompt_len) is None:
                    self._fail(req, "prompt exceeds the serving envelope")
                    continue
                # liveness: a trajectory the cache can NEVER hold must
                # fail fast, not requeue forever (deferral only makes
                # sense when running requests will eventually free
                # enough blocks)
                worst = blocks_for_tokens(
                    min(req.prompt_len + req.max_new_tokens,
                        self.model.cfg.max_seq_len), self.block_size)
                if worst > self.allocator.capacity:
                    self._fail(req, f"request needs {worst} KV blocks "
                               f"but the cache holds "
                               f"{self.allocator.capacity}")
                    continue
                blocks = self.allocator.alloc(need, req.request_id)
                if blocks is None and not self._evict_for(need, req):
                    deferred.append(req)
                    break  # KV-blocked: later arrivals cannot jump the SLO order
                if blocks is None:
                    blocks = self.allocator.alloc(need, req.request_id)
                    if blocks is None:
                        deferred.append(req)
                        break
                req.blocks = blocks
            req.t_admit = time.perf_counter_ns()
            req.status = RUNNING
            req.slot = slot
            self._slots[slot] = req
            admitted.append(req)
        for req in deferred:
            self.queue.requeue_front(req)
        return admitted

    def _evict_for(self, need: int, incoming: ServeRequest) -> bool:
        """Preempt running requests with LATER deadlines (looser SLOs)
        than the incoming one, latest first, until `need` blocks are
        free; their blocks free for reuse and they re-queue with the
        generated prefix folded into the prompt. Nobody is preempted
        unless the victims' blocks can actually cover the ask — a
        pointless eviction would pay the recompute without admitting
        anyone."""
        victims = sorted(
            (r for r in self._slots
             if r is not None and r.status == RUNNING
             and r.kind == "generate"
             and r.deadline_abs > incoming.deadline_abs),
            key=lambda r: r.deadline_abs, reverse=True)
        reclaimable = self.allocator.available() + sum(
            len(v.blocks) for v in victims)
        if reclaimable < need:
            return False
        for victim in victims:
            if self.allocator.available() >= need:
                break
            self._preempt(victim)
        return self.allocator.available() >= need

    def _preempt(self, req: ServeRequest) -> None:
        self._slots[req.slot] = None
        req.slot = -1
        self.allocator.free(req.blocks)
        req.blocks = []
        req.evictions += 1
        # recompute-on-resume: the tokens generated so far become prompt
        # (and stay part of the output via generated_prefix)
        if req.out_tokens:
            req.generated_prefix.extend(req.out_tokens)
            req.prompt = np.concatenate(
                [req.prompt, np.asarray(req.out_tokens, np.int32)])
            req.max_new_tokens -= len(req.out_tokens)
            req.prompt_len = int(req.prompt.shape[0])
            req.out_tokens = []
        req.context_len = 0
        req.status = QUEUED
        _ledger.record_request(outcome="evicted")
        self.queue.push(req)

    # -- work ----------------------------------------------------------

    def _run_execute(self, req: ServeRequest) -> None:
        import traceback

        t0 = time.perf_counter_ns()
        req.t_prefill0 = t0
        try:
            req.result = req.thunk()
            req.status = DONE
        except Exception as e:  # the batch survives a poisoned request
            req.error = f"{type(e).__name__}: {e}"
            req.exception = e
            req.traceback = traceback.format_exc()
            req.status = FAILED
        req.t_prefill1 = time.perf_counter_ns()
        req.t_first_token = req.t_prefill1
        window = (req.t_prefill1 - t0) / 1e9
        # a one-shot execute IS a prompt-shaped pass: prefill bucket.
        # Atomic own-tick accounting (the `attributed` path): concurrent
        # executes must not bleed windows into each other's open tick.
        _ledger.end_tick(window, attributed={"prefill_compute": window},
                         queued=self.queue.depth())

    def _run_prefill(self, req: ServeRequest) -> None:
        req.t_prefill0 = time.perf_counter_ns()
        try:
            pages, tok = self.model.prefill(
                self.pages, req.prompt, req.prompt_len, req.blocks)
            # the window times device work, not its enqueue
            self.model.synchronize()
        except Exception as e:
            self._slots[req.slot] = None
            req.slot = -1
            self.allocator.free(req.blocks)
            req.blocks = []
            self._fail(req, f"{type(e).__name__}: {e}")
            return
        self.pages = pages
        req.t_prefill1 = time.perf_counter_ns()
        if not req.t_first_token:  # a re-prefill after eviction is not
            req.t_first_token = req.t_prefill1  # the user's first token
        req.context_len = req.prompt_len
        req.out_tokens.append(tok)
        _ledger.add("prefill_compute",
                    (req.t_prefill1 - req.t_prefill0) / 1e9)
        if len(req.out_tokens) >= req.max_new_tokens:
            req.status = DONE

    def _decode_tick(self) -> int:
        """One batched decode dispatch. Returns the number of tokens
        decoded (counted HERE, before retirement clears finished
        requests from their slots)."""
        self._tick_no += 1
        # serving chaos sites, seed-deterministic (paddle_tpu/chaos.py):
        # replica_kill dies NOW with slots full of in-flight state — the
        # shape router failover + warm restart must survive; decode_stall
        # wedges the tick so SLO-at-risk hedging has something to hedge
        if _chaos.enabled():
            _chaos.replica_kill(self._tick_no)
            _chaos.delay("decode_stall", where=f"decode_tick/{self._tick_no}")
        active = [r for r in self._slots
                  if r is not None and r.status == RUNNING
                  and r.kind == "generate"]
        # grow each context into its next block where needed; a request
        # that cannot get one is preempted (self-victim = failure)
        ready: List[ServeRequest] = []
        for req in active:
            if req.status != RUNNING or req.slot < 0:
                continue  # preempted by an earlier iteration's eviction
            need = blocks_for_tokens(req.context_len + 1, self.block_size)
            if need > len(req.blocks):
                grown = self.allocator.alloc(need - len(req.blocks),
                                             req.request_id)
                if grown is None:
                    if self._evict_for(need - len(req.blocks), req):
                        grown = self.allocator.alloc(
                            need - len(req.blocks), req.request_id)
                    if grown is None:
                        if req.slot >= 0:
                            self._slots[req.slot] = None
                            req.slot = -1
                        self.allocator.free(req.blocks)
                        req.blocks = []
                        self._fail(req, "kv blocks exhausted")
                        continue
                req.blocks.extend(grown)
            if req.context_len + 1 >= self.model.cfg.max_seq_len:
                req.status = DONE  # context envelope reached
                continue
            ready.append(req)
        # an eviction later in the growth loop may have preempted a
        # request already collected: only still-running slot-holders
        # enter the batch (a slot of -1 would corrupt another row)
        ready = [r for r in ready
                 if r.status == RUNNING and r.slot >= 0]
        if not ready:
            return 0
        B = self.max_batch
        tables = np.zeros((B, self.model.max_blocks_per_req), np.int32)
        lens = np.zeros((B,), np.int32)
        toks = np.zeros((B,), np.int32)
        for req in ready:
            tables[req.slot, :len(req.blocks)] = req.blocks
            lens[req.slot] = req.context_len
            toks[req.slot] = req.out_tokens[-1]
        t0 = time.perf_counter_ns()
        pages, nxt = self.model.decode(self.pages, tables, lens, toks)
        self.model.synchronize()  # decode_compute times device work
        t1 = time.perf_counter_ns()
        self.pages = pages
        window = (t1 - t0) / 1e9
        _ledger.add("decode_compute", window)
        # the engine-side leg of the span reconciliation: slot-seconds
        _ledger.add_slot_seconds(window * len(ready))
        for req in ready:
            req.out_tokens.append(int(nxt[req.slot]))
            req.context_len += 1
            req.tick_windows.append((t0, t1, self._tick_no))
            if len(req.out_tokens) >= req.max_new_tokens:
                req.status = DONE
        return len(ready)

    # -- retirement ----------------------------------------------------

    def _attribute(self, req: ServeRequest) -> Dict[str, float]:
        """Engine-side latency decomposition of one retired request:
        admission_queue / prefill_compute / decode_compute / postprocess
        measured from the lifecycle timestamps, batch_wait defined as
        the admitted-but-not-computing remainder — so the buckets sum to
        the engine e2e (t_submit -> t_done) BY CONSTRUCTION. The compute
        windows are disjoint wall intervals inside the request's life
        (eviction re-prefills included), so the remainder is never
        negative beyond clock noise. A never-admitted request (shed,
        chaos at admission) spent its whole life in admission_queue."""
        e2e = max(0.0, (req.t_done - req.t_submit) / 1e9)
        if not req.t_admit:
            return {"admission_queue": e2e}
        buckets: Dict[str, float] = {
            "admission_queue": (req.t_admit - req.t_submit) / 1e9}
        last_end = req.t_admit
        if req.t_prefill1:
            buckets["prefill_compute"] = (
                req.t_prefill1 - req.t_prefill0) / 1e9
            last_end = max(last_end, req.t_prefill1)
        if req.tick_windows:
            buckets["decode_compute"] = sum(
                (t1 - t0) for t0, t1, _ in req.tick_windows) / 1e9
            last_end = max(last_end, req.tick_windows[-1][1])
        buckets["postprocess"] = max(0.0, (req.t_done - last_end) / 1e9)
        got = sum(buckets.values())
        buckets["batch_wait"] = max(0.0, e2e - got)
        return buckets

    def _record_attribution(self, req: ServeRequest, outcome: str) -> None:
        req.attribution = self._attribute(req)
        _ledger.record_attribution(
            req.attribution, (req.t_done - req.t_submit) / 1e9,
            klass="engine", outcome=outcome, request_id=req.request_id)

    def _fail(self, req: ServeRequest, why: str,
              outcome: str = "failed") -> None:
        req.status = FAILED
        req.error = why
        req.t_done = time.perf_counter_ns()
        _ledger.record_request(outcome=outcome)
        self._record_attribution(req, outcome)
        self._emit_lifecycle(req)
        self._note_retired(req)
        req.done_event.set()

    def _retire_finished(self) -> None:
        for i, req in enumerate(self._slots):
            if req is None or req.status not in (DONE, FAILED):
                continue
            self._slots[i] = None
            req.slot = -1
            if req.blocks:
                self.allocator.free(req.blocks)
                req.blocks = []
            req.t_done = time.perf_counter_ns()
            span_s = sum((t1 - t0) for t0, t1, _ in req.tick_windows) / 1e9
            if req.status == DONE and req.t_admit:
                # teach the admission shedder what service actually
                # costs: EMA over completed requests' in-slot seconds
                service = (req.t_done - req.t_admit) / 1e9
                self._service_ema = (
                    service if self._service_ema <= 0.0
                    else self._service_ema + 0.3 * (service
                                                    - self._service_ema))
            if req.status == DONE:
                _ledger.record_request(
                    outcome="ok",
                    ttft_s=(req.t_first_token - req.t_submit) / 1e9
                    if req.t_first_token else None,
                    latency_s=(req.t_done - req.t_submit) / 1e9,
                    prompt_tokens=req.prompt_len,
                    output_tokens=(len(req.generated_prefix)
                                   + len(req.out_tokens)),
                    span_seconds=span_s)
            else:
                _ledger.record_request(outcome="failed",
                                       span_seconds=span_s)
            self._record_attribution(
                req, "ok" if req.status == DONE else "failed")
            self._emit_lifecycle(req)
            self._note_retired(req)
            req.done_event.set()

    def _emit_lifecycle(self, req: ServeRequest) -> None:
        """Emit the request's whole span chain (admit -> queue ->
        prefill -> decode_tick* -> done) with request_id in the args and
        parent links threading the lifecycle — the flow-arrow input of
        tools/timeline.py. Emitted at retirement, when every timestamp
        is final; explicit-timestamp spans keep the profiler's
        per-thread nesting stack out of the picture."""
        if not _profiler.tracing_active():
            return
        rid = req.request_id
        meta = {"request_id": rid}
        # inbound cross-process context: the router pre-minted this
        # attempt's span id and shipped "trace_id:span_id" — the whole
        # lifecycle chain joins THAT trace, parented under the attempt
        trace_id = parent = None
        if req.trace and ":" in req.trace:
            trace_id, parent = req.trace.split(":", 1)
        parent = _profiler.emit_span(
            "serve/admit", cat="serve", t0_ns=req.t_submit, dur_ns=0,
            meta=meta, parent_span_id=parent, trace_id=trace_id)
        if req.t_admit:
            parent = _profiler.emit_span(
                "serve/queue", cat="serve", t0_ns=req.t_submit,
                dur_ns=req.t_admit - req.t_submit, meta=meta,
                parent_span_id=parent, trace_id=trace_id)
        if req.t_prefill1:
            name = ("serve/prefill" if req.kind == "generate"
                    else "serve/execute")
            parent = _profiler.emit_span(
                name, cat="serve", t0_ns=req.t_prefill0,
                dur_ns=req.t_prefill1 - req.t_prefill0, meta=meta,
                parent_span_id=parent, trace_id=trace_id)
        for t0, t1, tick in req.tick_windows:
            parent = _profiler.emit_span(
                "serve/decode_tick", cat="serve", t0_ns=t0,
                dur_ns=t1 - t0, meta={**meta, "tick": tick},
                parent_span_id=parent, trace_id=trace_id)
        _profiler.emit_span(
            "serve/done", cat="serve", t0_ns=req.t_done, dur_ns=0,
            meta={**meta, "outcome": req.status,
                  "n_tokens": len(req.generated_prefix) + len(req.out_tokens)},
            parent_span_id=parent, trace_id=trace_id)
