"""Compiled execution on the card: a body of work captured once as a
CUDA graph, then replayed.

The port's counterpart of ``jax.jit``. The JAX package traces a training
block or a serving program once and runs the compiled executable on
every later call (``paddle_tpu/framework/executor.py:_get_compiled``,
``paddle_tpu/serving/model.py:_jit_for``); eager PyTorch would instead
pay the host's launch of every op on every call. :class:`Captured` runs
a *body* through PyTorch's three phases:

1. **warm-up**: the first ``warmup`` calls run the body eagerly, on a
   side stream (PyTorch's rule: library handles, workspaces and kernel
   attributes are set up outside the capture). They are real calls.
2. **capture**: the next call records the body into a CUDA graph
   (nothing runs while it records: ``torch.cuda.graph``) and replays the
   graph once, so that call's work is done exactly once.
3. **replay**: every later call replays the graph, one launch.

What a body must keep to, because a graph replays fixed device
addresses and none of the host's per-call work:

- it reads its per-call inputs from **static buffers** that its owner
  fills (``copy_``) before each call, and everything else from tensors
  whose addresses stay fixed; it writes lasting state in place;
- it makes **no host read** of a device value (``.item()``,
  ``.tolist()``, ``.cpu()``) and no host-side per-call choice (a
  generator seeded on the host would replay one draw forever, so the
  executor's draws hash a (seed, step) tensor on the device that the
  body advances in place; the body is told it is being captured,
  ``replayed=True``);
- its outputs live in the graph's memory pool and the next replay
  overwrites them: owners copy them out (``clone``, ``.cpu()``).

Launch counters in the kernel wrappers count Python calls: a capture
counts one call's launches, a replay none (the graph relaunches the
recorded kernels). :attr:`Captured.calls` says how many calls ran each
phase.

A capture that fails raises: the body's own error (which names the op
where the executor ran one) with a note that the capture failed and
that ``PADDLE_TPU_EAGER=1`` runs the card eagerly. Nothing falls back to
an eager run on its own.

On the CPU there are no graphs. An owner that stages on the CPU (the
tests) runs the same three phases with the body called directly, so the
staging into static buffers and the copy-back are the ones the card
captures.
"""
from __future__ import annotations

import gc
from typing import Any, Callable, Dict, Optional

import torch

from .. import flags as _flags

__all__ = ["Captured", "replays"]


def replays(device: torch.device, staged: bool = False) -> bool:
    """Whether work on ``device`` takes the compiled route: on a CUDA
    card unless ``PADDLE_TPU_EAGER`` is set, and on the CPU only for an
    owner that ``staged`` (tests)."""
    if device.type == "cuda":
        return not _flags.env_flag("PADDLE_TPU_EAGER")
    return bool(staged)


class Captured:
    """``body(replayed) -> outputs`` run through warm-up, capture and
    replay (see the module docstring). ``pool`` is a graph memory pool
    to share (``torch.cuda.graph_pool_handle()``) among bodies that never
    run at once. The capture takes CUDA's thread-local error mode: an
    unsafe call on the capturing thread breaks it, while another thread
    (a serving engine's scheduler, the main thread allocating) goes on
    undisturbed; kernels that autograd's thread launches onto the capture
    stream are recorded as any others."""

    def __init__(self, body: Callable[[bool], Any], device: torch.device,
                 *, warmup: int = 1, pool: Optional[tuple] = None):
        self.body = body
        self.device = torch.device(device)
        self.warmup = int(warmup)
        self.pool = pool
        # a path set before the capture: the captured graph is kept (in
        # debug mode) and its DOT written there (``CUDAGraph.debug_dump``)
        self.dump_dot: Optional[str] = None
        self.graph = None
        self.outputs: Any = None
        self.calls: Dict[str, int] = {"eager": 0, "capture": 0, "replay": 0}

    @property
    def captured(self) -> bool:
        return self.calls["capture"] > 0

    def __call__(self):
        """Run one call of the body; returns ``(outputs, phase)``, the
        phase one of ``"eager"``, ``"capture"`` and ``"replay"``."""
        if self.captured:
            self.calls["replay"] += 1
            if self.graph is None:  # the CPU: the body is its own replay
                return self.body(True), "replay"
            self.graph.replay()
            return self.outputs, "replay"
        if self.calls["eager"] < self.warmup:
            self.calls["eager"] += 1
            return self._warm(), "eager"
        out = self._capture()
        self.calls["capture"] += 1  # a failed capture is tried again
        return out, "capture"

    def _warm(self):
        if self.device.type != "cuda":
            return self.body(False)
        ambient = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(ambient)
        with torch.cuda.stream(side):
            out = self.body(False)
        ambient.wait_stream(side)
        return out

    def _capture(self):
        try:
            if self.device.type != "cuda":
                return self.body(True)
            return self._record()
        except Exception as e:
            e.add_note(
                "raised while capturing the work as a CUDA graph; set "
                "PADDLE_TPU_EAGER=1 to run the card eagerly, op by op")
            raise

    def _record(self):
        """Capture the body into a CUDA graph, then replay it once. The
        garbage collector runs first: an unreachable object in a reference
        cycle that holds another graph would otherwise wait for the
        collector's next pass, which may come inside this capture, on this
        thread, and a graph's destruction during a capture invalidates it.
        (The serving programs hold no such cycle; see
        ``serving.model._Program``.)"""
        if self.dump_dot:
            # the raw graph is kept past the capture so its DOT can be
            # printed (it is instantiated below instead)
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            graph.enable_debug_mode()
        else:
            graph = torch.cuda.CUDAGraph()
        failure: Optional[BaseException] = None
        out = None
        gc.collect()
        try:
            with torch.cuda.device(self.device), torch.cuda.graph(
                    graph, pool=self.pool, capture_error_mode="thread_local"):
                try:
                    out = self.body(True)
                except Exception as e:  # end the capture, then raise it
                    failure = e
        except Exception as e:  # CUDA refused the graph at capture_end
            failure = failure or e
        if failure is not None:
            raise failure
        self.graph, self.outputs = graph, out
        if self.dump_dot:
            graph.instantiate()
            graph.debug_dump(self.dump_dot)
        graph.replay()
        return out
