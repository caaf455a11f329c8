"""paddle_tpu_torch -- the PyTorch and CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` stays the reference; this package runs its
GPT serving and training paths and its eager API on an NVIDIA card. Its
module layout mirrors ``paddle_tpu`` so each counterpart is found under
the same path:

  flags.py              the PADDLE_TPU_* environment flags it reads
  framework/errors.py   typed errors
  monitor.py            metrics registry + flight recorder
  profiler.py           host spans + torch.profiler device trace
  chaos.py              deterministic fault injection
  framework/            program IR, autodiff (recompute too), executor
  dygraph/              the eager tracer and Tensor
  ops/                  op lowerings, ops/api.py (the functional API) and
                        the CUDA kernels' wrappers
  nn/, amp/, tensor/    layers, autocast, the tensor namespace
  optimizer/            the optimizers; nn/clip.py, regularizer.py
  io/, metric/, hapi/   DataLoader, metrics, Model.fit; io/fs.py
  jit/                  to_static (CUDA-graph replay, dy2static control
                        flow), jit.save / jit.load
  static/               the static builders, static.amp (the program's
                        mixed-precision rewrite), CompiledProgram
  fluid/                the fluid namespace of reference-style scripts
  vision/               the model zoo (LeNet, ResNet, VGG, MobileNet),
                        transforms and datasets
  checkpoint.py         the fit loop's full-state checkpoints
  models/gpt.py         GPTConfig and the training program
  distributed/fleet/    RecomputeOptimizer
  serving/              continuous-batching engine over a paged KV cache
  weights.py            parameters from numpy (or the JAX package)

As in paddle 2.0 and the reference, dygraph (eager) mode is the default:
importing the package makes the tracer active, which touches no device
until the first op; ``enable_static()`` switches to graph building and
``disable_static()`` back. Importing it has no other effect: no server
starts, no journal opens, no CUDA context is made. Entry points run on
``cuda`` unless the caller passes ``device="cpu"`` (or
``set_device("cpu")``, which names the default place).
"""
from __future__ import annotations

from .framework.core import CPUPlace, CUDAPlace, get_device, set_device
from .framework.errors import EnforceError, errors
from .framework.program import in_dygraph_mode
from . import static  # noqa: E402
from .dygraph import Tensor, no_grad, to_tensor
from .dygraph.base import disable_dygraph, enable_dygraph
from .ops import api as _api
from .ops.api import (  # noqa: F401
    abs, add, arange, argmax, argmin, bmm, cast, clip, concat, cos, cumsum,
    divide, equal, exp, expand, flatten, full, gather, greater_equal,
    greater_than, less_equal, less_than, log, matmul, max, maximum, mean,
    min, minimum, multiply, not_equal, ones, ones_like, prod, reshape,
    rsqrt, scale, sigmoid, sin, softmax, split, sqrt, square, squeeze,
    stack, subtract, sum, tanh, tile, topk, transpose, tril, triu,
    unsqueeze, where, zeros, zeros_like)

_api._install_patches()

from . import nn  # noqa: E402
from . import optimizer  # noqa: E402
from . import regularizer  # noqa: E402
from . import metric  # noqa: E402
from . import io  # noqa: E402
from . import amp  # noqa: E402
from . import tensor  # noqa: E402
from . import callbacks  # noqa: E402
from . import jit  # noqa: E402
from . import fluid  # noqa: E402
from . import vision  # noqa: E402
from .hapi.model import Model  # noqa: E402
from .hapi.model_io import load, save  # noqa: E402


def enable_static():
    disable_dygraph()


def disable_static():
    enable_dygraph()


def seed(value: int):
    """``paddle.seed``: the eager tracer's draws restart from (value, 0)
    and the default main program's random seed is ``value``."""
    from .framework import program as _fw

    tracer = _fw._current_tracer()
    if tracer is not None:
        tracer.seed(value)
    _fw.default_main_program().random_seed = value
    return value


def summary(net, input_size=None, dtypes="float32"):
    """``paddle.summary``: the per-layer table of ``Model.summary`` for a
    bare ``nn.Layer``; a -1/None batch dim becomes 1, and ``dtypes`` may
    be a list (its first entry applies to every input)."""

    def _clean(sz):
        return [1 if (d is None or d == -1) else int(d) for d in sz]

    sizes = input_size
    if sizes is not None:
        if isinstance(sizes, (list, tuple)) and sizes \
                and isinstance(sizes[0], (list, tuple)):
            sizes = [_clean(sz) for sz in sizes]
        else:
            sizes = _clean(sizes)
    dt = dtypes[0] if isinstance(dtypes, (list, tuple)) else dtypes
    return Model(net).summary(input_size=sizes, dtype=dt)


# dygraph by default (paddle 2.0 semantics)
enable_dygraph()

__all__ = ["CPUPlace", "CUDAPlace", "EnforceError", "Model", "Tensor",
           "disable_static", "enable_static", "errors", "get_device",
           "in_dygraph_mode", "load", "no_grad", "save", "seed",
           "set_device", "summary", "to_tensor"]
