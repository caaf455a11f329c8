"""Fused Adam(W) update: the Hopper kernel's wrapper.

Port of ``paddle_tpu/ops/pallas/fused_adam.py`` (``fused_adam`` ->
``_kernel``). The kernel is ``paddle_tpu_torch/csrc/fused_adam.cu``, a
one-pass in-place update over p, m and v (CUDA C++ rather than Triton:
it is built, bound and counted by the same ``_build.py`` and ctypes
route as the package's other kernels; its header states what bounds it
and how the design answers that).

- :func:`fused_adam` -- one Adam(W) step, in place on ``p``, ``m`` and
  ``v``; returns them. ``g`` is in p's dtype, or fp32 beside a bf16 p
  (a global-norm clip's fp32 product, as the JAX package promotes it). ``lr``, ``beta1_pow`` and ``beta2_pow`` are
  one-element fp32 tensors on p's device: the kernel reads them from
  device memory, so a step makes no host read per parameter;
- :func:`fused_adam_plain` -- the plain PyTorch version of the same
  arithmetic (out of place). The wrapper runs it for CPU tensors, and
  only there, copying the results into ``p``, ``m`` and ``v`` so both
  routes update in place; a CUDA tensor launches the kernel or raises.

Unlike the TPU kernel, whose dispatch (``supported``) keeps 1-D and
unaligned params on the jnp path for the TPU's (8, 128) tiling, every
floating param of any shape goes through this kernel.

Under a CUDA graph (``framework/replay.py``; the card's default for a
training step) the wrapper needs nothing of its own: it launches on
``torch.cuda.current_stream``, which is the capture stream, and
allocates nothing (p, m and v are updated in place). The kernel reads lr
and the beta powers from device memory, so a replay picks up the values
staged for it. The launch counter counts Python calls: a capture adds
one call's launches, a replay none, although the graph relaunches the
recorded kernels. Each launch also reports its analytic cost to the
program insight (``framework/xla_insight.note_kernel``): 15 FLOPs an
element, p, g, m and v read once and p, m and v written once.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..framework import xla_insight as _insight

__all__ = ["fused_adam", "fused_adam_plain", "launches", "reset_launches"]

launches = 0  # kernel launches made through the wrapper

_P_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    global launches
    launches = 0


def _check(p, g, m, v, lr, b1p, b2p) -> None:
    if p.dtype not in _P_DTYPES or g.dtype not in (p.dtype, torch.float32):
        raise TypeError(f"fused_adam takes fp32 or bf16 p and g in p's "
                        f"dtype or fp32, got {p.dtype} and {g.dtype}")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"fused_adam takes fp32 moments, got {m.dtype} and "
                        f"{v.dtype}")
    if not (p.shape == g.shape == m.shape == v.shape):
        raise ValueError(
            f"fused_adam shape mismatch: p {tuple(p.shape)}, g "
            f"{tuple(g.shape)}, m {tuple(m.shape)}, v {tuple(v.shape)}")
    for name, t in (("lr", lr), ("beta1_pow", b1p), ("beta2_pow", b2p)):
        if t.numel() != 1 or t.dtype != torch.float32:
            raise ValueError(f"fused_adam takes {name} as one fp32 value, "
                             f"got {tuple(t.shape)} {t.dtype}")
    devs = {t.device for t in (p, g, m, v, lr, b1p, b2p)}
    if len(devs) != 1:
        raise ValueError(f"fused_adam inputs on different devices: {devs}")
    if not all(t.is_contiguous() for t in (p, g, m, v)):
        raise ValueError("fused_adam takes contiguous p, g, m and v")


def fused_adam_plain(p, g, m, v, lr, beta1_pow, beta2_pow, *, beta1=0.9,
                     beta2=0.999, eps=1e-8, weight_decay=0.0
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(p_out, m_out, v_out), the kernel's arithmetic in fp32, out of
    place; p_out in p's dtype."""
    lr = lr.reshape(())
    g32 = g.float()
    m_out = beta1 * m + (1.0 - beta1) * g32
    v_out = beta2 * v + (1.0 - beta2) * g32 * g32
    denom = torch.sqrt(v_out) / torch.sqrt(1.0 - beta2_pow.reshape(())) + eps
    p32 = p.float()
    step = lr * (m_out / denom) / (1.0 - beta1_pow.reshape(()))
    if weight_decay:
        step = step + lr * weight_decay * p32
    return (p32 - step).to(p.dtype), m_out, v_out


def _launch(p, g, m, v, lr, b1p, b2p, beta1, beta2, eps, wd) -> None:
    global launches
    from . import _build

    lib = _build.load()
    dev = p.device
    err = lib.fused_adam_step(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
        lr.data_ptr(), b1p.data_ptr(), b2p.data_ptr(), p.numel(),
        float(beta1), float(1.0 - beta1), float(beta2), float(1.0 - beta2),
        float(eps), float(wd), int(p.dtype == torch.bfloat16)
        | (int(g.dtype == torch.bfloat16) << 1),
        torch.cuda.get_device_properties(dev).multi_processor_count,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"fused_adam launch failed: CUDA error {err} "
                           f"(n={p.numel()}, dtype={p.dtype})")
    launches += 1
    # to the program insight: 15 FLOPs an element, and p, g, m, v read,
    # p, m, v written
    if _insight.active():
        n = p.numel()
        _insight.note_kernel("fused_adam", 15.0 * n, n * (
            2 * p.element_size() + g.element_size() + 16))


@torch.no_grad()
def fused_adam(p, g, m, v, lr, beta1_pow, beta2_pow, *, beta1=0.9,
               beta2=0.999, eps=1e-8, weight_decay=0.0
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Adam(W) step in place: p (bf16/fp32), g (p's dtype or fp32),
    m, v (fp32); returns (p, m, v), the same tensors. CPU tensors take the
    plain version; CUDA tensors launch the kernel (or raise); other
    devices raise."""
    _check(p, g, m, v, lr, beta1_pow, beta2_pow)
    if p.device.type == "cpu":
        po, mo, vo = fused_adam_plain(
            p, g, m, v, lr, beta1_pow, beta2_pow, beta1=beta1, beta2=beta2,
            eps=eps, weight_decay=weight_decay)
        p.copy_(po)
        m.copy_(mo)
        v.copy_(vo)
        return p, m, v
    if p.device.type != "cuda":
        raise ValueError(f"fused_adam runs on cuda or cpu, not {p.device}")
    with torch.cuda.device(p.device):
        _launch(p, g, m, v, lr, beta1_pow, beta2_pow, beta1, beta2, eps,
                weight_decay)
    return p, m, v
