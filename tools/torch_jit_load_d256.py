#!/usr/bin/env python3
"""chip_smoke.py's ``jit_load_d256`` leg and the fp32 head_dim-256 flash
forward's timings on their own, on one CUDA card.

    python3 tools/torch_jit_load_d256.py [--port DIR] [--piece NAME]

The fp32 forward at head_dim 256 (``chip_smoke._time_flash``: CUDA events,
device ms from a traced window, the plain version, SDPA in fp32 and the
split-TF32 bound) at the export leg's shape (B 1, T 2048, H 3, BHTD,
non-causal) and at the training shape (B 8, causal, BTHD); then the
leg (``chip_smoke._jit_load``): the eval encoder at 3 heads of 256
(``chip_smoke._JIT_D256``, from ``_JIT_SEED``) saved in fp32 with
``jit.save``, loaded with ``jit.load`` and called four times at batch 1,
each call within ``_JIT_LOAD_RTOL`` of the eager forward, and a traced
replay: its device ms and the calls and device ms of the kernels whose
names hold ``--piece`` (by default this tree's head_dim-256 split-TF32
forward, ``::fwd_f32_d256_sm90_kernel(``).

``--port DIR`` takes ``paddle_tpu_torch`` (and its kernels, built under
DIR) from the checkout at DIR, for example an archive of an older tree,
so that two trees can be timed in one call on one card; the traced
kernels' names are then reported, not held (an older tree's may differ:
pass its forward's piece of name, e.g. ``--piece '::fwd_kernel<'``).
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", default=None,
                    help="checkout whose paddle_tpu_torch is run")
    ap.add_argument("--piece", default="::fwd_f32_d256_sm90_kernel(",
                    help="a piece of the forward kernel's traced name")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # this tree's leg, whatever --port says

    if args.port:
        sys.path.insert(0, os.path.abspath(args.port))
    import torch

    card = cs._environment(torch)
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import dygraph, jit
    from paddle_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    cs._say(phase="jit_load_d256_port", port=os.path.dirname(os.path.dirname(
        os.path.abspath(_build.__file__))))
    cs._time_flash(torch, card, "BHTD", False, torch.float32, batch=1,
                   repeats=10, heads=3, device=True)
    cs._time_flash(torch, card, "BTHD", True, torch.float32, repeats=5,
                   heads=3, device=True)
    cfg = cs._JIT_D256
    with dygraph.guard(), pt.no_grad():
        pt.seed(cs._JIT_SEED)
        net = cs._masked_lm(pt, **cfg)
        net.eval()
        ids_np, _ = cs._mlm_batch(cfg["vocab"], cs._EAGER_B, cfg["seq"],
                                  cs._JIT_SEED)
        report, launches = cs._jit_load(
            torch, pt, jit, net, pt.to_tensor(ids_np[:1]), "encoder_d256",
            args.piece, hold=not args.port)
    cs._say(phase="jit_load_d256", config=cfg, **report, launches=launches,
            card=card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
