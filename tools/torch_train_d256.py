#!/usr/bin/env python3
"""chip_smoke.py's ``train_d256`` phase (or, with ``--dtype float32``,
its ``train_f32_d256``) on its own, on one CUDA card.

    python3 tools/torch_train_d256.py [--port DIR] [--dtype float32]

bench.py's gpt2s at seq 2048, batch 8, bf16 in three heads of 256
(``chip_smoke._D256``; in fp32 ``chip_smoke._F32_D256``):
``chip_smoke._train`` runs 13 steps eagerly and 13 on the card's compiled
route from one start, holds the replayed steps to the eager ones bit for
bit and the loss finite and falling, counts the flash forward, dq and
dk/dv 12 times a host step, and traces one replayed step. Its JSON lines
are the phase's: ``train_d256`` (``train_f32_d256``: step wall,
tokens/s, launches), its ``_replay_vs_eager`` line and the traced steps.
On this checkout's kernels the traced step must also show the head_dim-256
kernels by name (``chip_smoke._D256_NAMES`` or ``_F32_D256_NAMES``).

``--port DIR`` takes ``paddle_tpu_torch`` (and its kernels, built under
DIR) from the checkout at DIR, for example an archive of an older tree,
so that two trees' steps can be timed in one call on one card; by
default this checkout's. The kernels' names in the traced step are not
held then (an older tree's may differ).
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", default=None,
                    help="checkout whose paddle_tpu_torch is trained")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"),
                    help="the program's dtype (float32: train_f32_d256)")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # this tree's phase, whatever --port says

    if args.port:
        sys.path.insert(0, os.path.abspath(args.port))
    import torch

    card = cs._environment(torch)
    import paddle_tpu_torch
    from paddle_tpu_torch.ops import _build

    paddle_tpu_torch.enable_static()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    f32 = args.dtype == "float32"
    phase = "train_f32_d256" if f32 else "train_d256"
    cs._say(phase=phase + "_port", port=os.path.dirname(os.path.dirname(
        os.path.abspath(_build.__file__))))
    names = None if args.port else (cs._F32_D256_NAMES if f32
                                    else cs._D256_NAMES)
    cs._train(torch, card, cs._F32_D256 if f32 else cs._D256, cs._LONG_B,
              cs._LONG_T, phase, cs._LAYERS, names=names)
    return 0


if __name__ == "__main__":
    sys.exit(main())
