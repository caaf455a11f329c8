#!/usr/bin/env python3
"""chip_smoke.py's ``train_d256`` phase on its own, on one CUDA card.

    python3 tools/torch_train_d256.py [--port DIR]

bench.py's gpt2s at seq 2048, batch 8, bf16 in three heads of 256
(``chip_smoke._D256``): ``chip_smoke._train`` runs 13 steps eagerly and
13 on the card's compiled route from one start, holds the replayed steps
to the eager ones bit for bit and the loss finite and falling, counts the
flash forward, dq and dk/dv 12 times a host step, and traces one
replayed step. Its JSON lines are the phase's: ``train_d256`` (step wall,
tokens/s, launches), ``train_d256_replay_vs_eager`` and the traced steps.

``--port DIR`` takes ``paddle_tpu_torch`` (and its kernels, built under
DIR) from the checkout at DIR, for example an archive of an older tree,
so that two trees' steps can be timed in one call on one card; by
default this checkout's. The kernels' names in the traced step are not
held here (an older tree's may differ); ``chip_smoke.py`` holds them.
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", default=None,
                    help="checkout whose paddle_tpu_torch is trained")
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
    cs._say(phase="train_d256_port", port=os.path.dirname(os.path.dirname(
        os.path.abspath(_build.__file__))))
    cs._train(torch, card, cs._D256, cs._LONG_B, cs._LONG_T, "train_d256",
              cs._LAYERS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
