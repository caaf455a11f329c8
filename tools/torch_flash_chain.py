#!/usr/bin/env python3
"""chip_smoke.py's flash gradient chain check on its own, on one CUDA card.

    python3 tools/torch_flash_chain.py [--port DIR]

Runs ``chip_smoke._check_chain`` (``_flash_chain`` over
``_CHAIN_CASES``): dq and dk/dv from the kernel forward's own out and
lse (as the training step makes them), held against the plain chain run
in fp32 on the same bf16 inputs, within ``_CHAIN_MULTIPLE`` times the
plain bf16 chain's own relative error plus ``_CHAIN_ATOL``. One JSON
line per case; exits non-zero if a case breaks the bound.

``--port DIR`` takes ``paddle_tpu_torch`` (and its kernels, built under
DIR) from the checkout at DIR, for example an archive of an older tree,
so that its kernels stand trial under this tree's bound; by default this
checkout's.
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", default=None,
                    help="checkout whose paddle_tpu_torch is checked")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # this tree's check, whatever --port says

    if args.port:
        sys.path.insert(0, os.path.abspath(args.port))
    import torch

    cs._environment(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    from paddle_tpu_torch.ops import _build

    _build.load()
    cs._say(phase="chain_port", port=os.path.dirname(os.path.dirname(
        os.path.abspath(_build.__file__))))
    cs._check_chain(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
