#!/usr/bin/env python3
"""chip_smoke.py's ``static_amp`` phase alone, on one CUDA card: gpt2s at
seq 2048, batch 8, built in fp32 under ``static.amp`` (bf16) and
undecorated, each replayed, with their step walls, launches and traced
steps (``chip_smoke._static_amp``).

    python3 tools/torch_static_amp.py [--port DIR]

``--port DIR`` runs the phase of the checkout at DIR instead (its
``chip_smoke.py`` and ``paddle_tpu_torch``, built under DIR), for example
an archive of an older tree, so that two trees' steps can be compared in
one call on one card (parent, change, change, parent). Prints the phase's
lines, then one ``static_amp_summary`` line: the bf16 and fp32 replayed
step medians and, where the tree's phase traces it, the fp32 step's
device ms and the flash kernels in it by name.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", default=None,
                    help="checkout whose static_amp phase is run")
    tree = os.path.abspath(ap.parse_args().port or ROOT)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs  # the tree's own phase and checks

    card = cs._environment(torch)
    import paddle_tpu_torch

    paddle_tpu_torch.enable_static()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs._build()
    cs._static_amp(torch, card)
    said = cs._SAID["static_amp"]
    cs._say(phase="static_amp_summary", tree=tree, card=card, **{
        k: said.get(k) for k in ("step_ms_median", "fp32_step_ms_median",
                                 "fp32_step_ms_all", "fp32_device_ms",
                                 "fp32_named_kernels")})
    return 0


if __name__ == "__main__":
    sys.exit(main())
