#!/usr/bin/env python3
"""chip_smoke.py's seq-512 loss band on its own, on one CUDA card.

    python3 tools/torch_loss_band.py [--port DIR]

Trains bench.py's gpt2s (batch 8, seq 512, the fixed batch) 13 steps three
ways from the same initial parameters, as ``chip_smoke.py``'s ``train``
phase does: K, the bf16 program with the kernels; T, the program in fp32
(TF32 off, every kernel on its fp32 route); Y, bf16 with the three CE
kernels replaced by their plain versions. Holds K to ``_loss_band``
(``|K_t - T_t| <= _BAND_MULTIPLE * max_{s <= t} |Y_s - T_s| +
_BAND_ATOL``) and prints one JSON line; exits non-zero if K lies outside.

``--port DIR`` takes ``paddle_tpu_torch`` (and its kernels, built under
DIR) from the checkout at DIR, for example an archive of an older tree,
so that its kernels stand trial under this tree's band; by default this
checkout's.
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", default=None,
                    help="checkout whose paddle_tpu_torch is checked")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # this tree's band, whatever --port says

    if args.port:
        sys.path.insert(0, os.path.abspath(args.port))
    import torch

    card = cs._environment(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import paddle_tpu_torch
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.ops import _build

    # the band's programs are static; a port with the eager API starts in
    # dygraph mode (an older checkout has no switch and is static)
    getattr(paddle_tpu_torch, "enable_static", lambda: None)()
    _build.load()
    config, batch, seq = cs._TRAIN, cs._TRAIN_B, cs._TRAIN_T
    program = cs._train_program(config, batch, seq)
    scope = Scope()
    cs._executor("cuda").run(program[1], scope=scope)
    start = {v.name: scope.get(v.name).detach().clone()
             for v in program[0].list_vars() if v.persistable}
    del scope
    feed = cs._fixed_batch(torch, config["vocab_size"], batch, seq)
    runs = cs._band_runs(torch, config, batch, seq, start, feed)
    t0 = time.perf_counter()
    k = cs._losses(program, start, feed, "cuda", len(runs["Y"]))
    runs["wall_s"]["K"] = time.perf_counter() - t0
    cs._say(phase="loss_band_port", port=os.path.dirname(os.path.dirname(
        os.path.abspath(_build.__file__))), config=config, batch=batch,
        seq=seq, wall_s=runs["wall_s"], card=card,
        **cs._loss_band(k, runs["T"], runs["Y"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
