#!/usr/bin/env python3
"""The fp32 flash backward of one head_dim on its own, on one CUDA card:
build, check, time: the dq and dk/dv in split TF32 on the tensor cores,
at head_dim 256 (the default), 64 or 128.

    python3 tools/torch_flash_f32_d256_bwd.py [--head-dim {64,128,256}]
        [--port DIR] [--no-check]

1. ``chip_smoke._build`` (this tree only): every kernel built, ptxas's
   registers and spills and the tensor-core instructions of each
   tensor-core kernel's SASS, and ptxas's serialized-wgmma warnings;
2. unless ``--no-check``: the fp32 cases of ``chip_smoke._FLASH_CASES``
   at the head_dim against the plain versions at
   ``_FLASH_TOL["float32"]``, the float64 bound of
   ``chip_smoke._check_f32_flash_bwd_truth`` at the head_dim and the fp32
   gradient chain (``_F32_CHAIN_CASES``) at it;
3. ``chip_smoke._time_flash`` at the training shape in fp32 in heads of
   the head_dim (B 8, T 2048, H 768 / D, causal, BTHD) and, at 64 and
   128, at jit.load's shape (B 1, BHTD, non-causal): CUDA events (median
   of 5), device ms from a traced window, the plain version, SDPA's fp32
   backward and the bounds (split TF32 for the tensor-core kernels),
   twice.

``--port DIR`` takes ``paddle_tpu_torch`` (and its kernels, built under
DIR) from the checkout at DIR, for example an archive of an older tree,
and runs step 3 alone, so that two trees' kernels can be timed in one
call on one card.
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", default=None,
                    help="checkout whose paddle_tpu_torch is timed")
    ap.add_argument("--no-check", action="store_true",
                    help="time only (after the build)")
    ap.add_argument("--head-dim", type=int, choices=(64, 128, 256),
                    default=256, help="the head_dim checked and timed")
    args = ap.parse_args()
    hd = args.head_dim
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # this tree's checks, whatever --port says

    if args.port:
        sys.path.insert(0, os.path.abspath(args.port))
    import torch

    card = cs._environment(torch)
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.port:
        _build.load()
    else:
        cs._build()
    cs._say(phase="f32_d256_bwd_port", port=os.path.dirname(os.path.dirname(
        os.path.abspath(_build.__file__))))
    if not args.port and not args.no_check:
        for i, (dtype, layout, causal, b, h, tq, tk, d) in enumerate(
                cs._FLASH_CASES):
            if dtype != "float32" or d != hd:
                continue
            q, k, v, do = cs._flash_inputs(torch, b, h, tq, tk, d,
                                           torch.float32, layout,
                                           seed=100 + i)
            got, ref = cs._flash_outputs(torch, q, k, v, do, causal, layout)
            torch.cuda.synchronize()
            what = (f"float32 {layout} {'causal' if causal else 'full'} "
                    f"B={b} H={h} Tq={tq} Tk={tk} D={d}")
            cs._flash_agrees(torch, got, ref, "float32", what)
            cs._no_key_rows_agree(got, causal, layout, tq, tk, what)
            cs._say(phase="kernel_check", kernel="flash_attention",
                    dtype=dtype, layout=layout, causal=causal, b=b, h=h,
                    tq=tq, tk=tk, d=d, max_abs_err={
                        n: cs._err(got[n], ref[n]) for n in ref})
            del q, k, v, do, got, ref
        cs._check_f32_flash_bwd_truth(torch, head_dims=(hd,))
        for i, (b, h, t, d, layout) in enumerate(cs._F32_CHAIN_CASES):
            if d != hd:
                continue
            q, k, v, do = cs._flash_inputs(torch, b, h, t, t, d,
                                           torch.float32, layout, seed=98)
            cs._flash_chain(torch, q, k, v, do, True, layout, b=b, h=h,
                            t=t, d=d)
            del q, k, v, do
            torch.cuda.empty_cache()
    fl.reset_launches()
    heads = cs._LONG["d_model"] // hd
    for _ in range(2):
        cs._time_flash(torch, card, "BTHD", True, torch.float32, repeats=5,
                       heads=heads, device=True)
        if hd != 256:
            cs._time_flash(torch, card, "BHTD", False, torch.float32,
                           batch=1, repeats=5, heads=heads, device=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
