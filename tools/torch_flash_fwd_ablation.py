#!/usr/bin/env python3
"""Where the flash attention forward spends its time, on one CUDA card:
ablations of the bf16 ``paddle_tpu_torch/csrc/flash_attention_fwd_sm90.cu``,
with ``--d256`` of the bf16 ``flash_attention_fwd_d256_sm90.cu``, with
``--f32-d256`` of the fp32 (split TF32)
``flash_attention_fwd_f32_d256_sm90.cu`` (its ``flash_f32.cuh`` written
into the source, which the softmax's variants edit).

Each variant is the kernel's source with one part of its work removed,
built by its own nvcc (all started together) into its own library and
timed with CUDA events (median of 20 after 3 warm-up calls) at the
seq-2048 training shape (B = 8, T = 2048, H = 12, D = 64, bf16, causal,
BTHD; with ``--d256`` H = 3, D = 256, gpt2s's width in three heads; with
``--f32-d256`` the same in fp32), in the order kernel, variants, variants
reversed, kernel:

- ``kernel``: the source as it is (its result is checked against the
  plain version: largest error of out and of lse);
- ``no_exp``: the softmax without its exponentials (P = s - m), the rest
  of it (scale, mask, row max, shuffles, row sum, rescale) kept;
- ``no_scores``: the score wgmma on one k16 slice of D's four (of its
  sixteen at D = 256; with ``--f32-d256`` one 8-deep slice of each
  32-column box's four: 3 tf32 products of its 12);
- ``no_product``: no P . V wgmma;
- ``no_reload``: no key or value tile loaded after the first (the ring's
  barriers still turn over; at D = 256 after the first two, which the
  prologue loads);
- ``no_split`` (``--f32-d256`` alone): K and V not split into tf32 hi and
  lo (nor V transposed) in shared memory;
- ``skeleton``: ``no_scores``, ``no_product`` and ``no_exp`` together:
  the loads, barriers and the rest of the softmax alone (with
  ``--f32-d256`` the split and the Q fragments' too).

Each row also carries ``device_ms``: the kernel's own duration in a
``torch.profiler`` trace of 10 calls, without the host's time to encode
the tensor maps and launch, which the CUDA-event time of one call holds.
The variants' outputs are wrong by construction; only their times mean
anything. Run from the root of a checkout:

    python3 tools/torch_flash_fwd_ablation.py [--d256 | --f32-d256]

It prints one JSON line per timing, the card's name and power limit
beside each.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from paddle_tpu_torch.ops import _build  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as fl  # noqa: E402
from torch_ce_bwd_ablation import _median_ms  # noqa: E402

CSRC = os.path.join(ROOT, "paddle_tpu_torch", "csrc")
SOURCE = os.path.join(CSRC, "flash_attention_fwd_sm90.cu")
SOURCE_D256 = os.path.join(CSRC, "flash_attention_fwd_d256_sm90.cu")
SOURCE_F32_D256 = os.path.join(CSRC, "flash_attention_fwd_f32_d256_sm90.cu")
_EXP = "        e = exp2f(e - m_new);"
_SCORES = """      wgmma_n64<0>(s, desc(q_addr + hh * Q_BOX + 32 * kk),
                   desc(k_addr + hh * KV_BOX + 32 * kk), (hh | kk) != 0);"""
_PRODUCT = """      wgmma_n64_rs(o[hh], pa[kk],
                   desc(v_addr + hh * KV_BOX + kk * 16 * 128));"""
_LOAD = """        mbar_expect_tx(full(stage), STAGE);
        for (int hh = 0; hh < HALVES; ++hh) {
          tma_load_3d(ks + hh * KV_BOX, &map_k, kc + 64 * hh, j * BKV, ko,
                      full(stage));
          tma_load_3d(ks + (HALVES + hh) * KV_BOX, &map_v, kc + 64 * hh,
                      j * BKV, ko, full(stage));
        }"""
# the head_dim-256 kernel's load in its loop (the prologue loads the
# first two tiles), and what no_reload puts in its place
_LOADS_D256 = {"      load(j + 1);": "      mbar_arrive(k_full(j + 1));\n"
                                     "      mbar_arrive(v_full(j + 1));"}
# the fp32 head_dim-256 kernel's anchors: a box's score chain (one slice
# kept), its P . V, its split of K and V, its load of the next tile
_SCORES_F32_D256 = (
    "    wgmma_n32_tf32_rs(c, l[0], l[1], l[2], l[3], dh, kd != 0);\n"
    "    wgmma_n32_tf32_rs(c, h[0], h[1], h[2], h[3], dl, 1);\n"
    "    wgmma_n32_tf32_rs(c, h[0], h[1], h[2], h[3], dh, 1);")
_PRODUCT_F32_D256 = (
    "    wgmma_n128_tf32_rs(ot, l[0], l[1], l[2], l[3], dh, jj != 0);\n"
    "    wgmma_n128_tf32_rs(ot, h[0], h[1], h[2], h[3], dl, 1);\n"
    "    wgmma_n128_tf32_rs(ot, h[0], h[1], h[2], h[3], dh, 1);")
_SPLIT_F32_D256 = ("    split_k(gk + box0 * KV_BOX, wtid);",
                   "      split_v(gv, 128 * wg, wtid);")
_LOAD_F32_D256 = "    if (tid == 0 && j + 1 < ntiles) load(j + 1);"
_HEADER_F32 = '#include "flash_f32.cuh"'


def variants_f32_d256(src):
    """{name: source} of the fp32 head_dim-256 kernel's source with
    flash_f32.cuh written in (the softmax lives there); raises if either
    no longer has the text a variant edits."""
    if src.count(_HEADER_F32) != 1:
        raise RuntimeError("the kernel's source changed; update the "
                           "ablations of tools/torch_flash_fwd_ablation.py")
    with open(os.path.join(CSRC, "flash_f32.cuh")) as f:
        src = src.replace(_HEADER_F32, f.read().replace("#pragma once\n",
                                                         ""))
    for piece in (_EXP, _SCORES_F32_D256, _PRODUCT_F32_D256, _LOAD_F32_D256,
                  *_SPLIT_F32_D256):
        if src.count(piece) != 1:
            raise RuntimeError("the kernel's source changed; update the "
                               "ablations of tools/torch_flash_fwd_ablation"
                               ".py")
    no_exp = src.replace(_EXP, "        e = e - m_new;")
    one_slice = "    if (kd == 0) {\n" + _SCORES_F32_D256 + "\n    }"
    no_scores = src.replace(_SCORES_F32_D256, one_slice)
    no_product = src.replace(_PRODUCT_F32_D256, "    ;")
    no_split = src
    for piece in _SPLIT_F32_D256:
        no_split = no_split.replace(piece, "    ;")
    no_reload = src.replace(_LOAD_F32_D256,
                            "    if (tid == 0 && j + 1 < ntiles) {\n"
                            "      mbar_arrive(k_full);\n"
                            "      mbar_arrive(v_full);\n    }")
    skeleton = no_exp.replace(_SCORES_F32_D256, one_slice).replace(
        _PRODUCT_F32_D256, "    ;")
    return {"kernel": src, "no_exp": no_exp, "no_scores": no_scores,
            "no_product": no_product, "no_split": no_split,
            "no_reload": no_reload, "skeleton": skeleton}


def variants(src, d256=False):
    """{name: source} of the D = 64/128 kernel's source or, with
    ``d256``, of the head_dim-256 kernel's; raises if the kernel no
    longer has the text a variant edits."""
    loads = list(_LOADS_D256) if d256 else [_LOAD]
    for piece in [_EXP, _SCORES, _PRODUCT] + loads:
        if src.count(piece) != 1:
            raise RuntimeError("the kernel's source changed; update the "
                               "ablations of tools/torch_flash_fwd_ablation"
                               ".py")
    no_exp = src.replace(_EXP, "        e = e - m_new;")
    no_scores = src.replace(_SCORES, "      if (hh == 0 && kk == 0)\n"
                            + _SCORES)
    no_product = src.replace(_PRODUCT, "      ;")
    if d256:
        no_reload = src
        for load, arrive in _LOADS_D256.items():
            no_reload = no_reload.replace(load, arrive)
    else:
        no_reload = src.replace(_LOAD, "        if (j > 0) {\n"
                                "          mbar_arrive(full(stage));\n"
                                "        } else {\n" + _LOAD +
                                "\n        }")
    skeleton = no_exp.replace(_SCORES, "      if (hh == 0 && kk == 0)\n"
                              + _SCORES).replace(_PRODUCT, "      ;")
    return {"kernel": src, "no_exp": no_exp, "no_scores": no_scores,
            "no_product": no_product, "no_reload": no_reload,
            "skeleton": skeleton}


def build(sources, out_dir, entry="flash_attn_fwd_sm90", pointers=5):
    """One nvcc per variant, started together, each finding the kernel's
    headers (sm90.cuh) in csrc/; {name: ctypes library} with ``entry``
    declared: ``pointers`` tensors, then the tensor-core entry points'
    dims, geometries, scale, causal flag and stream."""
    nvcc = _build._nvcc()
    procs = {}
    for name, src in sources.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", CSRC, "-shared", "-o",
             os.path.join(out_dir, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        geo = ctypes.POINTER(ctypes.c_longlong)
        fn = getattr(lib, entry)
        fn.argtypes = [p] * pointers + [i] * 5 + [geo, geo, ctypes.c_float,
                                                   i, p]
        fn.restype = i
        libs[name] = lib
    return libs


def device_ms(fn, calls=10):
    """The CUDA kernels' summed duration in a traced window of ``calls``
    calls of ``fn``, over ``calls``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / 1e3 / calls


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    kind = ap.add_mutually_exclusive_group()
    kind.add_argument("--d256", action="store_true",
                      help="the bf16 head_dim-256 kernel, at H = 3, D = 256")
    kind.add_argument("--f32-d256", action="store_true",
                      help="the fp32 head_dim-256 kernel (split TF32), at "
                           "H = 3, D = 256")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_flash_fwd_ablation: no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    if args.f32_d256:
        with open(SOURCE_F32_D256) as f:
            sources = variants_f32_d256(f.read())
        entry = "flash_attn_fwd_f32_d256_sm90"
    else:
        with open(SOURCE_D256 if args.d256 else SOURCE) as f:
            sources = variants(f.read(), args.d256)
        entry = ("flash_attn_fwd_d256_sm90" if args.d256
                 else "flash_attn_fwd_sm90")
    d256 = args.d256 or args.f32_d256
    b, t, h, d = (8, 2048, 3, 256) if d256 else (8, 2048, 12, 64)
    dtype = torch.float32 if args.f32_d256 else torch.bfloat16
    r = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(r.randn(b, t, h, d).astype(np.float32))
               .cuda().to(dtype) for _ in range(3))
    ref_out, ref_lse = fl.flash_attention_fwd_plain(q, k, v, True, None,
                                                    "BTHD")
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources, tmp, entry)
        names = list(libs)
        for name in names + names[::-1]:
            def run(lib=libs[name]):
                return fl._launch_fwd_sm90(lib, entry, q, k, v, True,
                                           d ** -0.5, "BTHD")
            row = dict(kernel="flash_attention_fwd", variant=name, b=b, t=t,
                       h=h, d=d, dtype=str(dtype)[6:], ms=_median_ms(run),
                       device_ms=device_ms(run), card=card)
            if name == "kernel":
                out, lse = run()
                row["out_err"] = float((out.float() - ref_out.float())
                                       .abs().max())
                row["lse_err"] = float((lse - ref_lse).abs().max())
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
