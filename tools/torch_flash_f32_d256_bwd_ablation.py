#!/usr/bin/env python3
"""Where the fp32 flash dq and dk/dv in split TF32 spend their time, on
one CUDA card: ablations of
``paddle_tpu_torch/csrc/flash_attention_dq_f32_d256_sm90.cu`` and
``flash_attention_dkv_f32_d256_sm90.cu`` (``--head-dim 256``, the
default), or of ``flash_attention_dkv_f32_sm90.cu`` (``--head-dim 64`` or
``128``; the fp32 dq there, ``flash_attention_dq_f32_sm90.cu``, is not
ablated), and of the helpers they share, ``flash_f32_bwd.cuh``.

Each variant is the sources with one part of the work removed, built by
its own nvcc (all started together; a variant's header is written beside
its source, where ``#include "..."`` finds it first) into its own
library and timed at the fp32 training shape in heads of the head_dim (B
= 8, T = 2048, H = 768 / D, causal, BTHD), in the order kernel,
variants, variants reversed, kernel:

- ``kernel``: the sources as they are (checked against the plain
  version: largest error of each output);
- ``no_split``: the resident tile's A fragments loaded but not split
  (hi = the value, lo = 0);
- ``no_frags``: no A fragment of the resident tile loaded or split;
- ``no_scores``: no score wgmma (S and dP stay what the registers hold);
- ``one_product``: one score wgmma a slice (hi . hi) in place of three:
  what the count of score wgmma costs;
- ``no_products``: no accumulating wgmma (dQ^T, dK^T, dV^T);
- ``no_flush``: a group's sums neither staged in shared memory nor
  stored or added to the output by TMA;
- ``no_reload``: no stage tile loaded inside a group after its first
  (the stage's barrier still turns over);
- ``skeleton``: ``no_frags``, ``no_scores`` and ``no_products`` together:
  the loads, the splits of the stage, the trade (at head_dim 256), the
  exponentials and the barriers.

Each row carries ``ms`` (CUDA events, median of 20 after 3 warm-up
calls) and ``device_ms`` (the kernel's duration in a ``torch.profiler``
trace of 10 calls). The variants' outputs are wrong by construction;
only their times mean anything. Run from the root of a checkout:

    python3 tools/torch_flash_f32_d256_bwd_ablation.py [--head-dim {64,128,256}]

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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from paddle_tpu_torch.ops import _build  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as fl  # noqa: E402
from torch_ce_bwd_ablation import _median_ms  # noqa: E402
from torch_flash_fwd_ablation import device_ms  # noqa: E402

CSRC = os.path.join(ROOT, "paddle_tpu_torch", "csrc")
HEADER = "flash_f32_bwd.cuh"
# {kernel: (source, entry point, its pointer arguments)} at head_dim 256,
# and the kernels of each head_dim
KERNELS = {"flash_attention_dq": ("flash_attention_dq_f32_d256_sm90.cu",
                                  "flash_attn_dq_f32_d256_sm90", 7),
           "flash_attention_dkv": ("flash_attention_dkv_f32_d256_sm90.cu",
                                   "flash_attn_dkv_f32_d256_sm90", 8)}
_DKV_F32 = {"flash_attention_dkv": ("flash_attention_dkv_f32_sm90.cu",
                                    "flash_attn_dkv_f32_sm90", 8)}
KERNELS_BY_HEAD_DIM = {64: _DKV_F32, 128: _DKV_F32, 256: KERNELS}
# the text each variant edits in the header
_SPLIT = ("      const float h = tf32_rna(a);\n"
          "      f.hi[k][x] = __float_as_uint(h);\n"
          "      f.lo[k][x] = __float_as_uint(tf32_rna(a - h));\n")
_LOAD_A = ("      const float a = *reinterpret_cast<const float*>(box + "
           "swz(row, col));\n")
_SCORE = ("    wgmma_n16_tf32_rs(c, l[0], l[1], l[2], l[3], dh, kd != 0);\n"
          "    wgmma_n16_tf32_rs(c, h[0], h[1], h[2], h[3], dl, 1);\n"
          "    wgmma_n16_tf32_rs(c, h[0], h[1], h[2], h[3], dh, 1);\n")
_PRODUCT = "".join(
    f"      wgmma_n64_tf32_rs(acc[mb], {a}[0], {a}[1], {a}[2], {a}[3], {d}, "
    "1);\n" for a, d in (("l", "dh"), ("h", "dl"), ("h", "dh")))
_STAGE_OUT = ("      *reinterpret_cast<float*>(tile + (col >> 5) * RES_BOX +\n"
              "                                swz(row, col & 31)) = "
              "acc[mb][e] * mul;\n")
_FLUSH = ("    if (first)\n"
          "      tma_store_3d(map, src + cb * RES_BOX, x, y, c2);\n"
          "    else\n"
          "      tma_reduce_add_3d(map, src + cb * RES_BOX, x, y, c2);\n")
# and in each kernel's source
_RELOAD = "if (tid == 0 && j + 1 < group_end) load(j + 1);"


def variants(header, sources):
    """{variant: (header, {kernel: source})}; raises if the code no longer
    has the text a variant edits."""
    for piece in (_SPLIT, _LOAD_A, _SCORE, _PRODUCT, _STAGE_OUT, _FLUSH):
        if header.count(piece) != 1:
            raise RuntimeError("flash_f32_bwd.cuh changed; update the "
                               "ablations of tools/torch_flash_f32_d256_bwd_"
                               "ablation.py")
    for src in sources.values():
        if src.count(_RELOAD) != 1:
            raise RuntimeError("a kernel's source changed; update the "
                               "ablations of tools/torch_flash_f32_d256_bwd_"
                               "ablation.py")
    no_split = ("      f.hi[k][x] = __float_as_uint(a);\n"
                "      f.lo[k][x] = 0u;\n")
    no_frags = header.replace(_LOAD_A, "      const float a = row + col;\n"
                              ).replace(_SPLIT, no_split)
    skeleton = no_frags.replace(_SCORE, "").replace(_PRODUCT, "")
    reload = {n: s.replace(_RELOAD, "if (tid == 0 && j + 1 < group_end) "
                           "mbar_arrive(st_full);")
              for n, s in sources.items()}
    return {"kernel": (header, sources),
            "no_split": (header.replace(_SPLIT, no_split), sources),
            "no_frags": (no_frags, sources),
            "no_scores": (header.replace(_SCORE, ""), sources),
            "one_product": (header.replace(_SCORE, _SCORE.splitlines(
                True)[2].replace("dh, 1)", "dh, kd != 0)")), sources),
            "no_products": (header.replace(_PRODUCT, ""), sources),
            "no_flush": (header.replace(_STAGE_OUT, "").replace(_FLUSH, ""),
                         sources),
            "no_reload": (header, reload),
            "skeleton": (skeleton, sources)}


def build(all_variants, out_dir, kernels=KERNELS):
    """One nvcc per variant and kernel (of ``kernels``), started together;
    {(variant, kernel): ctypes library} with the kernel's entry
    declared."""
    nvcc = _build._nvcc()
    procs = {}
    for name, (header, sources) in all_variants.items():
        vdir = os.path.join(out_dir, name)
        os.makedirs(vdir)
        with open(os.path.join(vdir, HEADER), "w") as f:
            f.write(header)
        for kernel, src in sources.items():
            cu = os.path.join(vdir, kernels[kernel][0])
            with open(cu, "w") as f:
                f.write(src)
            procs[name, kernel] = subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-I", CSRC, "-shared", "-o",
                 cu[:-3] + ".so", cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (name, kernel), proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} {kernel}:\n{log}")
        source, entry, pointers = kernels[kernel]
        lib = ctypes.CDLL(os.path.join(out_dir, name, source[:-3] + ".so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        geo = ctypes.POINTER(ctypes.c_longlong)
        fn = getattr(lib, entry)
        fn.argtypes = [p] * pointers + [i] * 5 + [geo, geo, ctypes.c_float,
                                                   i, p]
        fn.restype = i
        libs[name, kernel] = lib
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--head-dim", type=int, choices=sorted(
        KERNELS_BY_HEAD_DIM), default=256,
        help="the head_dim whose split-TF32 kernels are ablated")
    d = ap.parse_args().head_dim
    kernels = KERNELS_BY_HEAD_DIM[d]
    if not torch.cuda.is_available():
        raise SystemExit("torch_flash_f32_d256_bwd_ablation: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    with open(os.path.join(CSRC, HEADER)) as f:
        header = f.read()
    sources = {}
    for kernel, (source, _, _) in kernels.items():
        with open(os.path.join(CSRC, source)) as f:
            sources[kernel] = f.read()
    all_variants = variants(header, sources)
    b, t, h = 8, 2048, 768 // d
    r = np.random.RandomState(0)
    q, k, v, do = (torch.from_numpy(r.randn(b, t, h, d).astype(np.float32))
                   .cuda() for _ in range(4))
    out, lse = fl.flash_attention_fwd_plain(q, k, v, True, None, "BTHD")
    delta = fl.flash_attention_delta(out, do, "BTHD")
    args = (q, k, v, do, lse, delta, True, None, "BTHD")
    ref = {"flash_attention_dq": (fl.flash_attention_dq_plain(*args),),
           "flash_attention_dkv": fl.flash_attention_dkv_plain(*args)}
    geo = [(ctypes.c_longlong * 7)(*fl.tma_geometry(x, "BTHD"))
           for x in (q, k)]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(all_variants, tmp, kernels)
        names = list(all_variants)
        for kernel, (_, entry, _) in kernels.items():
            for name in names + names[::-1]:
                def run(lib=libs[name, kernel], kernel=kernel, entry=entry):
                    outs = [torch.empty_like(q)] if kernel.endswith("dq") \
                        else [torch.empty_like(k), torch.empty_like(v)]
                    err = getattr(lib, entry)(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        *(o.data_ptr() for o in outs), b, h, t, t, d, *geo,
                        d ** -0.5, 1, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name} {kernel}: launch failed, "
                                           f"error {err}")
                    return outs
                row = dict(kernel=kernel, variant=name, b=b, t=t, h=h, d=d,
                           ms=_median_ms(run), device_ms=device_ms(run),
                           card=card)
                if name == "kernel":
                    row["err"] = [float((g - w).abs().max())
                                  for g, w in zip(run(), ref[kernel])]
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
