#!/usr/bin/env python3
"""Where the bf16 lm-head + CE backward kernel spends its time, on one
CUDA card: ablations of ``paddle_tpu_torch/csrc/lmhead_ce_bwd_sm90.cu``.

Each variant is the kernel's source with one part of its work removed,
built by its own nvcc (all started together) into its own library and
timed with CUDA events (median of 20 after 3 warm-up calls), dx and dW at
the training shape (bf16, D = 768, V = 32768, N = 4096; ``--long`` adds
N = 16384), in the order kernel, variants, variants reversed, kernel:

- ``kernel``: the source as it is (its result is checked against the
  plain version: largest error beyond one bf16 ulp);
- ``no_reload``: no column tile loaded after the first (the ring's
  barriers still turn over): the compute alone;
- ``no_score``: the score wgmma only on a tile's first pair of chunks;
- ``no_product``: the second product only on the first column tile;
- ``skeleton``: ``no_score`` and ``no_product`` together: the loads,
  barriers and d-logits alone.

The variants' outputs are wrong by construction; only their times mean
anything. Run from the root of a checkout:

    python3 tools/torch_ce_bwd_ablation.py [--long]

It prints one JSON line per timing, the card's name and power limit
beside each.
"""
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from paddle_tpu_torch.ops import _build  # noqa: E402
from paddle_tpu_torch.ops import lmhead_ce as ce  # noqa: E402

CSRC = os.path.join(ROOT, "paddle_tpu_torch", "csrc")
SOURCE = os.path.join(CSRC, "lmhead_ce_bwd_sm90.cu")
_LOAD = """          mbar_expect_tx(full(stage), STAGE);
          tma_load(b_s + stage * STAGE, &map_b, 2 * q * TILE, t * TILE,
                   full(stage));
          tma_load(b_s + stage * STAGE + CHUNK, &map_b, (2 * q + 1) * TILE,
                   t * TILE, full(stage));"""
_NO_LOAD = """          if (t > 0) {
            mbar_arrive(full(stage));
          } else {
""" + _LOAD + """
          }"""
_SCORE = """#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_n32(s, desc(a_addr + 32 * kk), desc(b_addr + 32 * kk),
                    (p | h | kk) != 0);"""
_PRODUCT = """#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_n64<1>(o[cc], desc(dl_addr + 32 * kk),
                     desc(b_addr + kk * 16 * 128), 1);"""


def _only(cond, text):
    return f"      if ({cond}) {{\n{text}\n      }}"


def variants(src):
    """{name: source}; raises if the kernel no longer has the text a
    variant edits."""
    for piece in (_LOAD, _SCORE, _PRODUCT):
        if piece not in src:
            raise RuntimeError("the kernel's source changed; update the "
                               "ablations of tools/torch_ce_bwd_ablation.py")
    no_score = src.replace(_SCORE, _only("p == 0", _SCORE))
    return {"kernel": src,
            "no_reload": src.replace(_LOAD, _NO_LOAD),
            "no_score": no_score,
            "no_product": src.replace(_PRODUCT, _only("t == 0", _PRODUCT)),
            "skeleton": no_score.replace(_PRODUCT,
                                         _only("t == 0", _PRODUCT))}


def build(sources, out_dir):
    """One nvcc per variant, started together, each finding the kernel's
    headers (sm90.cuh) in csrc/; {name: ctypes library}."""
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
        lib.lmhead_ce_bwd_sm90.argtypes = [p] * 6 + [i] * 4 + [p]
        lib.lmhead_ce_bwd_sm90.restype = i
        libs[name] = lib
    return libs


def _launch(lib, a, b, lbl, g, lse, token_rows):
    out = torch.empty_like(a)
    err = lib.lmhead_ce_bwd_sm90(
        a.data_ptr(), b.data_ptr(), lbl.data_ptr(), g.data_ptr(),
        lse.data_ptr(), out.data_ptr(), a.shape[0], b.shape[0], a.shape[1],
        token_rows, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: {err}")
    return out


def _median_ms(fn):
    for _ in range(3):
        fn()
    times = []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("torch_ce_bwd_ablation: no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    with open(SOURCE) as f:
        sources = variants(f.read())
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources, tmp)
        names = list(libs)
        order = names + names[::-1]
        d, v = 768, 32768
        for n in (4096, 16384) if "--long" in argv else (4096,):
            r = np.random.RandomState(0)
            x = torch.from_numpy((r.randn(n, d) * 0.5).astype(np.float32))
            w = torch.from_numpy((r.randn(v, d) * 0.5).astype(np.float32))
            x, w = x.cuda().bfloat16(), w.cuda().bfloat16()
            lbl = torch.from_numpy(r.randint(0, v, n).astype(np.int64)).cuda()
            g = torch.full((n,), 1.0 / n, device="cuda")
            lse = ce.lmhead_ce_plain(x, w, lbl)[1]
            for kernel, a, b, tr, plain in (
                    ("lmhead_ce_dx", x, w, 1, ce.lmhead_ce_dx_plain),
                    ("lmhead_ce_dw", w, x, 0, ce.lmhead_ce_dw_plain)):
                ref = plain(x, w, lbl, lse, g).float()
                for name in order:
                    lib = libs[name]
                    got = _launch(lib, a, b, lbl, g, lse, tr).float()
                    row = dict(kernel=kernel, variant=name, n=n, d=d, v=v,
                               ms=_median_ms(lambda: _launch(
                                   lib, a, b, lbl, g, lse, tr)),
                               card=card)
                    if name == "kernel":
                        row["excess_over_ulp"] = float(
                            ((got - ref).abs() - 2 ** -7 * ref.abs()).max())
                    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
