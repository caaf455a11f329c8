#!/usr/bin/env python3
"""Where the fp32 lm-head + CE backward kernel spends its time, on one
CUDA card: ablations of ``paddle_tpu_torch/csrc/lmhead_ce_bwd_f32_sm90.cu``.

Each variant is the kernel's source with one part of its work removed,
built by its own nvcc (all started together) into its own library and
timed with CUDA events (median of 5 after 3 warm-up calls), dx and dW at
the static_amp step's shape (fp32, N = 16384, D = 768, V = 32768), in the
order kernel, variants, variants reversed, kernel:

- ``kernel``: the source as it is (its result is checked against the
  plain version at the card check's fp32 tolerance);
- ``no_loads``: no TMA load (the ring's barriers still turn over; the
  tiles hold whatever shared memory held);
- ``no_split``: the A fragments handed to the tensor cores as gathered,
  lo a copy of hi (no split into tf32 pairs);
- ``no_gather``: ``no_split`` with the A fragments made from the
  gathers' addresses instead of shared-memory loads;
- ``skeleton``: ``no_loads`` and ``no_gather`` together: the wgmma
  stream, its barriers and waits, the d-logits and the stores;
- ``hi_hi_only``: the two small products of the split (lo . hi, hi . lo)
  left out, a third of the tensor work;
- ``hi_hi_skeleton``: both.

The variants' outputs are wrong by construction; only their times mean
anything. Variants that change the operands' values (``no_split``,
``no_gather``) may also change the card's clock and power draw: beside
each variant's first timing the tool runs it for about 1.5 s more while
sampling ``nvidia-smi`` (SM clock in MHz, power in W; medians). Run from
the root of a checkout:

    python3 tools/torch_ce_bwd_f32_ablation.py

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
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from paddle_tpu_torch.ops import _build  # noqa: E402
from paddle_tpu_torch.ops import lmhead_ce as ce  # noqa: E402

CSRC = os.path.join(ROOT, "paddle_tpu_torch", "csrc")
SOURCE = os.path.join(CSRC, "lmhead_ce_bwd_f32_sm90.cu")
_SCORE_LOADS = """      mbar_expect_tx(full, STAGE);
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const int k0 = PAD * p + BOX * w;
        tma_load(dst + w * COL_BOX, map_b, k0, c0, full);
        tma_load(dst + 2 * COL_BOX + w * ROW_BOX, map_hi, k0, row0, full);
        tma_load(dst + 3 * COL_BOX + w * ROW_BOX, map_lo, k0, row0, full);
      }"""
_PRODUCT_LOADS = "const int nb = max(0, min(4, (d - d0) / BOX));"
_SPLIT = """  const float h = tf32_rna(a);
  hi = __float_as_uint(h);
  lo = __float_as_uint(tf32_rna(a - h));"""
_GATHER = "  return *reinterpret_cast<const float*>(tile + off);"
_SMALL = """    wgmma_n32_tf32_rs(small, al[k][0], al[k][1], al[k][2], al[k][3], dh,
                      acc);
    wgmma_n32_tf32_rs(small, ah[k][0], ah[k][1], ah[k][2], ah[k][3], dl, 1);
"""


def variants(src):
    """{name: source}; raises if the kernel no longer has the text a
    variant edits."""
    for piece in (_SCORE_LOADS, _PRODUCT_LOADS, _SPLIT, _GATHER, _SMALL):
        if piece not in src:
            raise RuntimeError("the kernel's source changed; update the "
                               "ablations of "
                               "tools/torch_ce_bwd_f32_ablation.py")
    no_loads = src.replace(
        _SCORE_LOADS, "      mbar_expect_tx(full, 0);").replace(
        _PRODUCT_LOADS, "const int nb = 0;")
    no_split = src.replace(_SPLIT, "  hi = lo = __float_as_uint(a);")
    no_gather = no_split.replace(
        _GATHER, "  return __uint_as_float(off + (uint32_t)(size_t)tile);")
    skeleton = no_loads.replace(
        _SPLIT, "  hi = lo = __float_as_uint(a);").replace(
        _GATHER, "  return __uint_as_float(off + (uint32_t)(size_t)tile);")
    return {"kernel": src, "no_loads": no_loads, "no_split": no_split,
            "no_gather": no_gather, "skeleton": skeleton,
            "hi_hi_only": src.replace(_SMALL, ""),
            "hi_hi_skeleton": skeleton.replace(_SMALL, "")}


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
        lib.lmhead_ce_bwd_f32_sm90.argtypes = [p] * 8 + [i] * 6 + [p]
        lib.lmhead_ce_bwd_f32_sm90.restype = i
        libs[name] = lib
    return libs


def _median_ms(fn):
    for _ in range(3):
        fn()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _sample(fn, seconds=1.5):
    """Median SM clock (MHz) and power draw (W) from nvidia-smi, polled
    while fn runs back to back for about ``seconds``."""
    rows, done = [], threading.Event()

    def poll():
        while not done.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, timeout=30).stdout.split(",")
            rows.append((float(out[0]), float(out[1])))
            time.sleep(0.1)

    fn()
    torch.cuda.synchronize()
    thread = threading.Thread(target=poll)
    thread.start()
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        fn()
        torch.cuda.synchronize()
    done.set()
    thread.join()
    return {"sm_clock_mhz": statistics.median(r[0] for r in rows),
            "power_w": statistics.median(r[1] for r in rows),
            "samples": len(rows)}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_ce_bwd_f32_ablation: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    with open(SOURCE) as f:
        sources = variants(f.read())
    n, d, v = 16384, 768, 32768
    r = np.random.RandomState(5)
    x = torch.from_numpy((r.randn(n, d) * 0.5).astype(np.float32)).cuda()
    w = torch.from_numpy((r.randn(v, d) * 0.5).astype(np.float32)).cuda()
    lbl = torch.from_numpy(r.randint(0, v, (n,))).cuda()
    g = torch.full((n,), 1.0 / n, device="cuda")
    lse = ce.lmhead_ce_plain(x, w, lbl)[1]
    grads = (("dx", ce.lmhead_ce_dx, ce.lmhead_ce_dx_plain),
             ("dw", ce.lmhead_ce_dw, ce.lmhead_ce_dw_plain))
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources, tmp)
        names = list(libs)
        # the wrappers reach the kernels through _build.load()
        _build.load = lambda: libs["kernel"]
        for name, kern, plain in grads:
            got, ref = kern(x, w, lbl, lse, g), plain(x, w, lbl, lse, g)
            bad = int(((got - ref).abs() > 1e-4 + 1e-4 * ref.abs()).sum())
            print(json.dumps({"check": name, "values_beyond_1e-4": bad,
                              "card": card}), flush=True)
            if bad:
                raise SystemExit(f"the kernel's {name} disagrees with its "
                                 f"plain version")
            del got, ref
        times, sampled = {}, set()
        for name in ["kernel"] + names[1:] + names[:0:-1] + ["kernel"]:
            _build.load = lambda lib=libs[name]: lib
            for grad, kern, _ in grads:
                ms = _median_ms(lambda: kern(x, w, lbl, lse, g))
                times.setdefault((name, grad), []).append(ms)
                row = {"variant": name, "grad": grad, "ms": ms, "card": card}
                if (name, grad) not in sampled:
                    sampled.add((name, grad))
                    row.update(_sample(lambda: kern(x, w, lbl, lse, g)))
                print(json.dumps(row), flush=True)
        print(json.dumps({"summary": {f"{k[0]}/{k[1]}": v
                                      for k, v in times.items()},
                          "shape": [n, d, v], "card": card}), flush=True)


if __name__ == "__main__":
    main()
