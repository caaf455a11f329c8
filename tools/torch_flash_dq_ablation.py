#!/usr/bin/env python3
"""Where the bf16 flash dq at head_dim 256 spends its time, on one CUDA
card: ablations of ``paddle_tpu_torch/csrc/flash_attention_dq_d256_sm90.cu``.

Each variant is the kernel's source with one part of its work removed,
built by its own nvcc (all started together) into its own library and
timed at train_d256's shape (B = 8, T = 2048, H = 3, D = 256, bf16,
causal, BTHD), in the order kernel, variants, variants reversed, kernel:

- ``kernel``: the source as it is (its result is checked against the
  plain version: largest error of dq);
- ``no_trade``: the two warpgroups trade no partial S and dP tiles (no
  stores to shared memory, no block barrier a tile, no adds): each
  computes dS from its own half of the sums over D;
- ``no_exp``: dS without its exponential (P = s * scale - lse);
- ``no_product``: no dS . K wgmma (so dS, and with it the exponentials,
  may be dropped by the compiler too: the score products stay, as their
  wgmma are volatile);
- ``no_reload``: no key or value tile loaded after the first three,
  which the prologue loads (the ring's barriers still turn over);
- ``skeleton``: ``no_trade``, ``no_exp`` and ``no_product`` together:
  the loads, the score products and the barriers alone.

Each row carries ``ms`` (CUDA events, median of 20 after 3 warm-up
calls) and ``device_ms``: the kernel's own duration in a
``torch.profiler`` trace of 10 calls, without the host's time to encode
the tensor maps and launch, which the CUDA-event time of one call holds.
The variants' outputs are wrong by construction; only their times mean
anything. Run from the root of a checkout:

    python3 tools/torch_flash_dq_ablation.py

It prints one JSON line per timing, the card's name and power limit
beside each.
"""
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

from paddle_tpu_torch.ops import flash_attention as fl  # noqa: E402
from torch_ce_bwd_ablation import _median_ms  # noqa: E402
from torch_flash_fwd_ablation import build, device_ms  # noqa: E402

SOURCE = os.path.join(ROOT, "paddle_tpu_torch", "csrc",
                      "flash_attention_dq_d256_sm90.cu")
ENTRY = "flash_attn_dq_d256_sm90"
_TRADE = "    trade(s, dp, j);\n"
_EXP = "        dp[e] = expf(x) * (dp[e] - dl[i]);"
_PRODUCT = "    rs_wgmma(dq, da, ka);\n"
_LOAD = "      load(j + 1);"


def variants(src):
    """{name: source} of the kernel's source; raises if the kernel no
    longer has the text a variant edits."""
    for piece in (_TRADE, _EXP, _PRODUCT, _LOAD):
        if src.count(piece) != 1:
            raise RuntimeError("the kernel's source changed; update the "
                               "ablations of tools/torch_flash_dq_ablation"
                               ".py")
    no_trade = src.replace(_TRADE, "")
    no_exp = src.replace(_EXP, "        dp[e] = x * (dp[e] - dl[i]);")
    no_product = src.replace(_PRODUCT, "")
    no_reload = src.replace(_LOAD, "      mbar_arrive(full(j + 1));")
    skeleton = no_trade.replace(_EXP, "        dp[e] = x * (dp[e] - dl[i]);"
                                ).replace(_PRODUCT, "")
    return {"kernel": src, "no_trade": no_trade, "no_exp": no_exp,
            "no_product": no_product, "no_reload": no_reload,
            "skeleton": skeleton}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_flash_dq_ablation: no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    with open(SOURCE) as f:
        sources = variants(f.read())
    b, t, h, d = 8, 2048, 3, 256
    r = np.random.RandomState(0)
    q, k, v, do = (torch.from_numpy(r.randn(b, t, h, d).astype(np.float32))
                   .cuda().bfloat16() for _ in range(4))
    out, lse = fl.flash_attention_fwd_plain(q, k, v, True, None, "BTHD")
    delta = fl.flash_attention_delta(out, do, "BTHD")
    ref = fl.flash_attention_dq_plain(q, k, v, do, lse, delta, True, None,
                                      "BTHD")
    geo = [(ctypes.c_longlong * 7)(*fl.tma_geometry(x, "BTHD"))
           for x in (q, k)]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources, tmp, ENTRY, pointers=7)
        names = list(libs)
        for name in names + names[::-1]:
            def run(lib=libs[name]):
                dq = torch.empty_like(q)
                err = getattr(lib, ENTRY)(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h,
                    t, t, d, *geo, d ** -0.5, 1,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed, error {err}")
                return dq
            row = dict(kernel="flash_attention_dq", variant=name, b=b, t=t,
                       h=h, d=d, ms=_median_ms(run),
                       device_ms=device_ms(run), card=card)
            if name == "kernel":
                row["dq_err"] = float((run().float() - ref.float())
                                      .abs().max())
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
