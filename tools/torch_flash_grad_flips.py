#!/usr/bin/env python3
"""How often the bf16 flash gradients leave chip_smoke.py's bound, by
seed, on one CUDA card.

    python3 tools/torch_flash_grad_flips.py [--seeds N] [--long-seeds M]

``chip_smoke._flash_agrees`` holds bf16 dq, dk and dv to the plain
version within ``_BF16_GRAD``: one bf16 ulp (rtol 2^-7) plus 1e-3. Both
sides round P and dS to bf16 at the same places, but their fp32 values
before that rounding differ in the last bits (the tensor cores' sums
against cuBLAS's), so now and then an entry of P or dS rounds the other
way; a flip of a large dS moves a whole row of dk by ulp(dS) |q| scale,
which can be more than the bound where the row's values are small (and
of dq by ulp(dS) |k| scale).

For D = 64, 128 and 256, at B = 2, H = 2, T = 512, causal, BHTD (the
shape of a ``_FLASH_CASES`` case at D = 256) for N seeds (default 48)
and at B = 8, H = 3, T = 2048, causal, BTHD (the seq-2048 step's shape;
at D = 256 train_d256's) for M seeds (default 4), seeds 40, 41, ..., on
the inputs ``chip_smoke._flash_inputs`` makes, this counts the values of
dq, dk and dv beyond the bound:

- ``kernels``: the wrappers (the tensor-core kernels);
- ``exact``: the plain version with its two fp32 products S = q k^T and
  dP = dO v^T summed in float64 and rounded once to fp32 (the same
  rounding of P and dS to bf16 after), for dq, dk and dv.

One JSON line per (shape, D, seed) where a count is not 0, then the
totals per shape and D: values beyond, seeds with any, and seeds with
any in each of dq, dk and dv; the card's
name and power limit on each.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def exact_grads(torch, fl, q, k, v, do, lse, delta, causal, layout):
    """(dq, dk, dv) of the plain version with S and dP summed in
    float64."""
    def heads(t):
        return fl._heads_first(t, layout).double()

    scale = q.shape[-1] ** -0.5
    s = (heads(q) @ heads(k).transpose(-1, -2)).float()
    p = fl._masked(torch.exp(s * scale - lse[..., None]), causal, 0.0)
    dp = (heads(do) @ heads(v).transpose(-1, -2)).float()
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dv = p.to(q.dtype).float().transpose(-1, -2) @ fl._heads_first(do, layout)
    dk = (ds.transpose(-1, -2) @ fl._heads_first(q, layout)) * scale
    dq = (ds @ fl._heads_first(k, layout)) * scale
    return tuple(fl._to_layout(g, layout, q.dtype) for g in (dq, dk, dv))


def beyond(torch, got, want, tol):
    rtol, atol = tol
    diff = (got.float() - want.float()).abs()
    return int((diff > atol + rtol * want.float().abs()).sum())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=48)
    ap.add_argument("--long-seeds", type=int, default=4)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import torch

    card = cs._environment(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fl

    _build.load()
    tol = cs._BF16_GRAD
    totals = {}
    shapes = [(("BHTD", 2, 2, 512), args.seeds),
              (("BTHD", 8, 3, 2048), args.long_seeds)]
    for (layout, b, h, t), seeds in shapes:
        for d in (64, 128, 256):
            for seed in range(40, 40 + seeds):
                q, k, v, do = cs._flash_inputs(torch, b, h, t, t, d,
                                               torch.bfloat16, layout, seed)
                got, ref = cs._flash_outputs(torch, q, k, v, do, True, layout)
                delta = fl.flash_attention_delta(ref["out"], do, layout)
                dq, dk, dv = exact_grads(torch, fl, q, k, v, do, ref["lse"],
                                         delta, True, layout)
                torch.cuda.synchronize()
                row = {"kernels": {n: beyond(torch, got[n], ref[n], tol)
                                   for n in ("dq", "dk", "dv")},
                       "exact": {"dq": beyond(torch, dq, ref["dq"], tol),
                                 "dk": beyond(torch, dk, ref["dk"], tol),
                                 "dv": beyond(torch, dv, ref["dv"], tol)}}
                key = f"{layout} B{b} H{h} T{t} D{d}"
                for kind, counts in row.items():
                    tot = totals.setdefault(key, {}).setdefault(
                        kind, {"values": 0, "seeds_beyond": 0,
                               "seeds": 0})
                    tot["values"] += sum(counts.values())
                    tot["seeds_beyond"] += int(sum(counts.values()) > 0)
                    tot["seeds"] += 1
                    for n, c in counts.items():  # seeds beyond, by gradient
                        by = tot.setdefault("seeds_beyond_by_grad", {})
                        by[n] = by.get(n, 0) + int(c > 0)
                if any(sum(c.values()) for c in row.values()):
                    print(json.dumps(dict(shape=key, seed=seed,
                                          tolerance=tol, card=card, **row)),
                          flush=True)
                del q, k, v, do, got, ref, delta, dq, dk, dv
                torch.cuda.empty_cache()
    print(json.dumps(dict(totals=totals, card=card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
