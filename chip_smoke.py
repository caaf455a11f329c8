#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one CUDA card: build, check, time, serve.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero with no result):

1. environment: the card's name and power limit (nvidia-smi), torch's and
   CUDA's versions; no CUDA card is an error;
2. build: nvcc compiles ``paddle_tpu_torch/csrc/*.cu`` into
   ``build/torch_kernels/`` (ptxas's register and shared-memory report is
   printed);
3. every kernel against its plain PyTorch version on the card, at the
   serving shapes (fp32), in bf16, and at a ragged edge with labels
   outside the vocabulary;
4. timing with CUDA events (median of 30 after warm-up): the kernel, its
   plain version, one PyTorch library call computing the same function,
   and the card's bound for the same work;
5. serving at full GPT width (12 x 768, vocab 32000, random weights from
   seed 0): 8 prompts covering every prefill bucket through
   ServingEngine.submit + run_until_idle, two of them again one after the
   other on a threaded engine (tokens must be bit-identical), greedy
   agreement of every request with the full-context reference, prompt
   scoring through the fused lm-head + CE kernel (its launch counter
   must rise), and a traced window of decode ticks;
6. a ``{"kernels": [...]}`` line: per ported kernel, its launches on the
   serving path, its largest error against the plain version and its
   times;
7. the last line: ``{"ok": true, "device": {...}}``.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
_PEAK_BYTES_PER_S = 3.35e12
_PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # fp32 outside tensor cores

_SERVE_D, _SERVE_V = 768, 32000
_SCORE_NS = (31, 127, 511)  # score's N = bucket - 1 at buckets 32/128/512
_PROMPT_LENS = (17, 45, 96, 128, 200, 311, 480, 500)
_NEW_TOKENS = 32
_REPEATS = 30


def _say(**kw) -> None:
    print(json.dumps(kw), flush=True)


def _environment(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs on a CUDA card only")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _say(phase="environment", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count())
    return card


def _build():
    from paddle_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    print(_build.build_log(), flush=True)
    _say(phase="build", seconds=round(time.perf_counter() - t0, 3),
         nvcc_seconds=round(_build.build_seconds(), 3),
         sources=[os.path.relpath(s) for s in _build.sources()])


def _inputs(torch, n, d, v, dtype, seed):
    r = np.random.RandomState(seed)
    x = torch.from_numpy((r.randn(n, d) * 0.5).astype(np.float32))
    w = torch.from_numpy((r.randn(v, d) * 0.5).astype(np.float32))
    lbl = torch.from_numpy(r.randint(0, v, (n,)).astype(np.int64))
    return (x.to("cuda", dtype), w.to("cuda", dtype), lbl.to("cuda"))


def _check_kernel(torch):
    """lmhead_ce against lmhead_ce_plain on the card, nll and lse, at
    rtol = atol = tol. fp32: 1e-4, both sides sum exact fp32 products,
    in another order; bf16: 2e-3, the floor of
    tests/test_fused_lmhead_ce.py; the ragged case at the fp32 bound."""
    from paddle_tpu_torch.ops import lmhead_ce as ce

    cases = [(n, _SERVE_D, _SERVE_V, torch.float32, 1e-4) for n in _SCORE_NS]
    cases += [(511, _SERVE_D, _SERVE_V, torch.bfloat16, 2e-3),
              (33, 64, 130, torch.float32, 1e-4)]
    worst = 0.0
    for i, (n, d, v, dtype, tol) in enumerate(cases):
        x, w, lbl = _inputs(torch, n, d, v, dtype, seed=10 + i)
        if v == 130:  # labels outside [0, V) pick nothing
            lbl[3], lbl[7] = v, -1
        nll, lse = ce.lmhead_ce_fwd(x, w, lbl)
        ref_nll, ref_lse = ce.lmhead_ce_plain(x, w, lbl)
        torch.cuda.synchronize()
        err = max(float((nll - ref_nll).abs().max()),
                  float((lse - ref_lse).abs().max()))
        bad = ((nll - ref_nll).abs() > tol + tol * ref_nll.abs()).sum()
        if v == 130 and not (nll[[3, 7]] == lse[[3, 7]]).all():
            raise AssertionError("out-of-range labels picked a logit")
        if int(bad) or not torch.isfinite(nll).all():
            raise AssertionError(
                f"lmhead_ce disagrees with its plain version at n={n} d={d} "
                f"v={v} {dtype}: {int(bad)} rows beyond {tol}, "
                f"max abs err {err}")
        worst = max(worst, err)
        _say(phase="kernel_check", kernel="lmhead_ce_fwd", n=n, d=d, v=v,
             dtype=str(dtype).replace("torch.", ""), tolerance_rel=tol,
             max_abs_err=err)
    return worst


def _median_ms(torch, fn, *args):
    for _ in range(3):
        fn(*args)
    times = []
    for _ in range(_REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound(n, d, v, dtype_name, elem):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    2*N*V*D FLOPs over the peak rate of the inputs' type. Bytes: x, W
    and the int64 labels read once, the fp32 nll written once."""
    nbytes = (n * d + v * d) * elem + 8 * n + 4 * n
    t_bytes = nbytes / _PEAK_BYTES_PER_S
    t_ops = 2.0 * n * v * d / _PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def _time_kernel(torch, card):
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import lmhead_ce as ce

    def library(x, w, lbl):
        return F.cross_entropy(x @ w.t(), lbl, reduction="none")

    rows = {}
    for n, dtype in [(n, torch.float32) for n in _SCORE_NS] + \
            [(511, torch.bfloat16)]:
        x, w, lbl = _inputs(torch, n, _SERVE_D, _SERVE_V, dtype, seed=n)
        name = str(dtype).replace("torch.", "")
        bound_ms, bound_by = _bound(n, _SERVE_D, _SERVE_V, name,
                                    x.element_size())
        row = dict(phase="kernel_time", kernel="lmhead_ce_fwd", n=n,
                   d=_SERVE_D, v=_SERVE_V, dtype=name,
                   kernel_ms=_median_ms(torch, ce.lmhead_ce, x, w, lbl),
                   plain_ms=_median_ms(torch, ce.lmhead_ce_plain, x, w, lbl),
                   library_ms=_median_ms(torch, library, x, w, lbl),
                   bound_ms=bound_ms, bound_by=bound_by,
                   repeats=_REPEATS, card=card)
        _say(**row)
        rows[(n, name)] = row
    return rows


def _serve(torch, card):
    from paddle_tpu_torch.ops import lmhead_ce as ce
    from paddle_tpu_torch.serving import (DecodeModel, GPTConfig,
                                          ServingEngine, init_params, ledger)
    from paddle_tpu_torch.weights import params_from_numpy

    cfg = GPTConfig(vocab_size=_SERVE_V, n_layer=12, n_head=12,
                    d_model=_SERVE_D, max_seq_len=1024)
    t0 = time.perf_counter()
    params = params_from_numpy(init_params(cfg, seed=0), "cuda")
    model = DecodeModel(cfg, params=params, device="cuda", max_batch=8,
                        n_blocks=320, block_size=16,
                        prefill_buckets=[32, 128, 512])
    model.warm(full=True)
    n_params = sum(p.numel() for p in model.params.values())
    _say(phase="serve_setup", params=n_params,
         pages_bytes=model.init_pages(n_blocks=1).nbytes * model.n_blocks,
         seconds=round(time.perf_counter() - t0, 3))

    r = np.random.RandomState(0)
    prompts = [r.randint(1, _SERVE_V, size=n).tolist() for n in _PROMPT_LENS]

    # the main path, counted: the kernel's launches start from 0 here
    ce.reset_launches()
    ledger.reset()
    engine = ServingEngine(model)
    t0 = time.perf_counter()
    handles = [engine.submit(p, max_new_tokens=_NEW_TOKENS) for p in prompts]
    engine.run_until_idle()
    wall = time.perf_counter() - t0
    batched = [h.result(timeout=60) for h in handles]
    if any(len(t) != _NEW_TOKENS for t in batched):
        raise AssertionError(f"not every request got {_NEW_TOKENS} tokens: "
                             f"{[len(t) for t in batched]}")
    ttft_ms = [(h._req.t_first_token - h._req.t_submit) / 1e6
               for h in handles]
    ticks = {}
    for h in handles:
        for t_a, t_b, tick in h._req.tick_windows:
            ticks[tick] = (t_b - t_a) / 1e6
    decode_tokens = ledger.totals()["decode_tokens"]

    scores = [model.score(p) for p in prompts]
    launches = ce.launches
    if launches < 1:
        raise AssertionError("score never launched the lmhead_ce kernel")
    nll, total = scores[-1]
    if nll.shape != (_PROMPT_LENS[-1] - 1,) or not np.isfinite(nll).all():
        raise AssertionError(f"score gave {nll.shape}, finite="
                             f"{np.isfinite(nll).all()}")
    if abs(total - float(nll.astype(np.float64).sum())) > 1e-4 * abs(total):
        raise AssertionError(f"score total {total} != sum {nll.sum()}")

    # reference checks (not counted: the main path's counts are read)
    logits = model.full_logits(prompts[-1])[0].astype(np.float64)
    m = logits.max(-1, keepdims=True)
    lse = m[:, 0] + np.log(np.exp(logits - m).sum(-1))
    ref_nll = lse[:-1] - logits[np.arange(len(nll)), prompts[-1][1:]]
    score_err = float(np.abs(nll - ref_nll).max())
    if score_err > 1e-3:
        raise AssertionError(f"score nll off the full-logits reference by "
                             f"{score_err}")

    seq_engine = ServingEngine(model)
    seq_engine.start()
    try:
        sequential = [seq_engine.submit(prompts[i], _NEW_TOKENS)
                      .result(timeout=120) for i in (0, 7)]
    finally:
        seq_engine.stop(flush=False)
    if sequential != [batched[0], batched[7]]:
        raise AssertionError("batched tokens differ from sequential ones")

    # greedy agreement, teacher-forced on the engine's own tokens: a
    # disagreement counts only where the reference's top-2 margin
    # exceeds 1e-4 (a near-tie may flip on summation order)
    disagree = 0
    for prompt, got in zip(prompts, batched):
        ref = model.full_logits(prompt + got)[0]
        for j, tok in enumerate(got):
            row = ref[len(prompt) - 1 + j]
            top2 = np.sort(row)[-2:]
            if int(row.argmax()) != tok and top2[1] - top2[0] > 1e-4:
                disagree += 1
    if disagree:
        raise AssertionError(f"{disagree} greedy tokens disagree with the "
                             f"full-context reference beyond a 1e-4 margin")

    _profile_decode(torch, model, card)
    _say(phase="serve", requests=len(prompts), new_tokens=_NEW_TOKENS,
         generated_tokens=sum(len(t) for t in batched),
         decode_tokens=decode_tokens, wall_s=wall,
         tokens_per_s=sum(len(t) for t in batched) / wall,
         ttft_ms_mean=statistics.mean(ttft_ms), ttft_ms_max=max(ttft_ms),
         decode_ticks=len(ticks),
         decode_tick_ms_mean=statistics.mean(ticks.values()),
         sequential_bit_identical=True, greedy_disagreements=disagree,
         score_total_nll=total, score_max_abs_err_vs_full_logits=score_err,
         lmhead_ce_launches=launches, card=card,
         note="one smoke run, not a benchmark")
    return launches


def _profile_decode(torch, model, card, ticks=5):
    """A traced window of decode ticks at full batch (8 slots, 500
    tokens of context each): host wall per tick, device kernel time per
    tick (torch.profiler's CUDA activity), launches per tick and the
    kernels that take the most device time. A traced run: the tracer
    adds host time, so its wall is not the serving metric."""
    from torch.profiler import ProfilerActivity, profile

    B, per = model.max_batch, 500 // model.block_size + 1
    tables = np.zeros((B, model.max_blocks_per_req), np.int32)
    for b in range(B):
        tables[b, :per] = 1 + b * per + np.arange(per)
    lens = np.full(B, 500, np.int32)
    toks = np.arange(B, dtype=np.int32)
    pages = model.init_pages()
    model.decode(pages, tables, lens, toks)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            model.decode(pages, tables, lens, toks)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, t = kernels.get(e.name, (0, 0.0))
            kernels[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    device_ms = sum(t for _, t in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:6]
    _say(phase="decode_profile", ticks=ticks, batch=B, context=500,
         wall_ms_per_tick=wall_ms / ticks,
         device_ms_per_tick=device_ms / ticks,
         device_busy_share=device_ms / wall_ms if kernels else None,
         launches_per_tick=sum(n for n, _ in kernels.values()) / ticks,
         top_kernels=[{"name": k[:80], "calls": n, "ms": t}
                      for k, (n, t) in top],
         card=card, note="traced run; not measured if no CUDA events")


def main() -> int:
    import torch

    card = _environment(torch)
    # fp32 products in full fp32 on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build()
    max_err = _check_kernel(torch)
    times = _time_kernel(torch, card)
    launches = _serve(torch, card)
    t = times[(511, "float32")]
    _say(kernels=[{
        "name": "lmhead_ce_fwd", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/lmhead_ce.cu",
        "replaces": "paddle_tpu/ops/pallas/fused_lmhead_ce.py:99",
        "launches": launches, "max_abs_err": max_err,
        "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "shape": {"n": t["n"], "d": t["d"], "v": t["v"],
                  "dtype": t["dtype"]},
        "card": card}])
    _say(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
