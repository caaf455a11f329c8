#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one CUDA card: build, check, time,
serve, train.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero with no result):

1. environment: the card's name and power limit (nvidia-smi), torch's and
   CUDA's versions; no CUDA card is an error;
2. build: one nvcc per ``paddle_tpu_torch/csrc/*.cu``, all started
   together, into ``build/torch_kernels/`` (ptxas's register and
   shared-memory report is printed);
3. every kernel against its plain PyTorch version on the card: the
   lm-head + CE forward at the serving shapes (fp32), in bf16 and at the
   training shape; its dx and dW at the training shape in bf16, at N=511
   in fp32, at a ragged edge with labels V and -1 and a non-uniform g,
   and at D=1000 (the backward's accumulator sweeps D in two slabs); the
   CE kernels' peak added memory at the training shape (no [N, V]
   buffer); fused Adam(W) on bf16, fp32, 1-D and odd shapes;
4. timing with CUDA events (median of 30 after warm-up): each kernel, its
   plain version, one PyTorch library call computing the same function,
   and the card's bound for the same work, at the serving score shapes
   and at the training shape;
5. serving at full GPT width (12 x 768, vocab 32000, random weights from
   seed 0): 8 prompts covering every prefill bucket through
   ServingEngine.submit + run_until_idle, two of them again one after the
   other on a threaded engine (tokens must be bit-identical), greedy
   agreement of every request with the full-context reference, prompt
   scoring through the fused lm-head + CE kernel (its launch counter
   must rise), and a traced window of decode ticks;
6. training at full width: bench.py's gpt2s config (vocab 32768,
   12 x 768, seq 512, batch 8, bf16) through build_train_program,
   Adam.minimize and Executor.run: 3 warm-up and 10 timed steps on one
   fixed batch; the loss must be finite and fall, and each path kernel
   must launch every step (forward, dx and dW once, Adam 196 times);
   then one traced step (device time by kernel);
7. CPU against card: a tiny fp32 config trains 2 steps from the same
   numpy values on the CPU (plain versions) and on the card (kernels);
   loss and every persistable must agree at 1e-4;
8. a ``{"kernels": [...]}`` line: per ported kernel, its launches on the
   training path (the forward also on the serving path), its largest
   error against the plain version and its times at the training shape;
9. the card's name and power limit again, and the last line:
   ``{"ok": true, "device": {...}}``.
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
# bench.py's headline training config (gpt2s @ seq 512)
_TRAIN = dict(vocab_size=32768, n_layer=12, n_head=12, d_model=768,
              max_seq_len=512, dtype="bfloat16")
_TRAIN_B, _TRAIN_T = 8, 512
_TRAIN_N = _TRAIN_B * _TRAIN_T  # tokens per step: the CE kernels' N
_WARM_STEPS, _TIMED_STEPS = 3, 10
_ADAM_PER_STEP = 196  # wte, wpe, 16 per layer x 12, lnf scale and bias
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


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def _beyond(got, ref, rtol, atol) -> int:
    """Elements outside |got - ref| <= atol + rtol * |ref|."""
    got, ref = got.float(), ref.float()
    return int(((got - ref).abs() > atol + rtol * ref.abs()).sum())


def _no_logits_buffer(torch, name, fn) -> None:
    """The fused CE kernels allocate no [N, V] buffer, of logits or of
    d-logits: the peak device memory a call adds above what was allocated
    before it (its outputs and scratch) stays below N*V*2 bytes, the size
    of the smallest such buffer (bf16 logits)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    added = torch.cuda.max_memory_allocated() - base
    limit = _TRAIN_N * _TRAIN["vocab_size"] * 2
    _say(phase="kernel_memory", kernel=name, n=_TRAIN_N,
         v=_TRAIN["vocab_size"], peak_added_bytes=added,
         nv_bf16_bytes=limit)
    if added >= limit:
        raise AssertionError(f"{name} allocated {added} bytes at its peak, "
                             f"as much as an [N, V] buffer ({limit})")
    del out


def _check_training_kernels(torch):
    """The training path's kernels against their plain versions on the
    card. Forward at the training shape in bf16 at 2e-3 (the floor of
    tests/test_fused_lmhead_ce.py:89). dx and dW with a non-uniform
    per-row g in [0.5, 1.5]: bf16 at the training shape at 5e-2 (that
    test's :97-100; both sides round the d-logits to bf16, and may round
    one of them the other way), fp32 at N=511, at the ragged N=33, D=64,
    V=130 (labels V and -1) and at D=1000 at 1e-4 (exact fp32 products
    summed in another order). Adam, with and without weight decay, at an
    lr whose update spans several ulps of p: m and v at rtol 1e-5, p
    through its update in fp32 and bit for bit in bf16 (``_adam_agrees``).
    The CE kernels must also allocate no [N, V] buffer at the training
    shape. Returns {kernel: max abs err}."""
    from paddle_tpu_torch.ops import fused_adam as fa
    from paddle_tpu_torch.ops import lmhead_ce as ce

    worst = {"lmhead_ce_fwd": 0.0, "lmhead_ce_dx": 0.0, "lmhead_ce_dw": 0.0,
             "fused_adam": 0.0}
    d, v = _TRAIN["d_model"], _TRAIN["vocab_size"]
    x, w, lbl = _inputs(torch, _TRAIN_N, d, v, torch.bfloat16, seed=40)
    g = torch.full((_TRAIN_N,), 1.0 / _TRAIN_N, device="cuda")
    _no_logits_buffer(torch, "lmhead_ce_fwd", lambda: ce.lmhead_ce_fwd(
        x, w, lbl))
    nll, lse = ce.lmhead_ce_fwd(x, w, lbl)
    for name, kern in (("lmhead_ce_dx", ce.lmhead_ce_dx),
                       ("lmhead_ce_dw", ce.lmhead_ce_dw)):
        _no_logits_buffer(torch, name, lambda: kern(x, w, lbl, lse, g))
    ref_nll, ref_lse = ce.lmhead_ce_plain(x, w, lbl)
    bad = _beyond(nll, ref_nll, 2e-3, 2e-3) + _beyond(lse, ref_lse, 2e-3,
                                                      2e-3)
    worst["lmhead_ce_fwd"] = max(_err(nll, ref_nll), _err(lse, ref_lse))
    _say(phase="kernel_check", kernel="lmhead_ce_fwd", n=_TRAIN_N, d=d, v=v,
         dtype="bfloat16", tolerance_rel=2e-3,
         max_abs_err=worst["lmhead_ce_fwd"])
    if bad:
        raise AssertionError(f"lmhead_ce_fwd at the training shape: {bad} "
                             f"values beyond 2e-3")

    cases = [(_TRAIN_N, d, v, torch.bfloat16, 5e-2),
             (511, d, v, torch.float32, 1e-4),
             (33, 64, 130, torch.float32, 1e-4),
             (100, 1000, 300, torch.float32, 1e-4)]  # D > 768: two slabs
    for i, (n, dd, vv, dtype, tol) in enumerate(cases):
        x, w, lbl = _inputs(torch, n, dd, vv, dtype, seed=50 + i)
        if vv == 130:  # labels outside [0, V) hit no column
            lbl[3], lbl[7] = vv, -1
        g = torch.from_numpy(np.random.RandomState(60 + i).uniform(
            0.5, 1.5, n).astype(np.float32)).cuda()
        lse = ce.lmhead_ce_plain(x, w, lbl)[1]
        for name, kern, plain in (
                ("lmhead_ce_dx", ce.lmhead_ce_dx, ce.lmhead_ce_dx_plain),
                ("lmhead_ce_dw", ce.lmhead_ce_dw, ce.lmhead_ce_dw_plain)):
            got = kern(x, w, lbl, lse, g)
            ref = plain(x, w, lbl, lse, g)
            torch.cuda.synchronize()
            err = _err(got, ref)
            bad = _beyond(got, ref, tol, tol)
            worst[name] = max(worst[name], err)
            _say(phase="kernel_check", kernel=name, n=n, d=dd, v=vv,
                 dtype=str(dtype).replace("torch.", ""), tolerance_rel=tol,
                 max_abs_err=err)
            if bad or not torch.isfinite(got.float()).all():
                raise AssertionError(
                    f"{name} disagrees with its plain version at n={n} "
                    f"d={dd} v={vv} {dtype}: {bad} values beyond {tol}, "
                    f"max abs err {err}")

    shapes = [((v, d), torch.bfloat16), ((d, 4 * d), torch.float32),
              ((d,), torch.float32), ((7, 100), torch.float32)]
    for i, (shape, dtype) in enumerate(shapes):
        for wd in (0.0, 0.5):
            p, g, m, vv, lr, b1p, b2p = _adam_inputs(torch, shape, dtype,
                                                     seed=70 + i)
            ref = fa.fused_adam_plain(p, g, m, vv, lr, b1p, b2p,
                                      weight_decay=wd)
            got = fa.fused_adam(p.clone(), g, m.clone(), vv.clone(), lr, b1p,
                                b2p, weight_decay=wd)
            # p's value before its rounding to p's dtype: the plain update
            # in fp32 from the kernel's own m and v (beta1 = beta2 = 1
            # leaves them as they are; they are held against ref apart)
            pre_p = fa.fused_adam_plain(p.float(), g, got[1], got[2], lr, b1p,
                                        b2p, beta1=1.0, beta2=1.0,
                                        weight_decay=wd)[0]
            torch.cuda.synchronize()
            report = _adam_agrees(torch, p, got, pre_p, ref)
            err = max(_err(a, b) for a, b in zip(got, ref))
            worst["fused_adam"] = max(worst["fused_adam"], err)
            _say(phase="kernel_check", kernel="fused_adam", shape=list(shape),
                 dtype=str(dtype).replace("torch.", ""), weight_decay=wd,
                 max_abs_err=err, **report)
    return worst


def _adam_inputs(torch, shape, dtype, seed, device="cuda"):
    """p ~ N(0, 1) in p's dtype, g ~ 0.1 N(0, 1), m ~ 0.01 N(0, 1),
    v ~ (0.01 N(0, 1))^2, lr 0.1, beta powers at step 3: the update is
    several bf16 ulps of p, and lr * wd * p at wd 0.5 is 5% of p."""
    r = np.random.RandomState(seed)
    host = [r.randn(*shape), 0.1 * r.randn(*shape), 0.01 * r.randn(*shape),
            np.square(0.01 * r.randn(*shape))]
    p, g, m, v = (torch.from_numpy(a.astype(np.float32)).to(device)
                  for a in host)
    return (p.to(dtype), g.to(dtype), m, v,
            torch.tensor(0.1, device=device),
            torch.tensor([0.9 ** 3], device=device),
            torch.tensor([0.999 ** 3], device=device))


def _adam_agrees(torch, p_in, got, pre_p, ref) -> dict:
    """Holds one fused Adam step (got = p, m, v after the kernel) against
    the plain version and raises where they differ. m and v: against the
    plain step's (ref), rtol 1e-5, atol 1e-7. p: through its update
    dp = p_out - p_in, not its value, so that a step far below p's ulp
    cannot hide a wrong update, against pre_p, the plain update in fp32
    from the kernel's own m and v (so that where m = b1 m + (1 - b1) g
    cancels, the two sides' rounding of m, already held above, does not
    count twice). The two fp32 values may differ by 1e-5 * |dp|
    (contracted multiply-adds) plus 2 fp32 ulps of p (each side rounds
    p - step once). fp32 p: dp within that. bf16 p: bit for bit the
    nearest-even rounding of pre_p, except where pre_p lies within the
    same distance of a bf16 rounding midpoint (a tie either side may
    round its own way; counted). Fails too unless the median update is at
    least 2 ulps of p in p's dtype, so that the check sees the update.
    ``p_worst``: the largest |dp error| / tolerance (fp32), the share of
    values off the nearest-even rounding (bf16)."""
    p_out, m_out, v_out = got
    _, ref_m, ref_v = ref
    p32 = p_in.float()
    dp_ref = pre_p - p32
    slack = 1e-5 * dp_ref.abs() + 2.0 ** -22 * p32.abs()
    ulp = torch.finfo(p_in.dtype).eps * p32.abs().clamp_min(1e-30)
    step_ulps = float((dp_ref.abs() / ulp).median())
    bad_mv = _beyond(m_out, ref_m, 1e-5, 1e-7) + _beyond(v_out, ref_v, 1e-5,
                                                         1e-7)
    ties = 0
    if p_in.dtype == torch.bfloat16:
        bits = pre_p.view(torch.int32)
        mid = ((bits & ~0xFFFF) | 0x8000).view(torch.float32)
        near_tie = (pre_p - mid).abs() <= slack
        off = p_out != pre_p.to(torch.bfloat16)
        ties = int((off & near_tie).sum())
        bad_p = int((off & ~near_tie).sum())
        worst = float(off.float().mean())
    else:
        over = (p_out.float() - p32 - dp_ref).abs() / slack
        bad_p = int((over > 1).sum())
        worst = float(over.max())
    report = dict(p_rule="update dp" if p_in.dtype == torch.float32
                  else "bit-exact rounding", median_step_ulps=step_ulps,
                  rounding_ties=ties, p_beyond=bad_p, mv_beyond=bad_mv,
                  p_worst=worst)
    if bad_p or bad_mv or step_ulps < 2.0:
        raise AssertionError(f"fused_adam disagrees with its plain version "
                             f"at {tuple(p_in.shape)} {p_in.dtype}: {report}")
    return report


def _bound_ms(nbytes: float, flops: float, dtype_name: str):
    t_bytes = nbytes / _PEAK_BYTES_PER_S
    t_ops = flops / _PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def _time_training_kernels(torch, card):
    """Kernel, plain, library and bound at the training shape (bf16,
    N = 8 x 512 tokens, D = 768, V = 32768; g = 1/N, what mean() hands the
    loss; Adam on gpt.wte). Bounds count each input read once and each
    output written once, and the FLOPs of the kernel's own algorithm:
    2NVD for the forward, 4NVD for dx and for dW (the score tile is
    rebuilt, then multiplied again)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import fused_adam as fa
    from paddle_tpu_torch.ops import lmhead_ce as ce

    n, d, v = _TRAIN_N, _TRAIN["d_model"], _TRAIN["vocab_size"]
    x, w, lbl = _inputs(torch, n, d, v, torch.bfloat16, seed=80)
    g = torch.full((n,), 1.0 / n, device="cuda")
    lse = ce.lmhead_ce_fwd(x, w, lbl)[1]
    rows = {}

    def library_fwd():
        return F.cross_entropy(x @ w.t(), lbl, reduction="none")

    xr = x.detach().requires_grad_(True)
    wr = w.detach().requires_grad_(True)
    lib_loss = F.cross_entropy(xr @ wr.t(), lbl, reduction="none")

    def library_grad(*wrt):
        return lambda: torch.autograd.grad(lib_loss, wrt, g,
                                           retain_graph=True)

    io = (n * d + v * d) * 2 + 8 * n
    specs = [
        ("lmhead_ce_fwd", lambda: ce.lmhead_ce_fwd(x, w, lbl),
         lambda: ce.lmhead_ce_plain(x, w, lbl), library_fwd,
         _bound_ms(io + 4 * n, 2.0 * n * v * d, "bfloat16")),
        ("lmhead_ce_dx", lambda: ce.lmhead_ce_dx(x, w, lbl, lse, g),
         lambda: ce.lmhead_ce_dx_plain(x, w, lbl, lse, g), library_grad(xr),
         _bound_ms(io + 8 * n + 2 * n * d, 4.0 * n * v * d, "bfloat16")),
        ("lmhead_ce_dw", lambda: ce.lmhead_ce_dw(x, w, lbl, lse, g),
         lambda: ce.lmhead_ce_dw_plain(x, w, lbl, lse, g), library_grad(wr),
         _bound_ms(io + 8 * n + 2 * v * d, 4.0 * n * v * d, "bfloat16")),
    ]
    both_ms = _median_ms(torch, library_grad(xr, wr))
    for name, kern, plain, library, (bound, by) in specs:
        row = dict(phase="kernel_time", kernel=name, n=n, d=d, v=v,
                   dtype="bfloat16", kernel_ms=_median_ms(torch, kern),
                   plain_ms=_median_ms(torch, plain),
                   library_ms=_median_ms(torch, library), bound_ms=bound,
                   bound_by=by, repeats=_REPEATS, card=card)
        if name != "lmhead_ce_fwd":
            row["library"] = ("autograd.grad of F.cross_entropy(x @ w.t()) "
                              "for this gradient alone")
            row["library_dx_dw_ms"] = both_ms
        _say(**row)
        rows[name] = row

    numel = v * d
    p = (torch.randn(v, d, device="cuda") * 0.02).to(torch.bfloat16)
    gg = (torch.randn(v, d, device="cuda") * 1e-3).to(torch.bfloat16)
    m = torch.zeros(v, d, device="cuda")
    vv = torch.zeros(v, d, device="cuda")
    lr = torch.tensor(1e-4, device="cuda")
    b1p = torch.tensor([0.9], device="cuda")
    b2p = torch.tensor([0.999], device="cuda")
    p32 = torch.nn.Parameter(p.float())
    p32.grad = gg.float()
    opt = torch.optim.Adam([p32], lr=1e-4, fused=True)
    bound, by = _bound_ms(numel * 22, 15.0 * numel, "float32")
    row = dict(phase="kernel_time", kernel="fused_adam", shape=[v, d],
               dtype="bfloat16",
               kernel_ms=_median_ms(torch, lambda: fa.fused_adam(
                   p, gg, m, vv, lr, b1p, b2p)),
               plain_ms=_median_ms(torch, lambda: fa.fused_adam_plain(
                   p, gg, m, vv, lr, b1p, b2p)),
               library_ms=_median_ms(torch, opt.step),
               library="torch.optim.Adam(fused=True).step on an fp32 tensor "
                       "of the same shape",
               bound_ms=bound, bound_by=by, repeats=_REPEATS, card=card)
    _say(**row)
    rows["fused_adam"] = row
    return rows


def _train(torch, card):
    """bench.py's gpt2s @ seq 512 through the port's training entry points:
    3 warm-up + 10 timed steps on one fixed batch, every path kernel's
    launches counted from 0 over those 13 steps. Returns the launches."""
    from paddle_tpu_torch.framework import Executor, Scope, program_guard
    from paddle_tpu_torch.models.gpt import GPTConfig, build_train_program
    from paddle_tpu_torch.ops import fused_adam as fa
    from paddle_tpu_torch.ops import lmhead_ce as ce
    from paddle_tpu_torch.optimizer import Adam

    t0 = time.perf_counter()
    cfg = GPTConfig(**_TRAIN)
    main, startup, io = build_train_program(cfg, batch=_TRAIN_B, seq=_TRAIN_T)
    with program_guard(main, startup):
        Adam(learning_rate=1e-4).minimize(io["loss"])
    build_s = time.perf_counter() - t0
    if io["lm_head_impl"] != "pallas":
        raise AssertionError(f"loss path {io['lm_head_impl']!r}, not the "
                             f"fused kernels")
    scope, exe = Scope(), Executor()
    exe.run(startup, scope=scope)
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    r = np.random.RandomState(0)  # the fixed batch of bench.py:60-65
    feed = {k: torch.from_numpy(r.randint(0, cfg.vocab_size, (
        _TRAIN_B, _TRAIN_T)).astype(np.int64)).cuda()
        for k in ("tokens", "labels")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path, counted: every count starts from 0 here
    ce.reset_launches()
    fa.reset_launches()
    losses, step_s = [], []
    for _ in range(_WARM_STEPS + _TIMED_STEPS):
        t_step = time.perf_counter()
        (loss,) = exe.run(main, feed=feed, fetch_list=[io["loss"]],
                          scope=scope)  # the numpy fetch synchronizes
        step_s.append(time.perf_counter() - t_step)
        losses.append(float(loss))
    steps = _WARM_STEPS + _TIMED_STEPS
    launches = {"lmhead_ce_fwd": ce.launches, "lmhead_ce_dx": ce.dx_launches,
                "lmhead_ce_dw": ce.dw_launches, "fused_adam": fa.launches}
    want = {"lmhead_ce_fwd": steps, "lmhead_ce_dx": steps,
            "lmhead_ce_dw": steps, "fused_adam": steps * _ADAM_PER_STEP}
    if launches != want:
        raise AssertionError(f"training launches {launches}, expected "
                             f"{want} over {steps} steps")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training loss not finite and falling: "
                             f"{losses}")
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(step_s[_WARM_STEPS:]) * 1e3
    _say(phase="train", config=_TRAIN, batch=_TRAIN_B, seq=_TRAIN_T,
         params=n_params, build_s=build_s, losses=losses,
         step_ms_median=step_ms,
         step_ms_all=[t * 1e3 for t in step_s[_WARM_STEPS:]],
         tokens_per_s=_TRAIN_N / (step_ms / 1e3),
         max_memory_allocated=peak, launches=launches,
         launches_per_step={k: n // steps for k, n in launches.items()},
         adam_step_bound_ms=_bound_ms(n_params * 22, 15.0 * n_params,
                                      "float32")[0],
         card=card, note="one smoke run, not a benchmark")
    _profile_train_step(torch, exe, main, feed, io, scope, card)
    return launches


def _profile_train_step(torch, exe, main, feed, io, scope, card):
    """One traced training step: host wall, device kernel time, launches
    and the kernels that take the most device time. A traced run: the
    tracer adds host time, so its wall is not the step metric."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=[io["loss"]], scope=scope)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, t = kernels.get(e.name, (0, 0.0))
            kernels[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    device_ms = sum(t for _, t in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    _say(phase="train_profile", wall_ms=wall_ms, device_ms=device_ms,
         device_busy_share=device_ms / wall_ms if kernels else None,
         launches=sum(n for n, _ in kernels.values()),
         top_kernels=[{"name": k[:80], "calls": n, "ms": t}
                      for k, (n, t) in top],
         card=card, note="traced run; not measured if no CUDA events")


def _cpu_vs_card(torch):
    """A tiny fp32 config (2 layers, 2 heads, d 32, vocab 128, seq 16,
    batch 2) trains 2 steps from the same numpy values on the CPU (plain
    versions) and on the card (kernels); loss and every persistable must
    agree at rtol = atol = 1e-4 (TF32 off: exact fp32 products, summed
    in another order)."""
    from paddle_tpu_torch.framework import (CPUPlace, Executor, Scope,
                                            program_guard)
    from paddle_tpu_torch.models.gpt import GPTConfig, build_train_program
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.weights import scope_from_numpy

    cfg = GPTConfig(vocab_size=128, n_layer=2, n_head=2, d_model=32,
                    max_seq_len=16)
    main, startup, io = build_train_program(cfg, batch=2, seq=16)
    with program_guard(main, startup):
        Adam(learning_rate=1e-3).minimize(io["loss"])
    cpu_scope = Scope()
    Executor(CPUPlace()).run(startup, scope=cpu_scope)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    start = {n: cpu_scope.get(n).numpy() for n in names}
    r = np.random.RandomState(1)
    feed = {k: r.randint(0, 128, (2, 16)).astype(np.int64)
            for k in ("tokens", "labels")}
    out = {}
    for dev, place in (("cpu", CPUPlace()), ("cuda", None)):
        scope = scope_from_numpy(start, Scope(), dev)
        exe = Executor(place)
        losses = [float(exe.run(main, feed=feed, fetch_list=[io["loss"]],
                                scope=scope)[0]) for _ in range(2)]
        out[dev] = (losses, {n: scope.get(n).cpu().numpy() for n in names})
    (cl, cv), (gl, gv) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(gl, cl, rtol=1e-4, atol=1e-4)
    worst = 0.0
    for n in names:
        np.testing.assert_allclose(gv[n], cv[n], rtol=1e-4, atol=1e-4,
                                   err_msg=n)
        worst = max(worst, float(np.abs(gv[n] - cv[n]).max()))
    _say(phase="cpu_vs_card", steps=2, losses_cpu=cl, losses_card=gl,
         persistables=len(names), max_abs_diff=worst, tolerance=1e-4)


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


def _kernel_row(name, replaces, source, launches, err, t, card, **extra):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], **extra, "card": card}


def main() -> int:
    import torch

    card = _environment(torch)
    # fp32 products in full fp32 on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build()
    serve_err = _check_kernel(torch)
    errs = _check_training_kernels(torch)
    serve_times = _time_kernel(torch, card)
    times = _time_training_kernels(torch, card)
    serve_launches = _serve(torch, card)
    train_launches = _train(torch, card)
    _cpu_vs_card(torch)

    ce_src = "paddle_tpu_torch/csrc/lmhead_ce.cu"
    pallas = "paddle_tpu/ops/pallas/"
    shape = {"n": _TRAIN_N, "d": _TRAIN["d_model"],
             "v": _TRAIN["vocab_size"], "dtype": "bfloat16"}
    t = serve_times[(511, "float32")]
    fwd = _kernel_row(
        "lmhead_ce_fwd", pallas + "fused_lmhead_ce.py:99", ce_src,
        train_launches["lmhead_ce_fwd"],
        max(serve_err, errs["lmhead_ce_fwd"]), times["lmhead_ce_fwd"], card,
        shape=shape,
        launches_by_path={"train": train_launches["lmhead_ce_fwd"],
                          "serve": serve_launches},
        serve_shape={"n": 511, "d": _SERVE_D, "v": _SERVE_V,
                     "dtype": "float32", "ms": t["kernel_ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "library_ms": t["library_ms"]})
    rows = [fwd] + [
        _kernel_row(name, pallas + where, ce_src, train_launches[name],
                    errs[name], times[name], card, shape=shape,
                    library_dx_dw_ms=times[name]["library_dx_dw_ms"])
        for name, where in (("lmhead_ce_dx", "fused_lmhead_ce.py:188"),
                            ("lmhead_ce_dw", "fused_lmhead_ce.py:221"))]
    rows.append(_kernel_row(
        "fused_adam", pallas + "fused_adam.py:25",
        "paddle_tpu_torch/csrc/fused_adam.cu", train_launches["fused_adam"],
        errs["fused_adam"], times["fused_adam"], card,
        shape={"param": "gpt.wte", "dims": [_TRAIN["vocab_size"],
                                            _TRAIN["d_model"]],
               "dtype": "bfloat16"}))
    _say(kernels=rows)
    print(card, flush=True)
    _say(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
