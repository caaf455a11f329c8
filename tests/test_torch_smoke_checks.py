"""Checks of ``chip_smoke.py`` on the CPU, where the plain versions stand
in for the kernels.

- Fused Adam (``_adam_agrees``): the plain step passes, and each altered
  step fails -- p rounded toward zero instead of to nearest even, the
  weight-decay term dropped, lr off by 1e-4, and m off by 3e-5 (three
  times m's rtol of 1e-5). The inputs are the card check's own
  (``_adam_inputs``), at a small size.
- Flash attention (``_flash_agrees``, at its fp32 and bf16 tolerances):
  the wrappers' outputs pass, and in fp32 so does an independent
  autograd reference (an fp32 softmax attention); each altered output
  fails -- the causal diagonal off by one, the scale dropped (both
  through that reference), lse taken from the row before (with the
  backward fed that lse), dk and dv swapped, and delta dropped. In bf16
  three rounding faults fail too, each of which a bound of 2e-2 on the
  bf16 gradients would let through: P and dS left unrounded (the
  reference, cast to bf16), lse stored in bf16, and delta rounded to
  bf16. The inputs are the card check's own (``_flash_inputs``), at a
  small size.
- lm-head + CE gradients (``_ce_grad_agrees``, at its fp32 and bf16
  tolerances): the wrappers' dx and dW pass, and so does the plain
  function summed over column tiles last to first in fp64; each altered
  gradient fails -- one 64-wide column tile dropped, each row's d-logits
  built from the row before's lse, and (bf16) the sum rounded to bf16
  every 16 terms, as a bf16 accumulator would.
- The fp32 flash forward's float64 check (``_f32_flash_truth_agrees``):
  the split-TF32 kernel's arithmetic, emulated on the CPU, passes, and a
  1xTF32 emulation fails it in out and in lse; the same for the fp32 dq
  and dk/dv at head_dim 256 (``_f32_flash_bwd_truth_agrees``), in dq, dk
  and dv; their fp32 gradient chain passes the plain chain against
  float64 and rejects a dropped key tile in dk; the ``flash_f32_d256``
  CPU-against-card leg is fp32 at head_dim 256.
- The flash backward computed the tensor-core kernels' way
  (``_keymajor_bwd``: key-major score tiles, P and dS rounded per tile)
  passes ``_flash_agrees``; a dropped query tile, P left unrounded for
  dv, a diagonal moved one key right and lse taken from the column
  before each fail it.
- The flash gradient chain (``_chain_agrees``: relative Frobenius error
  against the chain run in fp32, within twice the plain bf16 chain's
  own): the wrappers' chain and one computed the kernels' way pass; dk
  with a key tile dropped and delta taken from the row before fail.
- CPU against card (``_tiny_agree``): the tiny flash GPT leg, run twice
  on the CPU, agrees with itself, and a run whose dq is 2% too large is
  rejected (Adam's parameter step hardly sees a gradient's size; the
  moments do). The bf16 head_dim-256 leg (``_bf16_leg_agrees``): its
  plain run passes, and one whose dk drops the first key tile fails at
  the key weights' moment.
- The head_dim-256 kernels by name: their mangled names map to one
  ``_SM90_KERNELS`` key each, and a device trace charges them to the
  flash forward, dq and dk/dv (``_D256_NAMES`` tells them from the SIMT
  dq, which it wants at no call); the same for the fp32 dq and dk/dv in
  split TF32 (``_F32_D256_NAMES``, the ``train_f32_d256`` phase's, wants
  the SIMT dq and dk/dv at no call; ``_SM90_HGMMA`` their instruction
  counts), and at head_dim 64 and 128 (``_F32_D64_NAMES``, static_amp's
  fp32 step's, wants the split-TF32 dq and dk/dv 12 times each and the
  retired SIMT ones at no call).
- The seq-512 loss band (``_loss_band``, C2), on a tiny bf16 GPT trained
  13 steps on the CPU from one start: K trained with the wrappers (the
  plain versions here) and with a CE forward whose logits are summed in
  fp64 and read last column to first lie inside the band that Y (bf16,
  plain CE) sets around T (fp32); a CE forward that drops one 128-column
  vocabulary tile lies outside. ``_plain_ce`` is undone on exit and fails
  if a CE kernel launch was counted inside it.
- Replay against eager (``_replay_agrees``), on a tiny fp32 GPT trained 5
  steps on the CPU through ``_leg`` from one start, the learning rate
  changed at the last step: the staged compiled route (the card's
  replay with its body called directly) passes against eager, bit for
  bit; three broken replays fail -- the capture step never applied (the
  state restored after it), the learning rate frozen at the captured
  step's, and beta1's power one step ahead; a difference in a loss or a
  persistable passes only where a second eager run shares it.
- The vision and fluid static path's checks: the static AMP rewrite
  (``_amp_rewrite_agrees``) passes on a tiny GPT built fp32 and decorated
  (casts, no ``equal``, every matmul and attention reading bf16, the CE
  fp32) and fails on the undecorated program (no casts) and on one whose
  first matmul is rewired back to its fp32 input; the overflow step
  (``_amp_overflow``, the found-inf arithmetic) on that GPT on the CPU's
  staged route: an inf in a weight leaves every parameter and
  accumulator as it was and halves the scale, and a decorated program
  whose optimizer writes are not gated fails it; ``_stats_moved`` (the
  running-statistics check of ``vision_fit``) passes when every
  BatchNorm statistic moved in a training forward of a small ResNet on
  CPU tensors and fails when one did not (an eval forward)."""
import torch_threads  # noqa: F401 (one torch thread a worker)
import contextlib
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
from torch_modes import static_mode  # noqa: F401 (autouse fixture)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from paddle_tpu_torch.ops import fused_adam as fa  # noqa: E402

_SHAPES = [((64, 96), torch.bfloat16), ((48, 40), torch.float32),
           ((96,), torch.float32), ((7, 100), torch.float32)]


def _step(shape, dtype, wd, alter=None):
    p, g, m, v, lr, b1p, b2p = chip_smoke._adam_inputs(
        torch, shape, dtype, seed=3, device="cpu")
    ref = fa.fused_adam_plain(p, g, m, v, lr, b1p, b2p, weight_decay=wd)
    if alter == "truncate":
        pre = fa.fused_adam_plain(p.float(), g, m, v, lr, b1p, b2p,
                                  weight_decay=wd)[0]
        got = ((pre.view(torch.int32) & ~0xFFFF).view(torch.float32)
               .to(dtype), ref[1], ref[2])
    elif alter == "no_wd":
        got = fa.fused_adam_plain(p, g, m, v, lr, b1p, b2p)
    elif alter == "lr":
        got = fa.fused_adam_plain(p, g, m, v, lr * (1 - 1e-4), b1p, b2p,
                                  weight_decay=wd)
    elif alter == "m":
        got = (ref[0], ref[1] * (1 + 3e-5), ref[2])
    else:
        got = fa.fused_adam(p.clone(), g, m.clone(), v.clone(), lr, b1p, b2p,
                            weight_decay=wd)
    pre_p = fa.fused_adam_plain(p.float(), g, got[1], got[2], lr, b1p, b2p,
                                beta1=1.0, beta2=1.0, weight_decay=wd)[0]
    return chip_smoke._adam_agrees(torch, p, got, pre_p, ref)


@pytest.mark.parametrize("wd", [0.0, 0.5])
@pytest.mark.parametrize("shape,dtype", _SHAPES)
def test_plain_step_passes(shape, dtype, wd):
    report = _step(shape, dtype, wd)
    assert report["p_beyond"] == report["mv_beyond"] == 0
    assert report["median_step_ulps"] >= 2.0


@pytest.mark.parametrize("alter,shape,dtype,wd", [
    ("truncate", (64, 96), torch.bfloat16, 0.0),
    ("no_wd", (64, 96), torch.bfloat16, 0.5),
    ("no_wd", (48, 40), torch.float32, 0.5),
    ("lr", (64, 96), torch.bfloat16, 0.0),
    ("lr", (48, 40), torch.float32, 0.0),
    ("m", (48, 40), torch.float32, 0.0),
])
def test_altered_step_fails(alter, shape, dtype, wd):
    with pytest.raises(AssertionError, match="fused_adam disagrees"):
        _step(shape, dtype, wd, alter)


def _flash_reference(q, k, v, do, layout, shift=0, scale=0.125):
    """out, lse, dq, dk, dv of an fp32 causal softmax attention by
    autograd, its diagonal moved ``shift`` keys right, cast to q's
    dtype (lse stays fp32)."""
    def heads(t):
        t = t.float()
        return (t.transpose(1, 2) if layout == "BTHD" else t).detach()

    qh, kh, vh = (heads(t).requires_grad_(True) for t in (q, k, v))
    s = qh @ kh.transpose(-1, -2) * scale
    tq, tk = s.shape[-2:]
    keep = torch.ones((tq, tk), dtype=torch.bool).tril(tk - tq + shift)
    s = s.masked_fill(~keep, float("-inf"))
    out = torch.softmax(s, -1) @ vh
    grads = torch.autograd.grad(out, (qh, kh, vh), heads(do))

    def back(t):
        t = t.transpose(1, 2) if layout == "BTHD" else t
        return t.detach().to(q.dtype).contiguous()

    return dict(out=back(out), lse=torch.logsumexp(s, -1).detach(),
                dq=back(grads[0]), dk=back(grads[1]), dv=back(grads[2]))


def _flash(dtype_name, alter=None, layout="BTHD"):
    from paddle_tpu_torch.ops import flash_attention as fl

    q, k, v, do = chip_smoke._flash_inputs(
        torch, 1, 2, 128, 128, 64, getattr(torch, dtype_name), layout,
        seed=5, device="cpu")
    got, ref = chip_smoke._flash_outputs(torch, q, k, v, do, True, layout)
    lse = ref["lse"]
    delta = fl.flash_attention_delta(ref["out"], do, layout)
    if alter in ("reference", "unrounded"):
        got = _flash_reference(q, k, v, do, layout)
    elif alter == "mask":
        got = _flash_reference(q, k, v, do, layout, shift=1)
    elif alter == "scale":
        got = _flash_reference(q, k, v, do, layout, scale=1.0)
    elif alter == "swap":
        got = dict(got, dk=got["dv"], dv=got["dk"])
    elif alter == "lse_row":
        lse = lse.roll(1, dims=-1)
        got = dict(got, lse=lse)
    elif alter == "lse_bf16":
        lse = lse.bfloat16().float()
    elif alter == "no_delta":
        delta = torch.zeros_like(delta)
    elif alter == "delta_bf16":
        delta = delta.bfloat16().float()
    if alter in ("lse_row", "lse_bf16", "no_delta", "delta_bf16"):
        args = (q, k, v, do, lse, delta, True, None, layout)
        dk, dv = fl.flash_attention_dkv_plain(*args)
        got = dict(got, dq=fl.flash_attention_dq_plain(*args), dk=dk, dv=dv)
    return chip_smoke._flash_agrees(torch, got, ref, dtype_name,
                                    f"{dtype_name} {alter}")


@pytest.mark.parametrize("dtype_name,alter", [
    ("float32", None), ("float32", "reference"), ("bfloat16", None)])
def test_flash_outputs_pass(dtype_name, alter):
    errs = _flash(dtype_name, alter)
    assert set(errs) == {"flash_attention_fwd", "flash_attention_dq",
                         "flash_attention_dkv"}


_BF16_ROUNDING_FAULTS = ["unrounded", "lse_bf16", "delta_bf16"]


@pytest.mark.parametrize("dtype_name,alter", [
    (dt, alter) for dt in ("float32", "bfloat16")
    for alter in ("mask", "scale", "lse_row", "swap", "no_delta")
] + [("bfloat16", alter) for alter in _BF16_ROUNDING_FAULTS])
def test_altered_flash_outputs_fail(dtype_name, alter):
    with pytest.raises(AssertionError, match="flash attention disagrees"):
        _flash(dtype_name, alter)


@pytest.mark.parametrize("alter", _BF16_ROUNDING_FAULTS)
def test_bf16_rounding_faults_pass_a_2e_2_bound(monkeypatch, alter):
    loose = dict(chip_smoke._FLASH_TOL["bfloat16"], dq=(2e-2, 2e-2),
                 dk=(2e-2, 2e-2), dv=(2e-2, 2e-2))
    monkeypatch.setitem(chip_smoke._FLASH_TOL, "bfloat16", loose)
    _flash("bfloat16", alter)


def test_tiny_check_rejects_a_gradient_of_the_wrong_size(monkeypatch):
    from paddle_tpu_torch.ops import flash_attention as fl

    _, config, seq, min_seq, lr, eps = chip_smoke._CPU_VS_CARD[1]
    program = chip_smoke._tiny_program(config, seq, lr, eps)
    base = chip_smoke._tiny_steps(program, "cpu", min_seq)
    assert base[2] > 0
    chip_smoke._tiny_agree(chip_smoke._tiny_steps(program, "cpu", min_seq),
                           base, "again")
    plain = fl.flash_attention_dq_plain
    monkeypatch.setattr(fl, "flash_attention_dq_plain",
                        lambda *args: plain(*args) * 1.02)
    scaled = chip_smoke._tiny_steps(program, "cpu", min_seq)
    with pytest.raises(AssertionError, match="dq x 1.02"):
        chip_smoke._tiny_agree(scaled, base, "dq x 1.02")


def _ce_grads(dtype_name, alter=None):
    """(got, ref) dx and dW on the CPU: ref the plain versions, got the
    same function altered by ``alter`` (None: the wrappers' own output)."""
    from paddle_tpu_torch.ops import lmhead_ce as ce

    n, d, v = 512, 64, 512
    x, w, lbl = chip_smoke._inputs(torch, n, d, v, getattr(torch, dtype_name),
                                   seed=7, device="cpu")
    g = torch.linspace(0.5, 1.5, n)
    lse = ce.lmhead_ce_plain(x, w, lbl)[1]
    ref = {"lmhead_ce_dx": ce.lmhead_ce_dx_plain(x, w, lbl, lse, g),
           "lmhead_ce_dw": ce.lmhead_ce_dw_plain(x, w, lbl, lse, g)}
    if alter is None:
        return {"lmhead_ce_dx": ce.lmhead_ce_dx(x, w, lbl, lse, g),
                "lmhead_ce_dw": ce.lmhead_ce_dw(x, w, lbl, lse, g)}, ref
    dl = ce._dlogits_plain(x, w, lbl, lse.roll(1) if alter == "lse_row"
                           else lse, g)
    xf, wf = x.float(), w.float()
    if alter == "lse_row":  # each row's d-logits from the row before's lse
        return {"lmhead_ce_dx": (dl @ wf).to(x.dtype),
                "lmhead_ce_dw": (dl.t() @ xf).to(w.dtype)}, ref
    if alter == "drop_tile":  # the second 64-wide column tile of each side
        dx = dl.clone()
        dx[:, 64:128] = 0
        dw = dl.clone()
        dw[64:128, :] = 0
        return {"lmhead_ce_dx": (dx @ wf).to(x.dtype),
                "lmhead_ce_dw": (dw.t() @ xf).to(w.dtype)}, ref
    if alter == "bf16_sum":  # the accumulator rounded to bf16 every 16 terms
        def summed(a, b):
            acc = torch.zeros(a.shape[0], b.shape[1])
            for k in range(0, a.shape[1], 16):
                acc = (acc + a[:, k:k + 16] @ b[k:k + 16]).bfloat16().float()
            return acc.to(x.dtype)
        return {"lmhead_ce_dx": summed(dl, wf),
                "lmhead_ce_dw": summed(dl.t().contiguous(), xf)}, ref
    if alter == "reordered":  # column tiles summed last to first, in fp64
        def summed(a, b):
            acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float64)
            for k in reversed(range(0, a.shape[1], 64)):
                acc += a[:, k:k + 64].double() @ b[k:k + 64].double()
            return acc.to(x.dtype)
        return {"lmhead_ce_dx": summed(dl, wf),
                "lmhead_ce_dw": summed(dl.t().contiguous(), xf)}, ref
    raise ValueError(alter)


@pytest.mark.parametrize("dtype_name,alter", [
    ("bfloat16", None), ("bfloat16", "reordered"), ("float32", None),
    ("float32", "reordered")])
def test_ce_grads_pass(dtype_name, alter):
    got, ref = _ce_grads(dtype_name, alter)
    for name in ref:
        chip_smoke._ce_grad_agrees(torch, got[name], ref[name], name, alter)


@pytest.mark.parametrize("dtype_name,alter", [
    (dt, alter) for dt in ("bfloat16", "float32")
    for alter in ("drop_tile", "lse_row")] + [("bfloat16", "bf16_sum")])
@pytest.mark.parametrize("name", ["lmhead_ce_dx", "lmhead_ce_dw"])
def test_altered_ce_grads_fail(dtype_name, alter, name):
    got, ref = _ce_grads(dtype_name, alter)
    with pytest.raises(AssertionError, match=f"{name} disagrees"):
        chip_smoke._ce_grad_agrees(torch, got[name], ref[name], name, alter)


def _ce_fwd(dtype_name, alter=None):
    """(got, ref, lbl, v) of the CE forward on the CPU: ref the plain
    version, got the function altered by ``alter`` (None: the wrapper's
    own output). N = 64, D = 64 and V = 300, a V that leaves 84 columns
    of the kernel's last 128-column tile past V."""
    from paddle_tpu_torch.ops import lmhead_ce as ce

    n, d, v = 64, 64, 300
    x, w, lbl = chip_smoke._inputs(torch, n, d, v, getattr(torch, dtype_name),
                                   seed=9, device="cpu")
    lbl[3], lbl[7] = v, -1
    ref = ce.lmhead_ce_plain(x, w, lbl)
    if alter is None:
        return ce.lmhead_ce_fwd(x, w, lbl), ref, lbl, v
    logits = x.double() @ w.double().t()
    picked = torch.where((lbl >= 0) & (lbl < v), logits.gather(
        1, lbl.clamp(0, v - 1)[:, None])[:, 0], torch.zeros(n).double())
    if alter == "reordered":  # columns summed last to first, in fp64
        logits = logits.flip(1)
    elif alter == "drop_tile":  # the second 128-column tile left out
        logits = torch.cat([logits[:, :128], logits[:, 256:]], 1)
    elif alter == "wrong_column":  # the logit one column right picked
        right = (lbl + 1).clamp(0, v - 1)
        picked = torch.where((lbl >= 0) & (lbl < v), logits.gather(
            1, right[:, None])[:, 0], picked)
    elif alter == "past_v":  # the last tile's 84 zero-filled columns kept
        logits = torch.cat([logits, torch.zeros(n, 84).double()], 1)
    lse = torch.logsumexp(logits, 1)
    return ((lse - picked).float(), lse.float()), ref, lbl, v


@pytest.mark.parametrize("dtype_name,tol", [("float32", 1e-4),
                                            ("bfloat16", 2e-3)])
@pytest.mark.parametrize("alter", [None, "reordered"])
def test_ce_forward_passes(dtype_name, tol, alter):
    got, ref, lbl, v = _ce_fwd(dtype_name, alter)
    chip_smoke._ce_fwd_agrees(torch, got, ref, lbl, v, tol, alter)


@pytest.mark.parametrize("dtype_name,tol", [("float32", 1e-4),
                                            ("bfloat16", 2e-3)])
@pytest.mark.parametrize("alter", ["drop_tile", "wrong_column", "past_v"])
def test_altered_ce_forward_fails(dtype_name, tol, alter):
    got, ref, lbl, v = _ce_fwd(dtype_name, alter)
    with pytest.raises(AssertionError, match="lmhead_ce_fwd disagrees"):
        chip_smoke._ce_fwd_agrees(torch, got, ref, lbl, v, tol, alter)


def _online_fwd(q, k, v, layout, rescale=True, drop=None, shift=0):
    """out and lse of a causal attention computed as the tensor-core
    kernel computes them: key tiles of 64 in order, an online softmax in
    fp32 with P rounded to q's dtype against the running max. ``rescale``
    False leaves out the alpha rescale of the output and the row sum;
    ``drop`` leaves out one key tile; ``shift`` moves the diagonal that
    many keys right."""
    def heads(t):
        return (t.transpose(1, 2) if layout == "BTHD" else t).float()

    qh, kh, vh = heads(q), heads(k), heads(v)
    tq, tk, d = qh.shape[2], kh.shape[2], qh.shape[3]
    keep = torch.ones((tq, tk), dtype=torch.bool).tril(tk - tq + shift)
    m = torch.full(qh.shape[:3], -1e30)
    l = torch.zeros(qh.shape[:3])
    o = torch.zeros(qh.shape)
    for c0 in range(0, tk, 64):
        if c0 == drop:
            continue
        s = (qh @ kh[:, :, c0:c0 + 64].transpose(-1, -2)) / d ** 0.5
        s = s.masked_fill(~keep[:, c0:c0 + 64], float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new) if rescale else torch.ones_like(m)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + p.to(q.dtype).float() @ vh[:, :, c0:c0 + 64]
        m = m_new
    out = o / torch.where(l > 0, l, torch.ones_like(l))[..., None]
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, -1e30))
    out = out.transpose(1, 2) if layout == "BTHD" else out
    return out.to(q.dtype).contiguous(), lse


def _flash_fwd(dtype_name, layout, **alter):
    """chip_smoke's flash check on a forward computed the kernel's way
    (altered by ``alter``) and the wrappers' backward."""
    q, k, v, do = chip_smoke._flash_inputs(
        torch, 1, 2, 256, 256, 64, getattr(torch, dtype_name), layout,
        seed=5, device="cpu")
    got, ref = chip_smoke._flash_outputs(torch, q, k, v, do, True, layout)
    out, lse = _online_fwd(q, k, v, layout, **alter)
    got = dict(got, out=out, lse=lse)
    return chip_smoke._flash_agrees(torch, got, ref, dtype_name,
                                    f"{dtype_name} {alter}")


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["BTHD", "BHTD"])
def test_online_forward_passes(dtype_name, layout):
    _flash_fwd(dtype_name, layout)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("alter", [dict(drop=64), dict(rescale=False),
                                   dict(shift=1)],
                         ids=["dropped_key_tile", "no_alpha", "diagonal"])
def test_altered_online_forward_fails(dtype_name, alter):
    with pytest.raises(AssertionError, match="flash attention disagrees"):
        _flash_fwd(dtype_name, "BTHD", **alter)


def test_f32_flash_truth_check_accepts_the_split_and_refuses_tf32():
    """``chip_smoke._f32_flash_truth_agrees`` (the card's float64 check of
    the fp32 flash forward) passes the kernel's arithmetic, emulated on
    the CPU by ``tests/test_torch_flash_attention_f32.py``, and raises,
    naming out and lse, on a 1xTF32 emulation (hi . hi alone), at the
    check's first case and seed."""
    import test_torch_flash_attention_f32 as f32

    from paddle_tpu_torch.ops import flash_attention as fl

    layout, causal, b, h, tq, tk, d = chip_smoke._F32_FLASH_TRUTH_CASES[0]
    q, k, v, _ = chip_smoke._flash_inputs(
        torch, b, h, tq, tk, d, torch.float32, layout,
        chip_smoke._F32_FLASH_SEEDS[0], device="cpu")
    plain = fl.flash_attention_fwd_plain(q, k, v, causal, None, layout)
    report = chip_smoke._f32_flash_truth_agrees(
        torch, f32.emulate(q, k, v, causal, layout), plain, q, k, v, causal,
        layout, "3xTF32 emulation")
    assert set(report) == {"out", "lse"}
    assert all(r["err"] <= r["bound"] for r in report.values())
    with pytest.raises(AssertionError, match="out.*lse"):
        chip_smoke._f32_flash_truth_agrees(
            torch, f32.emulate(q, k, v, causal, layout, f32._only_hi), plain,
            q, k, v, causal, layout, "1xTF32 emulation")


def test_f32_flash_bwd_truth_check_accepts_the_split_and_refuses_tf32():
    """``chip_smoke._f32_flash_bwd_truth_agrees`` (the card's float64 check
    of the fp32 dq and dk/dv at head_dim 256) passes the kernels'
    arithmetic, emulated on the CPU by
    ``tests/test_torch_flash_attention_f32_bwd.py``, and raises, naming
    dq, dk and dv, on a 1xTF32 emulation (hi . hi alone), at the check's
    first head_dim-256 case and seed."""
    import test_torch_flash_attention_f32_bwd as bwd

    layout, causal, b, h, tq, tk, d = next(
        c for c in chip_smoke._F32_FLASH_TRUTH_CASES if c[-1] == 256)
    q, k, v, do = chip_smoke._flash_inputs(
        torch, b, h, tq, tk, d, torch.float32, layout,
        chip_smoke._F32_FLASH_SEEDS[0], device="cpu")
    _, plain = chip_smoke._f32_bwd_pair(torch, q, k, v, do, causal, layout)
    truth = chip_smoke._flash_bwd_fp64(torch, q, k, v, do, causal, layout)
    args = bwd._args(q, k, v, do, causal, layout)[:-2]

    def emulated(pair):
        return dict(zip(("dq", "dk", "dv"),
                        bwd.emulate_bwd(*args, layout, pair)))

    report = chip_smoke._f32_flash_bwd_truth_agrees(
        torch, emulated(bwd._pair), plain, truth, "3xTF32 emulation")
    assert set(report) == {"dq", "dk", "dv"}
    assert all(r["err"] <= r["bound"] for r in report.values())
    with pytest.raises(AssertionError, match="dq.*dk.*dv"):
        chip_smoke._f32_flash_bwd_truth_agrees(
            torch, emulated(bwd._only_hi), plain, truth, "1xTF32 emulation")


def test_f32_chain_bound_passes_the_plain_chain_and_rejects_a_fault():
    """The fp32 gradient chain at head_dim 256 (``_F32_CHAIN_CASES``, here
    in one batch and head at T 256) held to float64 by ``_chain_agrees``:
    the wrappers' chain (the plain versions here) passes; dk with its first
    key tile's rows dropped fails."""
    b, h, t, d, layout = chip_smoke._F32_CHAIN_CASES[0]
    assert (t, d) == (chip_smoke._LONG_T, 256)
    q, k, v, do = chip_smoke._flash_inputs(torch, 1, 1, 256, 256, d,
                                           torch.float32, layout, 98,
                                           device="cpu")
    got = chip_smoke._kernel_chain(q, k, v, do, True, layout)
    plain = chip_smoke._plain_chain(q, k, v, do, True, layout)
    truth = chip_smoke._flash_bwd_fp64(torch, q, k, v, do, True, layout)
    chip_smoke._chain_agrees(torch, got, plain, truth, "fp32 chain")
    got["dk"] = got["dk"].clone()
    got["dk"][:, :64] = 0
    with pytest.raises(AssertionError, match="dk"):
        chip_smoke._chain_agrees(torch, got, plain, truth, "dropped tile")


def test_f32_d256_leg_is_fp32_at_head_dim_256():
    """The flash_f32_d256 CPU-against-card leg trains one fp32 head of 256
    at seq 128 with flash on both sides (PADDLE_TPU_FLASH_MIN_SEQ 128), so
    the card runs the split-TF32 forward, dq and dk/dv; it takes the fp32
    route, held at _TINY_TOL."""
    leg = next(c for c in chip_smoke._CPU_VS_CARD if c[0] == "flash_f32_d256")
    _, config, seq, min_seq, _, _ = leg
    assert config.get("dtype", "float32") == "float32"
    assert config["d_model"] // config["n_head"] == 256
    assert seq == min_seq == 128


def test_rows_that_see_no_key_must_give_zero_and_the_stand_in():
    """Causal with Tq > Tk: the plain version's rows that see no key pass
    the exact check; an lse off -1e30 by 1e-5 of itself and an out of
    0.01 in one such row, which the tolerances let through, fail it."""
    from paddle_tpu_torch.ops import flash_attention as fl

    q, k, v, _ = chip_smoke._flash_inputs(torch, 1, 2, 384, 128, 64,
                                          torch.bfloat16, "BHTD", seed=4,
                                          device="cpu")
    out, lse = fl.flash_attention_fwd(q, k, v, True, None, "BHTD")
    chip_smoke._no_key_rows_agree(dict(out=out, lse=lse), True, "BHTD", 384,
                                  128, "plain")
    bad_lse = lse.clone()
    bad_lse[..., :256] *= 1 - 1e-5
    bad_out = out.clone()
    bad_out[:, :, 5] = 0.01
    tol = chip_smoke._FLASH_TOL["bfloat16"]
    assert chip_smoke._beyond(bad_lse, lse, *tol["lse"]) == 0
    assert chip_smoke._beyond(bad_out, out, *tol["out"]) == 0
    for got in (dict(out=out, lse=bad_lse), dict(out=bad_out, lse=lse)):
        with pytest.raises(AssertionError, match="sees no key"):
            chip_smoke._no_key_rows_agree(got, True, "BHTD", 384, 128, "x")


def _keymajor_bwd(q, k, v, do, lse, delta, layout, drop=None,
                  unrounded=False, shift=0, lse_col=False):
    """dq, dk and dv of a causal attention computed as the tensor-core
    backward kernels compute them: key tiles of 64 (the rows of the dk/dv
    kernel's score tiles S^T = K Q^T) against query tiles of 64, P =
    exp(s^T * scale - lse) masked before the exponential, P and dS rounded
    to q's dtype per tile, fp32 sums, dq and dk scaled once at the end.
    ``drop`` leaves one query tile out of dk and dv; ``unrounded`` keeps
    P in fp32 for dv; ``shift`` moves the diagonal that many keys right;
    ``lse_col`` gives each query column the lse of the column before."""
    def heads(t):
        return (t.transpose(1, 2) if layout == "BTHD" else t).float()

    def rnd(t):
        return t.to(q.dtype).float()

    qh, kh, vh, doh = (heads(t) for t in (q, k, v, do))
    tq, tk, d = qh.shape[2], kh.shape[2], qh.shape[3]
    scale = d ** -0.5
    if lse_col:
        lse = lse.roll(1, dims=-1)
    keep_t = torch.ones((tq, tk), dtype=torch.bool).tril(tk - tq + shift).t()
    dq, dk, dv = (torch.zeros(t.shape) for t in (qh, kh, vh))
    for c0 in range(0, tk, 64):
        kt, vt = kh[:, :, c0:c0 + 64], vh[:, :, c0:c0 + 64]
        for r0 in range(0, tq, 64):
            qt, dot = qh[:, :, r0:r0 + 64], doh[:, :, r0:r0 + 64]
            st = (kt @ qt.transpose(-1, -2)) * scale \
                - lse[..., None, r0:r0 + 64]
            p = torch.exp(st.masked_fill(~keep_t[c0:c0 + 64, r0:r0 + 64],
                                         float("-inf")))
            dpt = vt @ dot.transpose(-1, -2)
            dst = rnd(p * (dpt - delta[..., None, r0:r0 + 64]))
            dq[:, :, r0:r0 + 64] += dst.transpose(-1, -2) @ kt
            if r0 == drop:
                continue
            dv[:, :, c0:c0 + 64] += (p if unrounded else rnd(p)) @ dot
            dk[:, :, c0:c0 + 64] += dst @ qt

    def back(t):
        t = t.transpose(1, 2) if layout == "BTHD" else t
        return t.to(q.dtype).contiguous()

    return dict(dq=back(dq * scale), dk=back(dk * scale), dv=back(dv))


def _flash_bwd(dtype_name, layout, **alter):
    """chip_smoke's flash check on a backward computed the kernels' way
    (altered by ``alter``) from the plain forward's out and lse."""
    from paddle_tpu_torch.ops import flash_attention as fl

    q, k, v, do = chip_smoke._flash_inputs(
        torch, 1, 2, 256, 256, 64, getattr(torch, dtype_name), layout,
        seed=5, device="cpu")
    got, ref = chip_smoke._flash_outputs(torch, q, k, v, do, True, layout)
    delta = fl.flash_attention_delta(ref["out"], do, layout)
    got = dict(got, **_keymajor_bwd(q, k, v, do, ref["lse"], delta, layout,
                                    **alter))
    return chip_smoke._flash_agrees(torch, got, ref, dtype_name,
                                    f"{dtype_name} {alter}")


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["BTHD", "BHTD"])
def test_keymajor_backward_passes(dtype_name, layout):
    _flash_bwd(dtype_name, layout)


@pytest.mark.parametrize("layout", ["BTHD", "BHTD"])
@pytest.mark.parametrize("alter", [dict(drop=128), dict(unrounded=True),
                                   dict(shift=1), dict(lse_col=True)],
                         ids=["dropped_query_tile", "unrounded_p",
                              "diagonal", "lse_column"])
def test_altered_keymajor_backward_fails(layout, alter):
    with pytest.raises(AssertionError, match="flash attention disagrees"):
        _flash_bwd("bfloat16", layout, **alter)


def _chain(layout, alter=None):
    """chip_smoke's chain check on the CPU (B 1, H 2, T 256, D 64, bf16,
    causal): the plain bf16 chain and the truth (the plain chain in fp32),
    and as ``got`` the wrappers' chain, the kernels' way (the online
    forward, then the key-major backward), or a faulty chain: dk with its
    second key tile dropped, or delta taken from the row before."""
    from paddle_tpu_torch.ops import flash_attention as fl

    q, k, v, do = chip_smoke._flash_inputs(torch, 1, 2, 256, 256, 64,
                                           torch.bfloat16, layout, seed=6,
                                           device="cpu")
    plain = chip_smoke._plain_chain(q, k, v, do, True, layout)
    truth = chip_smoke._plain_chain(*(t.float() for t in (q, k, v, do)),
                                    True, layout)
    if alter == "kernel_way":
        out, lse = _online_fwd(q, k, v, layout)
        got = _keymajor_bwd(q, k, v, do, lse,
                            fl.flash_attention_delta(out, do, layout), layout)
    elif alter == "delta_row":
        out, lse = fl.flash_attention_fwd(q, k, v, True, None, layout)
        delta = fl.flash_attention_delta(out, do, layout).roll(1, dims=-1)
        args = (q, k, v, do, lse, delta, True, None, layout)
        dk, dv = fl.flash_attention_dkv(*args)
        got = dict(dq=fl.flash_attention_dq(*args), dk=dk, dv=dv)
    else:
        got = chip_smoke._kernel_chain(q, k, v, do, True, layout)
    if alter == "dropped_key_tile":
        dk = got["dk"].clone()
        (dk[:, 64:128] if layout == "BTHD" else dk[:, :, 64:128]).zero_()
        got = dict(got, dk=dk)
    return chip_smoke._chain_agrees(torch, got, plain, truth,
                                    f"{layout} {alter}")


@pytest.mark.parametrize("layout", ["BTHD", "BHTD"])
@pytest.mark.parametrize("alter", [None, "kernel_way"])
def test_chain_bound_passes(layout, alter):
    report = _chain(layout, alter)
    for name in ("dq", "dk", "dv"):
        assert 0 < report[name]["plain_rel_err"] < 1e-2
        assert report[name]["rel_err"] <= report[name]["bound"]


@pytest.mark.parametrize("layout", ["BTHD", "BHTD"])
@pytest.mark.parametrize("alter", ["dropped_key_tile", "delta_row"])
def test_chain_bound_rejects_faults(layout, alter):
    with pytest.raises(AssertionError, match="chain beyond its bound"):
        _chain(layout, alter)


# the loss band's tiny config: 4 vocabulary tiles of 128, bf16
_BAND = dict(vocab_size=512, n_layer=2, n_head=2, d_model=64, max_seq_len=32,
             dtype="bfloat16")
_BAND_B, _BAND_T = 4, 32


@pytest.fixture(scope="module")
def band():
    """(program, start, feed, runs): the bf16 program, its initial
    persistables, the fixed batch and ``_band_runs``' T and Y, on the
    CPU."""
    from paddle_tpu_torch.framework import Scope

    program = chip_smoke._train_program(_BAND, _BAND_B, _BAND_T)
    scope = Scope()
    chip_smoke._executor("cpu").run(program[1], scope=scope)
    start = {v.name: scope.get(v.name).detach().clone()
             for v in program[0].list_vars() if v.persistable}
    feed = chip_smoke._fixed_batch(torch, _BAND["vocab_size"], _BAND_B,
                                   _BAND_T, "cpu")
    runs = chip_smoke._band_runs(torch, _BAND, _BAND_B, _BAND_T, start, feed,
                                 "cpu")
    return program, start, feed, runs


def _band_k(band, monkeypatch, alter=None):
    """K's losses on the CPU, the CE forward altered by ``alter``."""
    from paddle_tpu_torch.ops import lmhead_ce as ce

    program, start, feed, _ = band
    plain = ce.lmhead_ce_plain

    def forward(x, w, labels):
        logits = x.double() @ w.double().t()
        keep = torch.ones(w.shape[0], dtype=torch.bool)
        if alter == "drop_tile":  # the second 128-column tile left out
            keep[128:256] = False
        else:  # "reordered": fp64 sums, columns last to first
            logits, keep = logits.flip(1), keep.flip(0)
            labels = w.shape[0] - 1 - labels.long()
        lse = torch.logsumexp(logits[:, keep], 1)
        lbl = labels.long().clamp(0, w.shape[0] - 1)
        picked = torch.where(keep[lbl], logits.gather(1, lbl[:, None])[:, 0],
                             torch.zeros_like(lse))
        return (lse - picked).float(), lse.float()

    if alter:
        monkeypatch.setattr(ce, "lmhead_ce_plain", forward)
    losses = chip_smoke._losses(program, start, feed, "cpu",
                                len(band[3]["T"]))
    monkeypatch.setattr(ce, "lmhead_ce_plain", plain)
    return losses


@pytest.mark.parametrize("alter", [None, "reordered"])
def test_loss_band_passes(band, monkeypatch, alter):
    report = chip_smoke._loss_band(_band_k(band, monkeypatch, alter),
                                   band[3]["T"], band[3]["Y"])
    assert report["worst_ratio"] <= 1.0 and len(report["bound"]) == 13


def test_loss_band_rejects_a_dropped_vocab_tile(band, monkeypatch):
    k = _band_k(band, monkeypatch, "drop_tile")
    with pytest.raises(AssertionError, match="outside the band"):
        chip_smoke._loss_band(k, band[3]["T"], band[3]["Y"])


def test_loss_band_rejects_unequal_or_nonfinite_runs(band):
    t, y = band[3]["T"], band[3]["Y"]
    with pytest.raises(AssertionError, match="not finite"):
        chip_smoke._loss_band(y[:-1], t, y)
    with pytest.raises(AssertionError, match="not finite"):
        chip_smoke._loss_band(y[:-1] + [float("nan")], t, y)


def test_plain_ce_swap_is_undone_and_counts_nothing():
    from paddle_tpu_torch.ops import lmhead_ce as ce

    kernels = ce._launch, ce._launch_dx, ce._launch_dw
    x, w, lbl = chip_smoke._inputs(torch, 8, 16, 40, torch.float32, seed=1,
                                   device="cpu")
    with chip_smoke._plain_ce():
        got = ce._launch(x, w, lbl)
    assert (ce._launch, ce._launch_dx, ce._launch_dw) == kernels
    torch.testing.assert_close(got, ce.lmhead_ce_plain(x, w, lbl))
    with pytest.raises(AssertionError, match="launched during the plain"):
        with chip_smoke._plain_ce():
            ce.dx_launches += 1
    assert (ce._launch, ce._launch_dx, ce._launch_dw) == kernels
    ce.reset_launches()


# -- replay against eager (_replay_agrees) --------------------------------

_REPLAY = dict(vocab_size=128, n_layer=2, n_head=2, d_model=32,
               max_seq_len=16, dtype="float32")
_REPLAY_LRS = [1e-3, 1e-3, 1e-3, 1e-3, 5e-4]


@pytest.fixture(scope="module")
def replay_start():
    """(program, start, feed, b1p0): a tiny fp32 GPT train program (the
    smoke's ``_train_program``), its initial persistables, a fixed batch
    and the initial beta1 power, on the CPU."""
    from paddle_tpu_torch.framework import Scope

    program = chip_smoke._train_program(_REPLAY, 2, 16)
    scope = Scope()
    chip_smoke._executor("cpu").run(program[1], scope=scope)
    start = {v.name: scope.get(v.name).detach().clone()
             for v in program[0].list_vars() if v.persistable}
    feed = chip_smoke._fixed_batch(torch, 128, 2, 16, "cpu")
    b1p0 = float(start[next(n for n in start
                            if n.startswith("gpt.wte_beta1_pow"))])
    return program, start, feed, b1p0


def _replay_leg(replay_start, staged, start=None):
    program, start0, feed, _ = replay_start
    return chip_smoke._leg(program, start or start0, feed, "cpu",
                           _REPLAY_LRS, staged=staged)


def test_replay_check_passes_equal_trajectories(replay_start):
    """The staged compiled route (the card's replay, its body called
    directly) against eager: bit for bit, the schedule read back, beta1's
    power once a step."""
    e = _replay_leg(replay_start, staged=False)
    r = _replay_leg(replay_start, staged=True)
    assert r["phases"] == {"eager": 1, "capture": 1, "replay": 3}
    report = chip_smoke._replay_agrees(r, e, _REPLAY_LRS, replay_start[3])
    assert report["bit_identical"] and report["persistables"] > 0
    assert chip_smoke._lr_schedule(3) == [chip_smoke._LR] * 2 + [
        chip_smoke._LAST_LR]


@pytest.mark.parametrize("broken,match", [
    ("skips_the_capture_step", "beta1 power"),
    ("freezes_the_learning_rate", "learning rates"),
    ("beta_pow_off_by_one", "beta1 power")])
def test_replay_check_rejects_a_broken_replay(replay_start, monkeypatch,
                                              broken, match):
    """Three replays gone wrong: the step on which the graph is captured
    never applied (the capture recorded it, nothing replayed it), the
    learning rate frozen at the captured step's, and Adam's beta powers
    one step ahead."""
    from paddle_tpu_torch.framework import executor as texec

    e = _replay_leg(replay_start, staged=False)
    start = None
    if broken == "skips_the_capture_step":
        real = texec._CompiledStep.body

        def body(self, replayed):
            if not replayed or self.run.calls["replay"]:
                return real(self, replayed)
            saved = {n: t.clone() for n, t in self.bound.items()}
            out = real(self, replayed)
            for n, t in saved.items():  # the state never moved
                self.bound[n].copy_(t)
            return out

        monkeypatch.setattr(texec._CompiledStep, "body", body)
    elif broken == "freezes_the_learning_rate":
        feeds = replay_start[0][0]._extra_feeds
        (name, rate), = feeds.items()
        seen = []

        def frozen():  # from the capture (run 2) on, the captured rate
            seen.append(rate())
            return seen[min(len(seen), 2) - 1]

        monkeypatch.setitem(feeds, name, frozen)
    else:
        start = {n: t * 0.9 if "_pow_" in n else t
                 for n, t in replay_start[1].items()}
    r = _replay_leg(replay_start, staged=True, start=start)
    with pytest.raises(AssertionError, match=match):
        chip_smoke._replay_agrees(r, e, _REPLAY_LRS, replay_start[3])


def test_replay_check_names_only_what_eager_shares(replay_start):
    """A loss and a persistable that differ pass only where a second
    eager run differs from the first in the same places."""
    e = _replay_leg(replay_start, staged=False)
    r = _replay_leg(replay_start, staged=True)

    def shifted(t):
        out = dict(t, losses=t["losses"][:-1] + [t["losses"][-1] + 1e-6],
                   state=dict(t["state"]))
        out["state"]["gpt.wte"] = t["state"]["gpt.wte"] + 1e-6
        return out

    with pytest.raises(AssertionError, match="no second eager run"):
        chip_smoke._replay_agrees(shifted(r), e, _REPLAY_LRS,
                                  replay_start[3])
    with pytest.raises(AssertionError, match="do not share"):
        chip_smoke._replay_agrees(shifted(r), e, _REPLAY_LRS,
                                  replay_start[3], again=e)
    report = chip_smoke._replay_agrees(shifted(r), e, _REPLAY_LRS,
                                       replay_start[3], again=shifted(e))
    assert not report["bit_identical"] and "run-to-run" in report["cause"]
    assert report["loss_steps_differing"] == [len(_REPLAY_LRS)]


# ---------------------------------------------------------------------------
# train_observed (the step-side observability phase): its checks, and the
# whole phase at a tiny config on the CPU's staged route
# ---------------------------------------------------------------------------

_OBS_TINY = dict(vocab_size=64, n_layer=1, n_head=2, d_model=16,
                 max_seq_len=32)


def _closed(compile_s, device_s):
    return {"compile": compile_s, "device_compute": device_s,
            "host_other": 0.001}


def test_goodput_split_passes_the_executor_buckets():
    phases = ["eager", "capture", "replay", "replay"]
    closed = [_closed(0.5, 0.0), _closed(0.7, 0.0), _closed(0.0, 0.08),
              _closed(0.0, 0.09)]
    got = chip_smoke._goodput_split(closed, phases)
    assert got["eager"]["compile_s"] == 0.5
    assert got["replay"]["device_compute_s"] == pytest.approx(0.17)


@pytest.mark.parametrize("fault", ["replay_as_compile", "capture_as_device",
                                   "warmup_as_both", "one_step_short"])
def test_goodput_split_rejects_misfiled_runs(fault):
    phases = ["eager", "capture", "replay", "replay"]
    closed = [_closed(0.5, 0.0), _closed(0.7, 0.0), _closed(0.0, 0.08),
              _closed(0.0, 0.09)]
    if fault == "replay_as_compile":
        closed[3] = _closed(0.09, 0.0)
    elif fault == "capture_as_device":
        closed[1] = _closed(0.0, 0.7)
    elif fault == "warmup_as_both":
        closed[0] = _closed(0.4, 0.1)
    else:
        closed = closed[:3]
    with pytest.raises(AssertionError, match="goodput"):
        chip_smoke._goodput_split(closed, phases)


def _observed_program():
    from paddle_tpu_torch.framework import Scope

    program = chip_smoke._train_program(_OBS_TINY, 2, 8)
    scope, exe = Scope(), chip_smoke._executor("cpu")
    exe.run(program[1], scope=scope)
    feed = chip_smoke._fixed_batch(torch, _OBS_TINY["vocab_size"], 2, 8,
                                   "cpu")
    return program, scope, exe, feed


@pytest.mark.parametrize("name", ["gpt.wpe", "gpt.h0.attn.q.w"])
def test_probe_vector_names_the_first_bad_op(name, monkeypatch):
    """The staged route: two clean runs (the warm-up and the capture),
    then the poisoned one, a replay; the probe vector read after it
    names the first op that reads the poisoned weight, and ``_names_op``
    holds the error to it and rejects another op."""
    monkeypatch.setenv("PADDLE_TPU_CHECK_NUMERICS", "1")
    program, scope, exe, feed = _observed_program()
    exe.staged = True
    chip_smoke._observed_steps(torch, exe, scope, program, feed, 2,
                               close=False)
    got = chip_smoke._poisoned(torch, exe, scope, program, feed, name, 0)
    idx, op_type = chip_smoke._first_reader(program[0], name)
    assert got == {"op_idx": idx, "op_type": op_type,
                   "error": "InvalidArgumentError", "phase": "replay"}
    (entry,) = [e for e in exe._cache.values() if e.probes is not None
                and e.compiled is not None]
    assert entry.probes.first_bad()[:2] == (idx, op_type)
    # the next run (the state is poisoned now) raises again: _names_op
    # holds it to the op the probes name, and rejects another op or the
    # legacy flag's error type
    with pytest.raises(Exception) as info:
        exe.run(program[0], feed=feed, fetch_list=[program[2]["loss"]]
                + chip_smoke._grad_names(program[0]), scope=scope)
    first = entry.probes.first_bad()
    chip_smoke._names_op(info.value, first[0], first[1])
    with pytest.raises(AssertionError, match="sentinel"):
        chip_smoke._names_op(info.value, first[0] + 1, first[1])
    with pytest.raises(AssertionError, match="FLAGS_check_nan_inf"):
        chip_smoke._names_op(info.value, first[0], first[1], typed=False)


def test_memwatch_and_insight_checks_reject_faults():
    totals = {"lifetime_peak_bytes": 1000, "leak_events": 0, "steps": 6,
              "step_series": [{}] * 6}
    assert chip_smoke._memwatch_agrees(totals, 1005, 6)["rel"] < 0.01
    for bad, alloc in ((dict(totals, lifetime_peak_bytes=900), 1000),
                       (dict(totals, leak_events=1), 1000),
                       (dict(totals, step_series=[{}] * 5), 1000)):
        with pytest.raises(AssertionError, match="memwatch"):
            chip_smoke._memwatch_agrees(bad, alloc, 6)
    rec = {"flops": 1.0e12, "cost_raw": {}, "peak_bytes": None,
           "key_hash": "x"}
    assert chip_smoke._insight_agrees([rec], {"total": 1.0e12})["ratio"] == 1
    with pytest.raises(AssertionError, match="insight"):
        chip_smoke._insight_agrees([rec], {"total": 1.03e12})
    with pytest.raises(AssertionError, match="insight"):
        chip_smoke._insight_agrees([rec, rec], {"total": 1.0e12})


def test_train_observed_phase_on_the_cpu(tmp_path, capsys):
    """The whole phase at a tiny config on the CPU's staged route (the
    card's capture with the body called directly): the flags-off losses
    bit for bit, goodput's split, memwatch, dynamics, the insight against
    the analytic count of the plain versions, the dump, the poisoned
    step (replayed and eager), the resumed epoch loop and /status."""
    launches = chip_smoke._train_observed(
        torch, "cpu", config=_OBS_TINY, batch=2, seq=8, device="cpu",
        steps=6, root=str(tmp_path))
    assert launches == {k: 0 for k in launches}  # the CPU launches none
    import json

    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["phase"] == "train_observed"
    assert report["insight"]["ratio"] == 1.0
    assert report["poisoned"]["replayed"]["phase"] == "replay"
    assert report["recovery"]["bit_identical"]
    assert report["probes"] > 0 and report["memwatch"]["leak_events"] == 0


# -- train_recipe (the pretraining recipe) ------------------------------------

_RECIPE_TINY = dict(vocab_size=64, n_layer=2, n_head=2, d_model=16,
                    max_seq_len=8, dtype="float32", dropout=0.1)


def _recipe_leg(program, start, staged, steps=4):
    from paddle_tpu_torch.framework import Scope

    scope, exe = Scope(), chip_smoke._executor("cpu")
    exe.staged = staged
    for n, t in start.items():
        scope.set(n, t.clone())
    feed = chip_smoke._fixed_batch(torch, 64, 2, 8, "cpu")
    return chip_smoke._recipe_trajectory(torch, exe, scope, program, feed,
                                         steps)


@pytest.fixture(scope="module")
def recipe_legs():
    """The recipe at a tiny fp32 config on the CPU from one start: eager
    with recompute (E), staged with recompute (R) and staged without (N),
    the clip at 0.05 so that it engages."""
    from paddle_tpu_torch.framework import Scope

    program = chip_smoke._recipe_program(_RECIPE_TINY, 2, 8, clip_norm=0.05)
    plain = chip_smoke._recipe_program(_RECIPE_TINY, 2, 8, recompute=False,
                                       clip_norm=0.05)
    scope = Scope()
    chip_smoke._executor("cpu").run(program[1], scope=scope)
    start = {n: scope.get(n).clone() for n in scope.local_var_names()}
    return {"E": _recipe_leg(program, start, False),
            "R": _recipe_leg(program, start, True),
            "N": _recipe_leg(plain, start, True), "program": program}


def test_recipe_replays_equal_eager_and_no_recompute(recipe_legs):
    r, e, n = recipe_legs["R"], recipe_legs["E"], recipe_legs["N"]
    assert r["phases"] == {"eager": 1, "capture": 1, "replay": 2}
    assert chip_smoke._unequal(r["state"], e["state"]) == []
    assert r["state"]["(seed, step)"].tolist() == [chip_smoke._RECIPE_SEED,
                                                   4]
    for key in ("losses", "norms", "scales", "keep"):
        assert r[key] == e[key]
    assert chip_smoke._recompute_agrees(r, n) == {"bit_identical": True}
    assert all(r["masks_differ"])
    report = chip_smoke._keep_share_ok(r["keep"], 0.1, r["mask_elements"])
    assert report["worst_sigmas"] <= chip_smoke._RECIPE_SIGMAS
    clip = chip_smoke._clip_agrees(r["norms"], r["scales"], 0.05)
    assert clip["steps_clipped"] == len(r["norms"])
    main = recipe_legs["program"][0]
    assert sum(op.type == "fused_attention_tpu"
               for op in main.global_block().ops) == 2 * 2


def test_recipe_checks_reject_what_they_must(recipe_legs):
    r = recipe_legs["R"]
    n = dict(r, losses=[x * (1 + 3e-5) for x in r["losses"]])
    with pytest.raises(AssertionError, match="recompute"):
        chip_smoke._recompute_agrees(r, n, lambda: {"param": "w"})
    near = dict(r, losses=[x * (1 + 3e-6) for x in r["losses"]])
    got = chip_smoke._recompute_agrees(r, near, lambda: {"param": "w"})
    assert got["first_differing"] == {"param": "w"}
    elems = 1_000_000
    sd = (0.09 / elems) ** 0.5
    chip_smoke._keep_share_ok([0.9 + 4 * sd, 0.9 - 4 * sd], 0.1, elems)
    with pytest.raises(AssertionError, match="sigma"):
        chip_smoke._keep_share_ok([0.9, 0.9 + 6 * sd], 0.1, elems)
    with pytest.raises(AssertionError, match="sigma"):
        chip_smoke._keep_share_ok([0.8], 0.1, elems)  # p dropped twice
    norms = [2.5, 1.25, 0.5]
    good = [float(np.float32(1.0) / np.float32(x)) for x in (2.5, 1.25, 1.0)]
    chip_smoke._clip_agrees(norms, good, 1.0)
    with pytest.raises(AssertionError, match="clip scales"):
        chip_smoke._clip_agrees(norms, good[:2] + [2.0], 1.0)  # not min(1,.)
    with pytest.raises(AssertionError, match="clip scales"):
        chip_smoke._clip_agrees(norms, [0.4, 0.8, 1.0], 1.0)  # float64 math
    with pytest.raises(AssertionError, match="never exceeded"):
        chip_smoke._clip_agrees([0.5, 0.25], [1.0, 1.0], 1.0)
    assert chip_smoke._peaks_agree(10, 4, 10)["freed"] == 6
    with pytest.raises(AssertionError, match="half"):
        chip_smoke._peaks_agree(10, 7, 10)
    with pytest.raises(AssertionError, match="half"):
        chip_smoke._peaks_agree(10, 10, 0)


def test_segment_reckoning_grows_with_the_tokens():
    """The tape's bytes for one layer's segment, reckoned on the CPU with
    attention on the flash path (as at seq 2048), grow in proportion to
    the tokens, batch or length alike (flash saves no [T, T] tensor), and
    at least hold the layer's own outputs: the four [tokens, 4d] MLP
    activations and the six [tokens, d] ones."""
    cfg = dict(_RECIPE_TINY, d_model=128, max_seq_len=256)
    one = chip_smoke._segment_bytes(torch, cfg, "cpu", batch=1, seq=128)
    two = chip_smoke._segment_bytes(torch, cfg, "cpu", batch=2, seq=128)
    long = chip_smoke._segment_bytes(torch, cfg, "cpu", batch=1, seq=256)
    assert one["records"] == two["records"] == long["records"] > 10
    assert two["bytes"] == long["bytes"] == 2 * one["bytes"]
    assert one["per_token"] >= 4 * (4 * 128 * 4 + 6 * 128)


# -- train_eager's checks -----------------------------------------------------

_EAGER_TINY = dict(vocab=32, seq=16, d_model=16, n_head=2, n_layer=1,
                   dropout=0.1)


@contextlib.contextmanager
def _eager_cpu():
    """Dygraph mode on the CPU place inside a file that builds static
    programs; restores both."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.framework import core

    prev = core._default_place
    pt.set_device("cpu")
    try:
        with dygraph.guard():
            yield pt
    finally:
        core._default_place = prev


def _tiny_keep_masks(steps=2):
    """The first layer's attention-dropout keep masks of a tiny eager fit
    on the CPU, fetched as train_eager fetches them (a pre-hook on
    out_proj)."""
    with _eager_cpu() as pt:
        pt.seed(1)
        net = chip_smoke._masked_lm(pt, **_EAGER_TINY)
        masks = []
        net.encoder.layers[0].self_attn.out_proj.register_forward_pre_hook(
            lambda layer, args: masks.append(args[0]._value != 0))
        ids, labels = chip_smoke._mlm_batch(_EAGER_TINY["vocab"], 8,
                                            _EAGER_TINY["seq"], seed=2)
        chip_smoke._eager_fit(pt, net, ids, labels, steps, lr=1e-3,
                              amp=False)
    return masks


def test_masks_differ_passes_fresh_masks_and_rejects_repeats():
    masks = _tiny_keep_masks()
    got = chip_smoke._masks_differ(masks, 0.1)
    assert got["differing"] > 0 and got["elements"] == 8 * 16 * 16
    with pytest.raises(AssertionError, match="same keep mask"):
        chip_smoke._masks_differ([masks[0], masks[0].clone()], 0.1)
    with pytest.raises(AssertionError, match="sigma"):
        chip_smoke._masks_differ([masks[0], torch.ones_like(masks[0])], 0.1)
    with pytest.raises(AssertionError, match="1 keep masks"):
        chip_smoke._masks_differ(masks[:1], 0.1)


def test_launches_agree_holds_each_kernel_to_its_count():
    per_step = {"flash_attention_fwd": 12, "fused_adam": 198}
    ok = {"flash_attention_fwd": 96, "fused_adam": 1584}
    assert chip_smoke._launches_agree(ok, 8, per_step)["launches"] == ok
    with pytest.raises(AssertionError, match="launched"):
        chip_smoke._launches_agree(dict(ok, fused_adam=0), 8, per_step)
    with pytest.raises(AssertionError, match="launched"):
        chip_smoke._launches_agree(dict(ok, flash_attention_fwd=97), 8,
                                   per_step)
    with pytest.raises(AssertionError, match="launched"):
        chip_smoke._launches_agree({"flash_attention_fwd": 0}, 8,
                                   {"flash_attention_fwd": 0})
    with pytest.raises(AssertionError, match="launched"):
        chip_smoke._launches_agree({"fused_adam": 1584}, 8, per_step)


def test_resume_digest_check_catches_a_resume_that_redraws(tmp_path,
                                                           monkeypatch):
    """``_eager_resume`` ends bit-identical on the CPU (a tiny copy of
    train_eager's), and fails when the resumed run draws its dropout masks
    from the wrong step (the checkpoint's tracer step not restored)."""
    from paddle_tpu_torch.dygraph.tracer import Tracer

    with _eager_cpu() as pt:
        res = chip_smoke._eager_resume(pt, _EAGER_TINY, 2, 4, 8,
                                       str(tmp_path / "ok"))
        assert res["bit_identical"] and res["resumed_at"] == 4
        monkeypatch.setattr(Tracer, "set_seed_step",
                            lambda self, seed, step: None)
        with pytest.raises(AssertionError, match="digest"):
            chip_smoke._eager_resume(pt, _EAGER_TINY, 2, 4, 8,
                                     str(tmp_path / "bad"))
    assert chip_smoke._digests_agree("a", "a")["bit_identical"]
    with pytest.raises(AssertionError, match="digest"):
        chip_smoke._digests_agree("a", "b")


def test_jit_checks_pass_agreement_and_reject_what_they_must():
    """The ``jit`` phase's checkers: bit identity (a one-ulp change, a
    dtype and a shape fail), the relative tolerance (reported with bit
    identity), a route and its counts, the launch sequence; and the
    conditional-node probe names this torch's API."""
    g = torch.Generator().manual_seed(3)
    a = torch.randn(4, 8, generator=g).to(torch.bfloat16)
    assert chip_smoke._bit_identical(torch, a.clone(), a, "x")[
        "bit_identical"]
    nudged = a.clone()
    nudged.view(torch.int16)[0, 0] += 1  # one bf16 ulp
    for bad in (nudged, a.float(), a[:2]):
        with pytest.raises(AssertionError, match="bit-identical"):
            chip_smoke._bit_identical(torch, bad, a, "x")
    ok = chip_smoke._rel_agrees(torch, nudged, a, 2.0 ** -7, "x")
    assert not ok["bit_identical"] and 0 < ok["max_rel_err"] <= 2.0 ** -7
    with pytest.raises(AssertionError, match="relative error"):
        chip_smoke._rel_agrees(torch, a * 1.1, a, 2.0 ** -7, "x")
    info = {"route": "loop", "host_reads": 9, "trips": 6}
    assert chip_smoke._route_agrees(info, "loop", "x", trips=6) is info
    for route, want in (("graph", {"trips": 6}), ("loop", {"trips": 5})):
        with pytest.raises(AssertionError, match="route"):
            chip_smoke._route_agrees(info, route, "x", **want)
    assert chip_smoke._counts_agree([12, 24], [12, 24], "x") == [12, 24]
    with pytest.raises(AssertionError, match="flash forward launches"):
        chip_smoke._counts_agree([12, 24, 36], [12, 24, 24], "x")
    assert chip_smoke._if_nodes() == hasattr(
        torch.cuda.CUDAGraph, "begin_capture_to_if_node")


def test_narrow_loop_case_on_the_staged_route(monkeypatch):
    """The ``jit`` phase's ``narrow_loop`` at a tiny width on the CPU's
    staged route: the loop route's result agrees with eager's and its
    counts (trips, host reads, one captured body) are the ones the card
    must show."""
    from types import SimpleNamespace

    from paddle_tpu_torch import jit

    def staged(fn):
        sf = jit.to_static(fn)
        sf.staged = True
        return sf

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(chip_smoke, "_JIT_NARROW",
                        dict(_EAGER_TINY, n_layer=2, dropout=0.0))
    monkeypatch.setattr(chip_smoke, "_JIT_NARROW_TRIPS", 4.0)
    with _eager_cpu() as pt, pt.no_grad():
        r = chip_smoke._narrow_loop(torch, pt,
                                    SimpleNamespace(to_static=staged), "cpu")
    assert r["trips"] == 4 and r["route"]["loop_bodies"] == 1
    assert len(r["calls"]) == chip_smoke._JIT_NARROW_CALLS
    assert all(c["max_rel_err"] <= chip_smoke._JIT_LOAD_RTOL
               for c in r["calls"])


def test_kernel_tally_counts_kernels_not_ranges():
    """``_kernel_tally`` sums device kernels only: an executor op's range
    and a scheduled trace's step range (``_profiled``) also lie on the
    device timeline and span kernels already counted."""
    from types import SimpleNamespace

    from paddle_tpu_torch.framework.executor import OP_RANGE

    def event(name, us, device=torch.autograd.DeviceType.CUDA,
              annotation=False):
        return SimpleNamespace(name=name, device_type=device,
                               is_user_annotation=annotation,
                               time_range=SimpleNamespace(
                                   elapsed_us=lambda: us))

    events = [event("void (anonymous namespace)::fwd_sm90_kernel<64>(x)",
                    400.0),
              event("void at::native::elementwise_kernel<128, 2>", 100.0),
              # as the card's profiler names a scheduled step's range
              event("ProfilerStep*", 900.0, annotation=True),
              event(OP_RANGE + "fused_attention_tpu", 450.0),
              event("ProfilerStep#1", 5.0, torch.autograd.DeviceType.CPU)]
    kernels, device_ms, ours, _, _ = chip_smoke._kernel_tally(torch, events)
    assert device_ms == pytest.approx(0.5)
    assert sorted(kernels) == sorted(e.name for e in events[:2])
    assert ours["flash_attention_fwd"] == {"calls": 1, "ms": 0.4}


def test_traced_window_keeps_what_lies_between_its_markers():
    """``_between_marks`` keeps the host's events and the device records
    between the two marker kernels on the card's clock: a warm-up step's
    record kept before the first marker, the markers and their launches
    go; a trace that lost a marker's record raises ``_TraceLost``."""
    from types import SimpleNamespace

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    marker = "at::cuda::spin_kernel(long)"

    def event(name, start, device=cuda, kernels=()):
        return SimpleNamespace(name=name, device_type=device,
                               kernels=[SimpleNamespace(name=k)
                                        for k in kernels],
                               time_range=SimpleNamespace(start=start))

    events = [event("void fused_adam_kernel(x)", 5.0),  # the warm-up's
              event(marker, 10.0),
              event("void (anonymous namespace)::fwd_sm90_kernel<64>(x)",
                    20.0),
              event("void at::native::elementwise_kernel<128, 2>", 30.0),
              event(marker, 40.0),
              event("cudaLaunchKernel", 9.0, cpu, kernels=[marker]),
              event("cudaGraphLaunch", 15.0, cpu,
                    kernels=["void at::native::elementwise_kernel<128, 2>"]),
              event("ProfilerStep#1", 1.0, cpu)]
    assert chip_smoke._TRACE_MARKER in marker
    kept = chip_smoke._between_marks(torch, events)
    assert [e.name for e in kept] == [e.name for e in events[2:4]
                                      + events[6:]]
    for lost in (1, 4):
        with pytest.raises(chip_smoke._TraceLost, match="kept 1 of its 2"):
            chip_smoke._between_marks(torch, events[:lost]
                                      + events[lost + 1:])


def test_device_ms_takes_a_lost_trace_again(monkeypatch):
    """``_device_ms`` traces again where a trace lost its records, up to
    ``_TRACE_TRIES`` traces: a second trace that keeps them gives the
    device ms of one call; two lost traces give None, each said on a
    ``trace_lost`` line."""
    from types import SimpleNamespace

    record = SimpleNamespace(
        name="void (anonymous namespace)::fwd_f32_d256_sm90_kernel(x)",
        device_type=torch.autograd.DeviceType.CUDA, is_user_annotation=False,
        time_range=SimpleNamespace(elapsed_us=lambda: 800.0))
    outcomes, said = [], []

    def profiled(torch_, fn, *args):
        fn(*args)
        if outcomes.pop(0):
            return None, 0.0, [record] * 10
        raise chip_smoke._TraceLost("lost")

    calls = []
    assert chip_smoke._TRACE_TRIES == 2
    monkeypatch.setattr(chip_smoke, "_profiled", profiled)
    monkeypatch.setattr(chip_smoke, "_say", lambda **kw: said.append(kw))
    outcomes[:] = [False, True]
    assert chip_smoke._device_ms(torch, lambda: calls.append(1)) == \
        pytest.approx(0.8)
    assert len(calls) == 20 and [k["attempt"] for k in said] == [1]
    outcomes[:] = [False, False]
    assert chip_smoke._device_ms(torch, lambda: None) is None
    assert [k["attempt"] for k in said] == [1, 1, 2]


def test_smoke_finds_the_d256_kernels_by_name():
    """The head_dim-256 forward, dq and dk/dv map to exactly one
    ``_SM90_KERNELS`` key each in the build's SASS and ptxas report, and
    none of the D = 64/128 flash kernels or the CE forward maps to them;
    in a device trace they count as the flash forward, dq and dk/dv, and
    the named check of a traced step (``_D256_NAMES``) finds each of them
    apart from the others and from the SIMT dq, whose piece it wants at
    no call."""
    from types import SimpleNamespace

    space = "_ZN58_GLOBAL__N__a6c4b388_33_{}_cu_46558d5b"
    names = {
        space.format("flash_attention_fwd_d256_sm90")
        + "20fwd_d256_sm90_kernelEv14CUtensorMap_stS1_S1_NS_6ParamsE":
            "flash_attention_fwd_d256",
        space.format("flash_attention_dkv_d256_sm90")
        + "20dkv_d256_sm90_kernelEv14CUtensorMap_stS1_S1_S1_NS_6ParamsE":
            "flash_attention_dkv_d256",
        space.format("flash_attention_dq_d256_sm90")
        + "19dq_d256_sm90_kernelEv14CUtensorMap_stS1_S1_S1_NS_6ParamsE":
            "flash_attention_dq_d256",
        space.format("flash_attention_bwd_sm90")
        + "14dq_sm90_kernelILi64EEEv14CUtensorMap_stS1_S1_S1_NS_6ParamsE":
            "flash_attention_dq_d64",
        space.format("flash_attention_fwd_sm90")
        + "15fwd_sm90_kernelILi64EEEv14CUtensorMap_stS1_S1_NS_6ParamsE":
            "flash_attention_fwd_d64",
        space.format("flash_attention_bwd_sm90")
        + "15dkv_sm90_kernelILi128EEEv14CUtensorMap_stS1_S1_S1_NS_6ParamsE":
            "flash_attention_dkv_d128",
        space.format("lmhead_ce_fwd_sm90")
        + "15fwd_sm90_kernelEv14CUtensorMap_stS0_PKxPfS3_S3_iiii":
            "lmhead_ce_fwd"}
    for mangled, want in names.items():
        hits = [key for key, parts in chip_smoke._SM90_KERNELS.items()
                if all(p in mangled for p in parts)]
        assert hits == [want], (mangled, hits)
        assert chip_smoke._sm90_kernel(mangled) == want

    def event(name):
        return SimpleNamespace(
            name=name, device_type=torch.autograd.DeviceType.CUDA,
            is_user_annotation=False,
            time_range=SimpleNamespace(elapsed_us=lambda: 250.0))

    args = "(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, " \
           "(anonymous namespace)::Params)"
    simt_dq = "void (anonymous namespace)::dq_kernel<256>" \
        "((anonymous namespace)::Params)"
    events = [event("void (anonymous namespace)::fwd_d256_sm90_kernel" + args),
              event("void (anonymous namespace)::dq_d256_sm90_kernel" + args),
              event("void (anonymous namespace)::dkv_d256_sm90_kernel"
                    + args),
              event(simt_dq)]
    kernels, _, ours, families, _ = chip_smoke._kernel_tally(torch, events)
    assert {k: v["calls"] for k, v in ours.items()} == {
        "lmhead_ce_fwd": 0, "lmhead_ce_dx": 0, "lmhead_ce_dw": 0,
        "flash_attention_fwd": 1, "flash_attention_dq": 2,
        "flash_attention_dkv": 1, "fused_adam": 0}
    assert families == {}
    assert chip_smoke._D256_NAMES["::dq_d256_sm90_kernel("] == \
        chip_smoke._LAYERS and chip_smoke._D256_NAMES["::dq_kernel<"] == 0
    for piece in chip_smoke._D256_NAMES:
        hits = [k for k in kernels if piece in k]
        assert hits == [simt_dq] if piece == "::dq_kernel<" else \
            len(hits) == 1 and hits != [simt_dq], (piece, hits)


@pytest.fixture(scope="module")
def d256_leg():
    """The flash_d256 leg's runs on the CPU: K (the wrappers, here the
    plain versions), Y and T."""
    leg = chip_smoke._CPU_VS_CARD[2]
    assert leg[0] == "flash_d256" and leg[1]["dtype"] == "bfloat16"
    return leg, chip_smoke._bf16_leg_runs(torch, *leg[1:], card="cpu")


def test_bf16_leg_passes_the_plain_run(d256_leg):
    """K equal to Y passes; flash ran on every side."""
    _, runs = d256_leg
    assert min(r[2] for r in runs.values()) > 0
    report = chip_smoke._bf16_leg_agrees(runs, "plain")
    assert report["moments"] > 0 and report["worst_moment"]["share"] <= 1


def test_bf16_leg_rejects_a_dropped_key_tile(d256_leg, monkeypatch):
    """A dk/dv whose dk of the first 64 keys is 0 (a dropped key tile)
    moves the key weights' moment far beyond the bound."""
    from paddle_tpu_torch.ops import flash_attention as fl

    leg, runs = d256_leg
    plain = fl.flash_attention_dkv_plain

    def dropped(*args):
        dk, dv = plain(*args)
        dk = dk.clone()
        dk[:, :64] = 0  # BTHD: (B, T, H, D)
        return dk, dv

    monkeypatch.setattr(fl, "flash_attention_dkv_plain", dropped)
    bad = chip_smoke._bf16_leg_runs(torch, *leg[1:], card="cpu")
    with pytest.raises(AssertionError, match="attn.k.w_moment1"):
        chip_smoke._bf16_leg_agrees(dict(runs, K=bad["K"]), "dropped")


_AMP_CFG = dict(vocab_size=128, n_layer=2, n_head=2, d_model=32,
                max_seq_len=16)


def _amp_start(main, startup):
    from paddle_tpu_torch.framework import Scope

    scope, exe = Scope(), chip_smoke._executor("cpu")
    exe.run(startup, scope=scope)
    return {v.name: scope.get(v.name).clone() for v in main.list_vars()
            if v.persistable}


@pytest.mark.parametrize("case", ["decorated", "undecorated", "rewired"])
def test_amp_rewrite_check_rejects_a_dead_rewrite(case):
    main, _, _ = chip_smoke._amp_program(2, 16, decorate=case != "undecorated",
                                         config=_AMP_CFG)
    if case == "rewired":  # the reference's dead rewrite, on one matmul
        op = next(o for o in main.global_block().ops if o.type == "matmul")
        block = main.global_block()
        src = {slot: [block.var(v.name.split(".cast_")[0]) for v in vs]
               for slot, vs in op._input_vars.items()}
        op._input_vars.update(src)
    if case == "decorated":
        got = chip_smoke._amp_rewrite_agrees(main)
        assert got["casts"] > 0 and got["lm_head_ce_inputs"] == [["float32"]]
        assert set(got["bf16_white_list_ops"]) == {"matmul",
                                                   "fused_attention_tpu"}
    else:
        with pytest.raises(AssertionError, match="static_amp"):
            chip_smoke._amp_rewrite_agrees(main)


@pytest.mark.parametrize("gated", [True, False], ids=["gated", "ungated"])
def test_amp_overflow_step_keeps_every_parameter(monkeypatch, gated):
    main, startup, _ = chip_smoke._amp_program(2, 16, config=_AMP_CFG)
    start = _amp_start(main, startup)
    feed = chip_smoke._fixed_batch(torch, 128, 2, 16, device="cpu")
    if not gated:  # the optimizer's writes land whatever found_inf says
        from paddle_tpu_torch.static import amp

        real = amp.OptimizerWithMixedPrecision._apply_gradients_impl

        def ungated(self, block, params_grads, *rest):
            n = len(block.ops)
            out = real(self, block, params_grads, *rest)
            block.ops[:] = block.ops[:n] + [
                o for o in block.ops[n:] if o.type not in ("where",
                                                           "assign")]
            return out

        monkeypatch.setattr(amp.OptimizerWithMixedPrecision,
                            "_apply_gradients_impl", ungated)
        with pytest.raises(AssertionError, match="overflow"):
            chip_smoke._amp_overflow(torch, 2, 16, start, feed,
                                     config=_AMP_CFG, device="cpu")
        return
    got = chip_smoke._amp_overflow(torch, 2, 16, start, feed,
                                   config=_AMP_CFG, device="cpu")
    assert got["scale"] == [2.0 ** 15, 2.0 ** 14]
    assert got["bad_steps"] == 0 and got["good_steps"] == 0
    assert not np.isfinite(got["loss"])


@pytest.mark.parametrize("unscale", ["sound", "left_scaled", "twice"])
def test_amp_moment_check_sees_the_loss_scale(monkeypatch, unscale):
    """``static_amp``'s hold of Adam's first moments against the fp32
    program's (``_leaves_agree`` at ``_AMP_MOMENT_RTOL``), on the tiny GPT
    over 3 steps at lr 1e-4: it passes the sound rewrite (the worst
    parameter 3.6e-3 here) and rejects a ``check_finite_and_unscale``
    that leaves the 2^15 scale on the gradients or divides by it twice,
    though the losses of both stay within ``_AMP_RTOL``."""
    from paddle_tpu_torch.framework import registry

    if unscale != "sound":
        real = registry.get_op_def("check_finite_and_unscale")

        def wrong(ctx, ins, attrs):
            out = real.lower(ctx, ins, attrs)
            scale = ins["Scale"][0].reshape(())
            out["Out"] = [o * scale if unscale == "left_scaled" else o / scale
                          for o in out["Out"]]
            return out

        monkeypatch.setitem(registry._REGISTRY, "check_finite_and_unscale",
                            dataclasses.replace(real, lower=wrong))
    feed = chip_smoke._fixed_batch(torch, 128, 2, 16, device="cpu")
    lrs = [chip_smoke._LR] * 3
    legs = []
    for decorate in (True, False):
        program = chip_smoke._amp_program(2, 16, decorate=decorate,
                                          config=_AMP_CFG)
        io = program[2]
        start = _amp_start(program[0], program[1])
        legs.append(chip_smoke._leg((io["compiled"],) + program[1:], start,
                                    feed, "cpu", lrs))
    amp, fp32 = legs
    rel = [abs(a - b) / abs(b) for a, b in zip(amp["losses"], fp32["losses"])]
    assert max(rel) < chip_smoke._AMP_RTOL
    moments = {n: t for n, t in amp["state"].items() if "_moment1_" in n}
    want = {n: fp32["state"][n] for n in moments}
    if unscale == "sound":
        got = chip_smoke._leaves_agree(moments, want,
                                       chip_smoke._AMP_MOMENT_RTOL, "m1")
        assert got["leaves"] == 36 and got["worst"] < 0.05
    else:
        with pytest.raises(AssertionError, match="m1 of"):
            chip_smoke._leaves_agree(moments, want,
                                     chip_smoke._AMP_MOMENT_RTOL, "m1")


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_running_stats_check(train):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import vision
    from paddle_tpu_torch.framework import core

    prev = core._default_place
    pt.disable_static()
    pt.set_device("cpu")
    try:
        net = vision.models.resnet18(num_classes=10)
        before = {p.name: p._value.clone() for p in net.parameters()
                  if not p.trainable}
        if not train:
            net.eval()
        x = np.random.RandomState(0).randn(2, 3, 32, 32).astype(np.float32)
        with pt.no_grad():
            net(pt.to_tensor(x))
        after = {p.name: p._value for p in net.parameters()
                 if not p.trainable}
    finally:
        core._default_place = prev
        pt.enable_static()
    assert len(before) == 2 * 20  # 20 BatchNorms in resnet18
    if train:
        got = chip_smoke._stats_moved(before, after)
        assert got == {"running_stats": 40, "moved": 40}
    else:
        with pytest.raises(AssertionError, match="did not move"):
            chip_smoke._stats_moved(before, after)


def test_smoke_finds_the_f32_d256_backward_by_name():
    """chip_smoke.py maps each split-TF32 backward kernel (dq and dk/dv at
    head_dim 256, 64 and 128) to exactly one ``_SM90_KERNELS``
    key (none of the bf16 head_dim-256 ones or the fp32 forward to it),
    wants as many tensor-core instructions as the sources issue, a device
    trace charges them to dq and dk/dv, and the ``train_f32_d256`` phase's
    names (``_F32_D256_NAMES``) find each of the head_dim-256 ones apart
    from the SIMT kernels, which it wants at no call."""
    from types import SimpleNamespace

    space = "_ZN69_GLOBAL__N__d13bf6c1_36_{}_cu_331b0b93"
    names = {
        space.format("flash_attention_dkv_f32_d256_sm90")
        + "24dkv_f32_d256_sm90_kernelE14CUtensorMap_stS0_S0_S0_S0_S0_"
          "NS_6ParamsE": "flash_attention_dkv_f32_d256",
        space.format("flash_attention_dq_f32_d256_sm90")
        + "23dq_f32_d256_sm90_kernelE14CUtensorMap_stS0_S0_S0_S0_"
          "NS_6ParamsE": "flash_attention_dq_f32_d256",
        space.format("flash_attention_dkv_d256_sm90")
        + "20dkv_d256_sm90_kernelEv14CUtensorMap_stS1_S1_S1_NS_6ParamsE":
            "flash_attention_dkv_d256",
        space.format("flash_attention_dq_d256_sm90")
        + "19dq_d256_sm90_kernelEv14CUtensorMap_stS1_S1_S1_NS_6ParamsE":
            "flash_attention_dq_d256",
        space.format("flash_attention_fwd_f32_d256_sm90")
        + "24fwd_f32_d256_sm90_kernelE14CUtensorMap_stS0_S0_NS_6ParamsE":
            "flash_attention_fwd_f32_d256"}
    for d in (64, 128):
        names[space.format("flash_attention_dkv_f32_sm90")
              + f"19dkv_f32_sm90_kernelILi{d}EEEv14CUtensorMap_stS1_S1_S1_"
                "S1_S1_NS_6ParamsE"] = f"flash_attention_dkv_f32_d{d}"
        names[space.format("flash_attention_dq_f32_sm90")
              + f"18dq_f32_sm90_kernelILi{d}EEEv14CUtensorMap_stS1_S1_S1_"
                "S1_NS_6ParamsE"] = f"flash_attention_dq_f32_d{d}"
    for mangled, want in names.items():
        hits = [key for key, parts in chip_smoke._SM90_KERNELS.items()
                if all(p in mangled for p in parts)]
        assert hits == [want], (mangled, hits)
    assert chip_smoke._SM90_HGMMA == {"flash_attention_dq_f32_d256": 108,
                                      "flash_attention_dkv_f32_d256": 120,
                                      "flash_attention_dkv_f32_d64": 30,
                                      "flash_attention_dkv_f32_d128": 60,
                                      "flash_attention_dq_f32_d64": 54,
                                      "flash_attention_dq_f32_d128": 108}

    def event(name):
        return SimpleNamespace(
            name=name, device_type=torch.autograd.DeviceType.CUDA,
            is_user_annotation=False,
            time_range=SimpleNamespace(elapsed_us=lambda: 250.0))

    maps = ", ".join(["CUtensorMap_st"] * 5)
    simt = ["void (anonymous namespace)::dq_kernel<128>"
            "((anonymous namespace)::Params)",
            "void (anonymous namespace)::dkv_kernel<128>"
            "((anonymous namespace)::Params)"]
    events = [event("void (anonymous namespace)::fwd_f32_d256_sm90_kernel("
                    "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
                    "(anonymous namespace)::Params)"),
              event("void (anonymous namespace)::dq_f32_d256_sm90_kernel("
                    + maps + ", (anonymous namespace)::Params)"),
              event("void (anonymous namespace)::dkv_f32_d256_sm90_kernel("
                    + maps + ", CUtensorMap_st, (anonymous namespace)::"
                    "Params)")] + [event(n) for n in simt]
    kernels, _, ours, families, _ = chip_smoke._kernel_tally(torch, events)
    assert {k: v["calls"] for k, v in ours.items()} == {
        "lmhead_ce_fwd": 0, "lmhead_ce_dx": 0, "lmhead_ce_dw": 0,
        "flash_attention_fwd": 1, "flash_attention_dq": 2,
        "flash_attention_dkv": 2, "fused_adam": 0}
    assert families == {}
    for piece, calls in chip_smoke._F32_D256_NAMES.items():
        hits = [k for k in kernels if piece in k]
        if calls:
            assert calls == chip_smoke._LAYERS and len(hits) == 1 and \
                hits[0] not in simt, (piece, hits)
        else:
            assert len(hits) == 1 and hits[0] in simt, (piece, hits)


def _trace_event(name, us=250.0):
    from types import SimpleNamespace

    return SimpleNamespace(
        name=name, device_type=torch.autograd.DeviceType.CUDA,
        is_user_annotation=False,
        time_range=SimpleNamespace(elapsed_us=lambda: us))


_DKV_F32 = ("void (anonymous namespace)::dkv_f32_sm90_kernel<{}>("
            + ", ".join(["CUtensorMap_st"] * 6)
            + ", (anonymous namespace)::Params)")
_SIMT = "void (anonymous namespace)::{}_kernel<{}>((anonymous namespace)::Params)"
_DQ_F32 = ("void (anonymous namespace)::dq_f32_sm90_kernel<{}>("
           + ", ".join(["CUtensorMap_st"] * 5)
           + ", (anonymous namespace)::Params)")


@pytest.mark.parametrize("d", [64, 128])
def test_smoke_charges_the_f32_dkv_to_dk_dv(d):
    """A device trace charges the split-TF32 dk/dv at head_dim 64 and 128
    (``dkv_f32_sm90_kernel<D>``) to flash_attention_dkv and nothing else,
    the SIMT dq beside it to flash_attention_dq."""
    events = [_trace_event(_DKV_F32.format(d)),
              _trace_event(_SIMT.format("dq", d))]
    kernels, device_ms, ours, families, _ = chip_smoke._kernel_tally(
        torch, events)
    assert {k: v["calls"] for k, v in ours.items()} == {
        "lmhead_ce_fwd": 0, "lmhead_ce_dx": 0, "lmhead_ce_dw": 0,
        "flash_attention_fwd": 0, "flash_attention_dq": 1,
        "flash_attention_dkv": 1, "fused_adam": 0}
    assert families == {} and device_ms == pytest.approx(0.5)


@pytest.mark.parametrize("d", [64, 128])
def test_smoke_charges_the_f32_dq_to_dq(d):
    """A device trace charges the split-TF32 dq at head_dim 64 and 128
    (``dq_f32_sm90_kernel<D>``) to flash_attention_dq and nothing else,
    the split-TF32 dk/dv beside it to flash_attention_dkv."""
    events = [_trace_event(_DQ_F32.format(d)),
              _trace_event(_DKV_F32.format(d))]
    kernels, device_ms, ours, families, _ = chip_smoke._kernel_tally(
        torch, events)
    assert {k: v["calls"] for k, v in ours.items()} == {
        "lmhead_ce_fwd": 0, "lmhead_ce_dx": 0, "lmhead_ce_dw": 0,
        "flash_attention_fwd": 0, "flash_attention_dq": 1,
        "flash_attention_dkv": 1, "fused_adam": 0}
    assert families == {} and device_ms == pytest.approx(0.5)


@pytest.mark.parametrize("step,ok", [
    ("split_tf32", True), ("simt_dkv", False), ("d128_dkv", False),
    ("missing_one", False), ("simt_dq", False)])
def test_static_amp_fp32_trace_wants_the_split_tf32_dkv(step, ok):
    """The names static_amp's traced fp32 step is held to
    (``_F32_D64_NAMES`` through ``_named_kernels``): 12 calls each of the
    split-TF32 dk/dv and dq at head_dim 64 pass; a step that ran the SIMT
    dk/dv, the head_dim-128 kernel, one call short, or the SIMT dq in
    place of the split-TF32 one fails, naming the phase."""
    layers = chip_smoke._LAYERS
    dkv = {"split_tf32": _DKV_F32.format(64), "simt_dkv":
           _SIMT.format("dkv", 64), "d128_dkv": _DKV_F32.format(128),
           "missing_one": _DKV_F32.format(64),
           "simt_dq": _DKV_F32.format(64)}[step]
    dq = _SIMT.format("dq", 64) if step == "simt_dq" else _DQ_F32.format(64)
    n = layers - 1 if step == "missing_one" else layers
    events = [_trace_event(dkv)] * n + [_trace_event(dq)] * layers
    kernels = chip_smoke._kernel_tally(torch, events)[0]
    if ok:
        named = chip_smoke._named_kernels(kernels, chip_smoke._F32_D64_NAMES,
                                          "static_amp_fp32_profile")
        for piece in ("::dkv_f32_sm90_kernel<64>", "::dq_f32_sm90_kernel<64>"):
            assert named[piece] == {
                "calls": layers, "ms": pytest.approx(0.25 * layers)}
        assert named["::dkv_kernel<"]["calls"] == 0
        assert named["::dq_kernel<"]["calls"] == 0
    else:
        with pytest.raises(AssertionError, match="static_amp_fp32_profile"):
            chip_smoke._named_kernels(kernels, chip_smoke._F32_D64_NAMES,
                                      "static_amp_fp32_profile")
