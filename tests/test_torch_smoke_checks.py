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
- CPU against card (``_tiny_agree``): the tiny flash GPT leg, run twice
  on the CPU, agrees with itself, and a run whose dq is 2% too large is
  rejected (Adam's parameter step hardly sees a gradient's size; the
  moments do)."""
import os
import sys

import pytest
import torch

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
