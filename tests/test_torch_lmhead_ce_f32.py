"""The fp32 lm-head + CE forward's split-TF32 arithmetic, emulated on the
CPU, against the port's plain version, the JAX package's kernel and
float64 logits.

The kernel (``paddle_tpu_torch/csrc/lmhead_ce_fwd_f32_sm90.cu``) cannot
run here, so :func:`emulate` repeats its arithmetic in torch: each
operand split as ``a = hi + lo`` with ``hi = tf32_rna(a)`` and ``lo =
tf32_rna(a - hi)`` (round to nearest, ties away from zero, on the low 13
mantissa bits); per 8-deep slice of D, ``small += lo_x . hi_w``, ``small
+= hi_x . lo_w`` and ``acc += hi_x . hi_w`` into two fp32 accumulators;
the scores ``acc + small`` in fp32; then, per 128-column vocabulary tile,
the kernel's online (max, sum-exp, picked) with ``exp2f`` of scores
prescaled by log2(e), per vocabulary chunk of ``sm90_fwd_split``, and the
combine launch's merge. The tensor cores' fp32 accumulation is modelled
pessimistically: exact products, the sum rounded toward zero after every
4 products (the tensor cores of earlier generations were measured to
truncate; a model that rounds to nearest gives a smaller error).

What is held:

- (a) the emulation against ``lmhead_ce_plain`` at rtol = atol = 1e-4
  (``chip_smoke.py``'s fp32 check) and against the JAX package's
  ``lmhead_ce`` at the fp32 parity tolerance of
  ``tests/test_torch_lmhead_ce.py`` (1e-5); its max error against float64
  logits over the plain fp32 version's own error, the ratio that
  ``chip_smoke._TF32_MULTIPLE`` is twice of; and the same bound refusing a
  1xTF32 emulation (hi . hi alone) by at least 10x, so that it can fail;
- (b) the forward's grid covers every (128-row tile, 128-column vocab
  tile) once at the serving shapes and the edges.
"""
import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.fused_lmhead_ce import lmhead_ce as jax_lmhead_ce
from paddle_tpu_torch.ops import lmhead_ce as ce

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402

_LOG2E = 1.4426950408889634
_NEG = -1e30


def tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest tf32 value (ties away from zero), as fp32 with
    the low 13 mantissa bits zero: the kernel's integer rounding."""
    return ((a.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _round_toward_zero(x64: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    t = x64.float()
    over = t.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(t, torch.zeros_like(t)), t)


def _scores(x, w, products):
    """fp32 [N, V] scores as the kernel's wgmma sum them: ``products`` is
    a list of (a, b, accumulator index) per 8-deep slice, in issue order;
    each accumulator's sum is rounded toward zero every 4 products; the
    accumulators are added once at the end in fp32."""
    n, d = x.shape
    acc = [torch.zeros(n, w.shape[0]), torch.zeros(n, w.shape[0])]
    for k8 in range(0, d, 8):
        for a, b, i in products:
            for k in (k8, k8 + 4):
                part = a[:, k:k + 4].double() @ b[:, k:k + 4].double().t()
                acc[i] = _round_toward_zero(acc[i].double() + part)
    return acc[0] + acc[1]


def split_scores(x, w):
    """The 3xTF32 scores: small (1) += lo.hi, hi.lo; acc (0) += hi.hi."""
    xp, wp = ce.pad_d(x, w)
    xh, wh = tf32_rna(xp), tf32_rna(wp)
    xl, wl = tf32_rna(xp - xh), tf32_rna(wp - wh)
    return _scores(xp, wp, [(xl, wh, 1), (xh, wl, 1), (xh, wh, 0)])


def tf32_scores(x, w):
    """1xTF32 scores: hi . hi alone."""
    xp, wp = ce.pad_d(x, w)
    return _scores(xp, wp, [(tf32_rna(xp), tf32_rna(wp), 0)])


def _exp2_shifted(s, m):
    """exp2f(fmaf(s, log2 e, -m log2 e)) in fp32: the fma rounds once."""
    ms = (m * _LOG2E).float()
    return torch.exp2((s.double() * _LOG2E - ms.double()[:, None]).float())


def reduce_scores(s, labels, sms=132, tile=128):
    """(nll, lse) from fp32 scores [N, V] as the kernel and the combine
    launch reduce them: per chunk of ``sm90_fwd_split``, 128-column tiles
    in order with an online (m, l) and the picked logit; then mg = max m,
    l = sum l exp(m - mg), lse = mg + log(l), nll = lse - picked."""
    n, v = s.shape
    per, chunks = ce.sm90_fwd_split(n, v, sms)
    lbl = labels.long()
    parts = []
    for c in range(chunks):
        m = torch.full((n,), _NEG)
        l = torch.zeros(n)
        pk = torch.zeros(n)
        for c0 in range(c * per * tile, min(v, (c + 1) * per * tile), tile):
            t = s[:, c0:min(v, c0 + tile)]
            m_new = torch.maximum(m, t.max(1).values)
            hit = (lbl >= c0) & (lbl < c0 + t.shape[1])
            pk = pk + torch.where(hit, t.gather(1, (lbl - c0).clamp(
                0, t.shape[1] - 1)[:, None])[:, 0], torch.zeros(n))
            l = (l * torch.exp2(((m - m_new) * _LOG2E).float())
                 + _exp2_shifted(t, m_new).sum(1))
            m = m_new
        parts.append((m, l, pk))
    m = torch.stack([p[0] for p in parts])
    mg = m.max(0).values
    l = sum(p[1] * torch.exp(p[0] - mg) for p in parts)
    lse = mg + torch.log(torch.where(l > 0, l, torch.ones_like(l)))
    return lse - sum(p[2] for p in parts), lse


def emulate(x, w, labels, scores=split_scores):
    """(nll, lse) of the kernel's arithmetic on CPU tensors."""
    return reduce_scores(scores(x, w), labels)


# N = 64 rows at the serving width D = 768 (a 128-row tile, half empty),
# V = 2048 in 16 vocabulary tiles; the card check's input distribution
_N, _D, _V = 64, 768, 2048


@pytest.fixture(scope="module")
def serving_like():
    x, w, lbl = chip_smoke._inputs(torch, _N, _D, _V, torch.float32, seed=12,
                                   device="cpu")
    lbl[3], lbl[7] = _V, -1
    return x, w, lbl, emulate(x, w, lbl)


def test_emulation_matches_the_plain_version(serving_like):
    x, w, lbl, got = serving_like
    chip_smoke._ce_fwd_agrees(torch, got, ce.lmhead_ce_plain(x, w, lbl), lbl,
                              _V, 1e-4, "3xTF32 emulation")


def test_emulation_matches_jax(serving_like):
    x, w, lbl, (nll, _) = serving_like
    want = np.asarray(jax_lmhead_ce(jnp.asarray(x.numpy()),
                                    jnp.asarray(w.numpy()),
                                    jnp.asarray(lbl.numpy().astype(np.int32)),
                                    block_n=16, block_v=128))
    np.testing.assert_allclose(nll.numpy(), want, rtol=1e-5, atol=1e-5)


def test_fp64_bound_holds_the_split_and_refuses_tf32(serving_like):
    """The card's fp64-truth bound, _TF32_MULTIPLE x the plain fp32
    version's own error + 1e-6: twice the emulation's ratio or more, so
    the emulation passes it; a 1xTF32 emulation lies 10x beyond it."""
    x, w, lbl, got = serving_like

    def truth_err(out):  # max abs error of (nll, lse) vs float64 logits
        return chip_smoke._fp64_err(torch, out, x, w, lbl)

    plain = truth_err(ce.lmhead_ce_plain(x, w, lbl))
    split = truth_err(got)
    single = truth_err(emulate(x, w, lbl, tf32_scores))
    ratio = split / plain
    bound = chip_smoke._TF32_MULTIPLE * plain + chip_smoke._TF32_ATOL
    assert chip_smoke._TF32_MULTIPLE >= 2 * ratio, (ratio, plain, split)
    assert split <= bound
    assert single >= 10 * bound, (single, bound)
    assert math.isfinite(ratio)


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10  # the tf32 value after 1
    half = 2.0 ** -11       # half of tf32's ulp at 1
    a = torch.tensor([1.0 + half * 0.99, 1.0 + half, -(1.0 + half),
                      1.0 + half * 1.01, 3.0, one], dtype=torch.float32)
    got = tf32_rna(a).tolist()
    assert got == [1.0, one, -one, one, 3.0, one]
    lo = tf32_rna(a - tf32_rna(a))
    assert (tf32_rna(lo) == lo).all()


@pytest.mark.parametrize("n", [1, 31, 127, 511, 600])
@pytest.mark.parametrize("v", [1, 130, 32000])
def test_fp32_forward_grid_covers_every_tile_once(n, v):
    """The fp32 forward's launch (``sm90_fwd_blocks``, the grid of
    ``_partial_sm90`` for both dtypes) covers every (128-row tile,
    128-column vocab tile) exactly once; no chunk starts at or past V,
    which the kernel's entry point refuses."""
    tn, tv = ce.SM90_FWD_TILE_N, ce.SM90_FWD_TILE_V
    blocks = ce.sm90_fwd_blocks(n, v, sms=132)
    per, chunks = ce.sm90_fwd_split(n, v, 132)
    assert (chunks - 1) * per * tv < v
    seen = []
    for (r0, r1), (c0, c1) in blocks:
        assert r1 == min(n, r0 + tn) and c0 < c1 <= v
        seen += [(r0, c) for c in range(c0, c1, tv)]
    want = [(r, c) for r in range(0, n, tn) for c in range(0, v, tv)]
    assert sorted(seen) == want and len(set(seen)) == len(seen)
    if n <= tn and v == 32000:  # one row tile: the chunks fill the card
        assert len(blocks) >= 132
