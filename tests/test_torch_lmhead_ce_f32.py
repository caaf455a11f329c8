"""The fp32 lm-head + CE kernels' split-TF32 arithmetic (the forward, and
the backward's dx and dW), emulated on the CPU, against the port's plain
versions, the JAX package's kernels and float64.

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
  tile) once at the serving shapes and the edges;
- (c) the backward (``lmhead_ce_bwd_f32_sm90.cu``, emulated by
  :func:`emulate_bwd`, described above it): dx and dW against
  ``lmhead_ce_dx_plain`` / ``lmhead_ce_dw_plain`` at the card check's
  fp32 tolerance, by the launch's column chunks and in one chunk; against
  the JAX package's gradient (interpret mode) at that tolerance at D 768
  and at the parity tolerance 1e-5 at D 64 and 32; within
  ``chip_smoke._BWD_TF32_MULTIPLE`` (twice the emulation's largest ratio
  over twelve seeds, at the worst of them) times the plain version's own
  error against float64, which a 1xTF32 emulation fails by 10x or more;
- (d) the backward's grid covers every (32-row tile, 64-column tile)
  once, and the anchors of its ablation tool are in its source.
"""
import torch_threads  # noqa: F401 (one torch thread a worker)
import math
import os
import sys

import jax
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


# ---------------------------------------------------------------- backward
#
# The fp32 backward (``paddle_tpu_torch/csrc/lmhead_ce_bwd_f32_sm90.cu``,
# dx and dW) in the same terms: a block owns 32 rows and sweeps 64-column
# tiles of the other side ("columns"), a chunk of them each
# (``sm90_f32_bwd_split``). Per column tile, the score S^T[c, r] is split
# TF32 over D, the two warpgroups each taking every other 32-deep box of D:
# per two of its boxes a new pair of accumulators (small += lo_c . hi_r,
# small += hi_c . lo_r, big += hi_c . hi_r per 8-deep slice), added into
# the warpgroup's fp32 total once complete (total += big + small), then
# the two totals added; the d-logits
# ``(exp2f(fmaf(S, log2 e, -lse log2 e)) - onehot) * g`` in fp32, split
# into hi and lo; then out^T[d, r] per tile's 64 columns, 8 slices of 8,
# into a new pair (small += lo_b . hi_dl, small += hi_b . lo_dl, big +=
# hi_b . hi_dl) added into the output once complete.
# Chunks' partials are added in chunk order. The tensor cores'
# accumulation is modelled as in the forward: exact products, rounded
# toward zero every 4; so only short sums (64 of D, 64 columns) reach the
# tensor cores' rounding, and the long ones are fp32 adds.


def _mma(acc, a, b):
    """acc (+)= a . b^T over one 8-deep slice ([M, 8] . [N, 8]^T) as the
    tensor cores sum it: two groups of 4 exact products, the sum rounded
    toward zero after each."""
    for k in (0, 4):
        part = a[:, k:k + 4].double() @ b[:, k:k + 4].double().t()
        acc = _round_toward_zero(acc.double() + part)
    return acc


def _pair(a):
    """(hi, lo) of fp32 a: hi = tf32_rna(a), lo = tf32_rna(a - hi)."""
    hi = tf32_rna(a)
    return hi, tf32_rna(a - hi)


def _only_hi(a):
    """1xTF32: hi = tf32_rna(a), lo = 0."""
    return tf32_rna(a), torch.zeros_like(a)


def bwd_score(rows, cols, pair=_pair):
    """S^T as [n_rows, n_cols] fp32 (rows x columns): each warpgroup's
    boxes of 32 (every other one), a new split-TF32 pair of accumulators
    every two of them added into its fp32 total, then the two totals
    added."""
    rows, cols = ce.pad_d(rows, cols, multiple=ce.SM90_F32_BWD_PAD)
    (rh, rl), (ch, cl) = pair(rows), pair(cols)
    n, m = rows.shape[0], cols.shape[0]
    totals = []
    for w in range(2):
        tot = torch.zeros(m, n)
        boxes = list(range(32 * w, rows.shape[1], 64))
        for i in range(0, len(boxes), 2):
            big, small = torch.zeros(m, n), torch.zeros(m, n)
            for k0 in boxes[i:i + 2]:
                for k8 in range(k0, k0 + 32, 8):
                    sl = slice(k8, k8 + 8)
                    small = _mma(small, cl[:, sl], rh[:, sl])
                    small = _mma(small, ch[:, sl], rl[:, sl])
                    big = _mma(big, ch[:, sl], rh[:, sl])
            tot = tot + (big + small)
        totals.append(tot)
    return (totals[0] + totals[1]).t()


def bwd_dlogits(s, labels, lse, g, token_rows):
    """fp32 d-logits [n_rows, n_cols] from the score as the kernel forms
    them: exp2f(fmaf(s, log2 e, -(lse log2 e))), the label's column less
    one, times g; lse, g and labels belong to the tokens (the rows for dx,
    the columns for dW)."""
    lbl = labels.long()
    l2 = (lse * _LOG2E).float()
    if token_rows:
        hit = torch.arange(s.shape[1])[None, :] == lbl[:, None]
        ex = torch.exp2((s.double() * _LOG2E - l2.double()[:, None]).float())
        return (ex - hit.float()) * g[:, None]
    hit = torch.arange(s.shape[0])[:, None] == lbl[None, :]
    ex = torch.exp2((s.double() * _LOG2E - l2.double()[None, :]).float())
    return (ex - hit.float()) * g[None, :]


def bwd_product(dl, cols, sms=132, pair=_pair):
    """out [n_rows, D] fp32 = dl . cols, as the kernel sums it: per chunk
    of ``sm90_f32_bwd_split``, per 64-column tile, a new split-TF32 pair
    of accumulators added into the output once complete; the chunks'
    partials added in order."""
    n_rows, n_cols = dl.shape
    d = cols.shape[1]
    (dh, dlo), (bh, bl) = pair(dl), pair(cols)
    per, chunks = ce.sm90_f32_bwd_split(n_rows, n_cols, sms)
    width = per * ce.SM90_F32_BWD_COLS
    out = None
    for c in range(chunks):
        o = torch.zeros(d, n_rows)
        for c0 in range(c * width, min(n_cols, (c + 1) * width), 64):
            big, small = torch.zeros(d, n_rows), torch.zeros(d, n_rows)
            for k8 in range(c0, c0 + 64, 8):
                sl = slice(k8, k8 + 8)
                ah, al = _pad_cols(bh[sl].t(), 8), _pad_cols(bl[sl].t(), 8)
                bhi, blo = _pad_cols(dh[:, sl], 8), _pad_cols(dlo[:, sl], 8)
                small = _mma(small, al, bhi)
                small = _mma(small, ah, blo)
                big = _mma(big, ah, bhi)
            o = o + (big + small)
        out = o if out is None else out + o
    return out.t()


def _pad_cols(t, k):
    """t with zero columns up to k (a tile's columns past the last)."""
    return torch.nn.functional.pad(t, (0, k - t.shape[1]))


def emulate_bwd(x, w, labels, lse, g, sms=132, pair=_pair):
    """(dx, dW) of the fp32 backward's arithmetic on CPU tensors."""
    s = bwd_score(x, w, pair)              # dx: rows = tokens
    dx = bwd_product(bwd_dlogits(s, labels, lse, g, True), w, sms, pair)
    s = bwd_score(w, x, pair)              # dW: rows = vocab entries
    dw = bwd_product(bwd_dlogits(s, labels, lse, g, False), x, sms, pair)
    return dx, dw


def _jax_grads(x, w, labels, g):
    """(dx, dW) of sum(g * nll) through the JAX package's kernels (interpret
    mode on the CPU), as tests/test_torch_lmhead_ce.py takes them."""
    lbl = jnp.asarray(labels.numpy().astype(np.int32))
    f = lambda a, b: jnp.vdot(jax_lmhead_ce(a, b, lbl, block_n=16,
                                            block_v=128), jnp.asarray(g))
    dx, dw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x.numpy()),
                                        jnp.asarray(w.numpy()))
    return (torch.from_numpy(np.asarray(dx, np.float32)),
            torch.from_numpy(np.asarray(dw, np.float32)))


def _bwd_inputs(n, d, v, seed):
    x, w, lbl = chip_smoke._inputs(torch, n, d, v, torch.float32, seed=seed,
                                   device="cpu")
    if n > 7:
        lbl[3], lbl[7] = v, -1
    g = torch.from_numpy(np.random.RandomState(seed + 1).uniform(
        0.5, 1.5, n).astype(np.float32))
    return x, w, lbl, ce.lmhead_ce_plain(x, w, lbl)[1], g


@pytest.fixture(scope="module")
def train_like():
    """N = 64 tokens (two 32-row tiles) at D = 768, V = 2048 (32 column
    tiles), labels V and -1, g in [0.5, 1.5]: the emulated (dx, dW) by
    the launch's chunks on a 132-SM card (dx: 32 chunks of one tile) and
    in one chunk (sms = 1: the main path's whole sweep), and the 1xTF32
    emulation in one chunk."""
    x, w, lbl, lse, g = _bwd_inputs(_N, _D, _V, seed=10)
    dl_dx = bwd_dlogits(bwd_score(x, w), lbl, lse, g, True)
    dl_dw = bwd_dlogits(bwd_score(w, x), lbl, lse, g, False)
    got = {sms: (bwd_product(dl_dx, w, sms), bwd_product(dl_dw, x, sms))
           for sms in (132, 1)}
    single = emulate_bwd(x, w, lbl, lse, g, sms=1, pair=_only_hi)
    return x, w, lbl, lse, g, got, single


@pytest.mark.parametrize("sms", [132, 1])
def test_bwd_emulation_matches_the_plain_version(train_like, sms):
    """dx and dW of the split-TF32 arithmetic against lmhead_ce_dx_plain
    and lmhead_ce_dw_plain at the card check's fp32 tolerance."""
    x, w, lbl, lse, g, got, _ = train_like
    for name, out, plain in (
            ("lmhead_ce_dx", got[sms][0], ce.lmhead_ce_dx_plain),
            ("lmhead_ce_dw", got[sms][1], ce.lmhead_ce_dw_plain)):
        chip_smoke._ce_grad_agrees(torch, out, plain(x, w, lbl, lse, g),
                                   name, f"3xTF32 emulation, sms={sms}")


def test_bwd_emulation_matches_jax(train_like):
    """dx and dW against the JAX package's gradient of lmhead_ce at D 768,
    at the card check's fp32 tolerance: at this width the plain version
    itself lies up to 3e-5 from the JAX kernels (the scores reach 30), so
    the parity tolerance of D 64 (1e-5, below) does not apply."""
    x, w, lbl, lse, g, got, _ = train_like
    want = _jax_grads(x, w, lbl, g)
    for name, out, ref in zip(("lmhead_ce_dx", "lmhead_ce_dw"), got[132],
                              want):
        chip_smoke._ce_grad_agrees(torch, out, ref, name, "against JAX")


@pytest.mark.parametrize("n,d,v", [(64, 64, 512), (48, 64, 300),
                                   (33, 32, 130)])
def test_bwd_emulation_matches_jax_at_parity_widths(n, d, v):
    """At the widths of tests/test_torch_lmhead_ce.py's fp32 backward
    parity (ragged N and V, labels V and -1, D padded to 64 at D 32) the
    emulation meets the JAX package's gradient at its 1e-5."""
    x, w, lbl, lse, g = _bwd_inputs(n, d, v, seed=5)
    got = emulate_bwd(x, w, lbl, lse, g)
    want = _jax_grads(x, w, lbl, g)
    for out, ref in zip(got, want):
        assert out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_bwd_fp64_bound_holds_the_split_and_refuses_tf32(train_like):
    """The card's fp64 bound for dx and dW, _BWD_TF32_MULTIPLE x the plain
    fp32 version's own error + 1e-6: twice the emulation's ratio or more,
    so the emulation passes it, by chunks and in one chunk; a 1xTF32
    emulation lies 10x beyond it."""
    x, w, lbl, lse, g, got, single = train_like
    plain = (ce.lmhead_ce_dx_plain(x, w, lbl, lse, g),
             ce.lmhead_ce_dw_plain(x, w, lbl, lse, g))
    own = chip_smoke._bwd_fp64_err(torch, plain, x, w, lbl, lse, g)
    one = chip_smoke._bwd_fp64_err(torch, single, x, w, lbl, lse, g)
    for sms in (132, 1):
        err = chip_smoke._bwd_fp64_err(torch, got[sms], x, w, lbl, lse, g)
        for e, p, s in zip(err, own, one):
            bound = chip_smoke._BWD_TF32_MULTIPLE * p + chip_smoke._TF32_ATOL
            assert chip_smoke._BWD_TF32_MULTIPLE >= 2 * e / p, (e, p, sms)
            assert e <= bound and math.isfinite(e)
            assert s >= 10 * bound, (s, bound)


@pytest.mark.parametrize("n_rows,n_cols", [
    (16384, 32768), (32768, 16384),   # dx and dW at the static_amp step
    (511, 32768), (32768, 511), (4096, 32768),
    (33, 130), (130, 33), (1, 300), (300, 1), (600, 5000), (64, 64)])
def test_fp32_backward_grid_covers_every_tile_once(n_rows, n_cols):
    """The fp32 backward's grid (``sm90_f32_bwd_blocks``) covers every
    (32-row tile, 64-column tile) exactly once; no chunk starts at or past
    the last column (the entry point refuses it); one chunk wherever the
    row tiles fill the card, and a split sweep within one wave of a
    132-SM card where they do not."""
    tr, tc = ce.SM90_F32_BWD_ROWS, ce.SM90_F32_BWD_COLS
    blocks = ce.sm90_f32_bwd_blocks(n_rows, n_cols, sms=132)
    per, chunks = ce.sm90_f32_bwd_split(n_rows, n_cols, 132)
    row_tiles = -(-n_rows // tr)
    assert (chunks - 1) * per * tc < n_cols
    assert len(blocks) == row_tiles * chunks
    seen = []
    for (r0, r1), (c0, c1) in blocks:
        assert r1 == min(n_rows, r0 + tr) and c0 % tc == 0 and c0 < c1
        assert c1 <= n_cols
        seen += [(r0, c) for c in range(c0, c1, tc)]
    want = [(r, c) for r in range(0, n_rows, tr) for c in range(0, n_cols, tc)]
    assert sorted(seen) == want and len(set(seen)) == len(seen)
    if row_tiles >= 132:
        assert chunks == 1
    else:
        assert len(blocks) <= 132
        assert len(blocks) > 66 or chunks == -(-n_cols // tc)


def test_f32_ablation_tool_anchors_match_the_backward_kernel():
    """tools/torch_ce_bwd_f32_ablation.py edits the fp32 backward's source
    by text; each of its anchors (the loads, the split, the gathers, the
    small products) must still be in the kernel, and each variant must
    differ from it."""
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "torch_ce_bwd_f32_ablation",
        os.path.join(root, "tools", "torch_ce_bwd_f32_ablation.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with open(tool.SOURCE) as f:
        src = f.read()
    variants = tool.variants(src)
    assert variants["kernel"] == src
    texts = [text for name, text in variants.items() if name != "kernel"]
    assert all(text != src for text in texts)
    assert len(set(texts)) == len(texts)


def test_smoke_finds_the_fp32_backward_kernels_by_name():
    """chip_smoke.py finds the fp32 backward's two instantiations in the
    build's SASS and ptxas report by their mangled names (the bf16 ones
    and the split and reduce launches apart), and charges them, with the
    split and reduce launches' time, to dx and dW in a device trace."""
    from types import SimpleNamespace

    space = "_ZN58_GLOBAL__N__a6c4b388_25_{}_cu_46558d5b"
    f32 = space.format("lmhead_ce_bwd_f32_sm90")
    bf16 = space.format("lmhead_ce_bwd_sm90")
    names = {
        f32 + "19bwd_f32_sm90_kernelILb1EEEv14CUtensorMap_stS1_S1_":
            "lmhead_ce_dx_f32",
        f32 + "19bwd_f32_sm90_kernelILb0EEEv14CUtensorMap_stS1_S1_":
            "lmhead_ce_dw_f32",
        bf16 + "15bwd_sm90_kernelILb1EEEv14CUtensorMap_stS1_PKx":
            "lmhead_ce_dx",
        bf16 + "15bwd_sm90_kernelILb0EEEv14CUtensorMap_stS1_PKx":
            "lmhead_ce_dw",
        f32 + "20bwd_f32_split_kernelILb1EEEvPK6float4PS1_S4_x": None,
        f32 + "21bwd_f32_reduce_kernelILb0EEEvPKfPfxi": None}
    for mangled, want in names.items():
        assert chip_smoke._sm90_kernel(mangled) == want, mangled

    def event(name, us):
        return SimpleNamespace(name=name,
                               device_type=torch.autograd.DeviceType.CUDA,
                               is_user_annotation=False,
                               time_range=SimpleNamespace(
                                   elapsed_us=lambda: us))

    ns = "void (anonymous namespace)::"
    events = [event(ns + "bwd_f32_split_kernel<true>(float4 const*)", 40.0),
              event(ns + "bwd_f32_sm90_kernel<true>(CUtensorMap_st)", 900.0),
              event(ns + "bwd_f32_reduce_kernel<true>(float const*)", 60.0),
              event(ns + "bwd_f32_split_kernel<false>(float4 const*)", 80.0),
              event(ns + "bwd_f32_sm90_kernel<false>(CUtensorMap_st)",
                    1000.0)]
    _, device_ms, ours, families, _ = chip_smoke._kernel_tally(torch, events)
    assert device_ms == pytest.approx(2.08)
    assert ours["lmhead_ce_dx"] == {"calls": 1, "ms": pytest.approx(1.0)}
    assert ours["lmhead_ce_dw"] == {"calls": 1, "ms": pytest.approx(1.08)}
    assert families == {}
