"""The fp32 flash attention dq and dk/dv at head_dim 64, 128 and 256 in
split TF32, emulated on the CPU, against the port's plain versions, the
JAX package's kernels and float64.

The kernels (``paddle_tpu_torch/csrc/flash_attention_dq_f32_d256_sm90.cu``
and ``flash_attention_dkv_f32_d256_sm90.cu`` at 256,
``flash_attention_dq_f32_sm90.cu`` and ``flash_attention_dkv_f32_sm90.cu``
at 64 and 128, their helpers in ``flash_f32_bwd.cuh``) cannot run here,
so :func:`emulate_bwd` repeats their arithmetic in torch:

- each operand split as ``a = hi + lo`` with ``hi = tf32_rna(a)`` and
  ``lo = tf32_rna(a - hi)`` (``tests/test_torch_lmhead_ce_f32.py``'s
  rounding);
- the scores ``S = Q K^T`` and ``dP = dO V^T`` (dq's kernel) or ``S^T = K
  Q^T`` and ``dP^T = V dO^T`` (dk/dv's: the resident tile is A), per
  8-deep slice ``lo_a . hi_b``, ``hi_a . lo_b``, ``hi_a . hi_b``, one
  accumulator a 32-column box of D, the boxes added in fp32 as ``((c0 +
  c1) + (c2 + c3))`` over each half of D (a warpgroup's) and the two
  halves added last at D 256; at 64 and 128 a warpgroup owns all of D:
  ``c0 + c1`` and ``((c0 + c1) + (c2 + c3))``;
- ``P = exp(s * scale - lse)`` (one fused multiply-add, natural exp) with
  the causal mask before the exponential and +1e30 for a row whose lse is
  -1e30; ``dS = P * (dP - delta)`` in fp32;
- P and dS split, and the transposed products ``dQ^T = K^T dS^T``,
  ``dV^T = dO^T P`` and ``dK^T = Q^T dS`` over stage tiles of 16 rows
  (keys for dq, query rows for dk/dv) in order, per 8-row slice ``lo_a .
  hi_b``, ``hi_a . lo_b``, ``hi_a . hi_b`` with A the transposed tile;
- one accumulator a group of ``SM90_F32_BWD_FLUSH`` stage tiles
  (counted from row 0), each group's sum times the scale (1 for dv) added
  to the earlier groups' in fp32, in order.

At head_dim 64 and 128 each of the dq kernel's two warpgroups runs both
score products over all of D for 64 query rows of its own, so its score
sums are those of dk/dv's chains with A and B swapped.

The tensor cores' fp32 accumulation is modelled pessimistically, as
``tests/test_torch_flash_attention_f32.py`` models it: exact products,
the sum rounded toward zero after every 4.

What is held, at D 64, 128 and 256 (dq, dk, dv; the dq at 64 and 128 by
tests of its own, ``test_dq_*`` and ``test_fp64_bound_holds_dq_*``), both
layouts, causal and not, Tq != Tk, rows that see no key, and T up to 384:

- the emulation against ``flash_attention_dq_plain`` and
  ``flash_attention_dkv_plain`` at ``chip_smoke._FLASH_TOL["float32"]``,
  and against the JAX package's ``_bwd`` in interpret mode at the fp32
  parity tolerance of ``tests/test_torch_flash_attention.py``;
- its max error in dq, dk and dv against float64 over the plain fp32
  version's own: ``chip_smoke._f32_bwd_multiple(d)``
  (``_F32_FLASH_BWD_MULTIPLE`` at D 256, ``_F32_DKV_MULTIPLE`` at 64 and
  128) is at least twice the worst ratio over the truth cases and seeds,
  and at the training
  length (T = 2048 in one batch and head, at D 256 and at 64 and 128), and
  a 1xTF32 emulation (hi . hi alone) lies 10x or more beyond that bound,
  so the bound can fail;
- one accumulator over every stage tile (no groups) would leave the bound
  at the training length, which is why the kernels add groups in fp32.
"""
import torch_threads  # noqa: F401 (one torch thread a worker)
import math
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.ops.pallas.flash_attention  # noqa: F401

from paddle_tpu_torch.ops import flash_attention as fl
from test_torch_lmhead_ce_f32 import tf32_rna

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402

jfa = sys.modules["paddle_tpu.ops.pallas.flash_attention"]

_FAR = 1e30  # the kernels' lse of a row that takes no part: P = 0
_STAGE = fl.SM90_F32_D256_DQ_TILES[1]
assert fl.SM90_F32_D256_DKV_TILES[1] == _STAGE


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.float()


def _fma(a, b, c):
    """fp32 a * b + c rounded once (the product of two fp32 values is
    exact in float64)."""
    return _f32(a.double() * b.double() + c.double())


def _trunc(x64: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero: the low 29 bits of the
    float64 significand dropped (exact for the normal range the sums stay
    in)."""
    return (x64.view(torch.int64) & ~((1 << 29) - 1)).view(torch.float64) \
        .float()


def _mma(acc, a, b):
    """acc (+)= a . b^T over one 8-deep slice ([.., M, 8] . [.., N, 8]^T)
    as the tensor cores sum it: two groups of 4 exact products, the sum
    rounded toward zero after each."""
    for k in (0, 4):
        part = a[..., k:k + 4].double() @ b[..., k:k + 4].double() \
            .transpose(-1, -2)
        acc = _trunc(acc.double() + part)
    return acc


def _pair(a):
    """(hi, lo) of fp32 a: hi = tf32_rna(a), lo = tf32_rna(a - hi)."""
    hi = tf32_rna(a)
    return hi, tf32_rna(a - hi)


def _only_hi(a):
    """1xTF32: hi = tf32_rna(a), lo = 0."""
    return tf32_rna(a), torch.zeros_like(a)


def _box(a_hi, a_lo, b_hi, b_lo, x):
    """One box's chain: A (.., M, D) . B (.., N, D)^T over columns [32 x,
    32 x + 32), a new accumulator, per slice lo . hi, hi . lo, hi . hi."""
    c = torch.zeros(a_hi.shape[:-1] + (b_hi.shape[-2],))
    for kd in range(32 * x, 32 * x + 32, 8):
        ks = slice(kd, kd + 8)
        c = _mma(c, a_lo[..., ks], b_hi[..., ks])
        c = _mma(c, a_hi[..., ks], b_lo[..., ks])
        c = _mma(c, a_hi[..., ks], b_hi[..., ks])
    return c


def _scores(a, b, pair):
    """The kernels' score tile sums, A (.., M, D) . B (.., N, D)^T: a chain
    a 32-column box, ((c0 + c1) + (c2 + c3)) over each warpgroup's 128
    columns of D; at D 256 the two warpgroups' halves added, at D 128 the
    one warpgroup's sum, at D 64 its c0 + c1."""
    (a_hi, a_lo), (b_hi, b_lo) = pair(a), pair(b)
    box = [_box(a_hi, a_lo, b_hi, b_lo, x) for x in range(a.shape[-1] // 32)]
    if len(box) == 2:
        return _f32(box[0] + box[1])
    half = [_f32(_f32(box[4 * w] + box[4 * w + 1])
                 + _f32(box[4 * w + 2] + box[4 * w + 3]))
            for w in range(len(box) // 4)]
    return half[0] if len(half) == 1 else _f32(half[0] + half[1])


def _pad_rows(x, rows):
    """x (.., T, n) with zero rows up to ``rows`` (TMA's zero fill past a
    sequence's end)."""
    return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[-2]))


def _products(a, b, scale, pair):
    """sum over the stage rows r of a[r]^T b[r] -- a (.., R, M), b (.., R,
    N), R padded to stage tiles -- as (.., M, N): per 8-row slice of a
    stage tile lo_a . hi_b, hi_a . lo_b, hi_a . hi_b in one accumulator a
    group of FLUSH stage tiles; each group's sum times ``scale`` added to
    the earlier ones in fp32."""
    (a_hi, a_lo), (b_hi, b_lo) = pair(a), pair(b)
    group = _STAGE * fl.SM90_F32_BWD_FLUSH
    total = None
    for g0 in range(0, a.shape[-2], group):
        acc = torch.zeros(a.shape[:-2] + (a.shape[-1], b.shape[-1]))
        for r0 in range(g0, min(g0 + group, a.shape[-2]), 8):
            rs = slice(r0, r0 + 8)
            at_hi = a_hi[..., rs, :].transpose(-1, -2)
            at_lo = a_lo[..., rs, :].transpose(-1, -2)
            bt_hi = b_hi[..., rs, :].transpose(-1, -2)
            bt_lo = b_lo[..., rs, :].transpose(-1, -2)
            acc = _mma(acc, at_lo, bt_hi)
            acc = _mma(acc, at_hi, bt_lo)
            acc = _mma(acc, at_hi, bt_hi)
        part = _f32(acc * scale)
        total = part if total is None else _f32(total + part)
    return total


def emulate_bwd(q, k, v, do, lse, delta, causal, layout, pair=_pair,
                want=("dq", "dk", "dv")):
    """(dq, dk, dv) of the fp32 split-TF32 kernels' arithmetic on CPU
    tensors, in the layout (those not in ``want`` None), at head_dim 64,
    128 or 256. Every row runs every stage tile: a tile the kernel does
    not load (wholly above the causal diagonal) adds exact zeros here,
    which changes no bit."""
    qh, kh, vh, dh = (fl._heads_first(t, layout) for t in (q, k, v, do))
    tq, tk, d = qh.shape[2], kh.shape[2], qh.shape[3]
    scale = torch.tensor(np.float32(1 / math.sqrt(d)))
    lse_k = torch.where(lse > 0.5 * -_FAR, lse, torch.tensor(_FAR))
    keep = torch.ones((tq, tk), dtype=torch.bool)
    if causal:
        keep = keep.tril(tk - tq)

    def grads(s, dp):
        """P and dS (.., Tq, Tk) from the scores and dP."""
        x = torch.where(keep, _fma(s, scale, -lse_k[..., None]),
                        torch.tensor(-math.inf))
        p = _f32(torch.exp(x.double()))
        return p, _f32(p * _f32(dp - delta[..., None]))

    tiles = lambda t: -(-t // _STAGE) * _STAGE  # noqa: E731
    got = dict.fromkeys(("dq", "dk", "dv"))
    if "dq" in want:
        # dq's kernel: A = Q and dO, B = K and V; dQ^T = K^T dS^T over keys
        _, ds = grads(_scores(qh, kh, pair), _scores(dh, vh, pair))
        got["dq"] = _products(_pad_rows(kh, tiles(tk)),
                              _pad_rows(ds.transpose(-1, -2), tiles(tk)),
                              scale, pair)
    # dk/dv's: A = K and V, B = Q and dO; dV^T = dO^T P, dK^T = Q^T dS
    st = _scores(kh, qh, pair).transpose(-1, -2)
    dpt = _scores(vh, dh, pair).transpose(-1, -2) if "dk" in want else st
    p, ds = grads(st, dpt)
    if "dv" in want:
        got["dv"] = _products(_pad_rows(dh, tiles(tq)),
                              _pad_rows(p, tiles(tq)), torch.tensor(1.0),
                              pair)
    if "dk" in want:
        got["dk"] = _products(_pad_rows(qh, tiles(tq)),
                              _pad_rows(ds, tiles(tq)), scale, pair)
    return tuple(None if g is None else
                 fl._to_layout(g.transpose(-1, -2), layout, torch.float32)
                 for g in got.values())


def _inputs(b, h, tq, tk, layout, seed, d=256):
    """q, k, v, dO as chip_smoke's fp32 checks make them (N(0, 1), seeded),
    and the plain forward's lse and delta, which the card check feeds both
    the kernels and the plain versions."""
    q, k, v, do = chip_smoke._flash_inputs(torch, b, h, tq, tk, d,
                                           torch.float32, layout, seed,
                                           device="cpu")
    return q, k, v, do


def _want(d):
    """The gradients the case-wise tests without ``dq`` in their name hold
    at head_dim d: all three at 256, dk and dv at 64 and 128 (whose dq the
    ``test_dq_*`` and ``test_fp64_bound_holds_dq_*`` tests hold)."""
    return ("dq", "dk", "dv") if d == 256 else ("dk", "dv")


_ALL = ("dq", "dk", "dv")


def _args(q, k, v, do, causal, layout):
    out, lse = fl.flash_attention_fwd_plain(q, k, v, causal, None, layout)
    return (q, k, v, do, lse, fl.flash_attention_delta(out, do, layout),
            causal, None, layout)


# (layout, causal, B, H, Tq, Tk, D): both layouts, causal and not, Tq <
# Tk, Tq > Tk (rows that see no key), and lengths that are no multiple of
# the kernels' tiles (or of 128 rows, 320), at D 256, 64 and 128
_CASES = [
    ("BHTD", False, 1, 2, 256, 256, 256),
    ("BTHD", True, 2, 1, 256, 256, 256),
    ("BTHD", False, 1, 1, 128, 384, 256),
    ("BHTD", True, 1, 2, 128, 384, 256),
    ("BTHD", True, 1, 1, 384, 128, 256),
    ("BHTD", True, 1, 1, 333, 333, 256),
    ("BTHD", False, 1, 2, 200, 333, 256),
    ("BHTD", False, 1, 2, 256, 256, 64),
    ("BTHD", True, 2, 1, 256, 256, 128),
    ("BHTD", True, 1, 2, 128, 384, 64),
    ("BTHD", True, 1, 1, 384, 128, 128),
    ("BTHD", True, 1, 2, 320, 320, 64),
    ("BHTD", True, 1, 1, 333, 333, 128),
    ("BTHD", False, 1, 2, 200, 333, 64),
]


def _case_id(case):
    """The case's id; at head_dim 256 the one it had when every case was
    at 256, elsewhere with the head_dim."""
    layout, causal, b, h, tq, tk, d = case
    return (f"{layout}-{'causal' if causal else 'full'}-b{b}h{h}-"
            f"tq{tq}-tk{tk}" + ("" if d == 256 else f"-d{d}"))


@pytest.fixture(scope="module")
def emulated():
    """{case: (args, emulated (dq, dk, dv))} at seed 60 + the case's
    index."""
    got = {}
    for i, case in enumerate(_CASES):
        layout, causal, b, h, tq, tk, d = case
        args = _args(*_inputs(b, h, tq, tk, layout, 60 + i, d), causal,
                     layout)
        got[case] = (args, emulate_bwd(*args[:-2], layout, want=_ALL))
    return got


def _agrees_with_plain(emulated, case, want):
    args, emulation = emulated[case]
    pdk, pdv = fl.flash_attention_dkv_plain(*args)
    plain = dict(dq=fl.flash_attention_dq_plain(*args), dk=pdk, dv=pdv)
    got = dict(zip(_ALL, emulation))
    chip_smoke._flash_agrees(
        torch, {n: got[n] for n in want}, {n: plain[n] for n in want},
        "float32", f"3xTF32 emulation, {_case_id(case)}")


@pytest.mark.parametrize("case", _CASES, ids=_case_id)
def test_emulation_matches_the_plain_version(emulated, case):
    """dq (at D 256), dk and dv within chip_smoke's fp32 tolerance of the
    plain versions fed the same lse and delta."""
    _agrees_with_plain(emulated, case, _want(case[-1]))


_DQ_CASES = [c for c in _CASES if c[-1] != 256]


@pytest.mark.parametrize("case", _DQ_CASES, ids=_case_id)
def test_dq_emulation_matches_the_plain_version(emulated, case):
    """dq at head_dim 64 and 128 within chip_smoke's fp32 tolerance of the
    plain version fed the same lse and delta."""
    _agrees_with_plain(emulated, case, ("dq",))


@pytest.fixture(scope="module")
def against_jax(emulated):
    """(case) -> (the emulated (dq, dk, dv), the JAX package's), each case
    computed once, when a test first asks for it: the JAX package's
    backward kernels in interpret mode (``_bwd`` at blocks of 128), the
    emulation fed the JAX forward's out and lse."""
    got = {}

    def of(case):
        if case not in got:
            layout, causal, b, h, tq, tk, d = case
            (q, k, v, do, *_), _ = emulated[case]
            jq, jk, jv, jdo = (jnp.asarray(t.numpy()) for t in (q, k, v, do))
            bthd = layout == "BTHD"
            scale = 1.0 / np.sqrt(d)
            jout, jlse = jfa._fwd(jq, jk, jv, causal=causal, scale=scale,
                                  block_q=128, block_k=128, interpret=True,
                                  bthd=bthd)
            jgrads = jfa._bwd(causal, scale, 128, 128, True, bthd, None,
                              (jq, jk, jv, jout, jlse), jdo)
            lse = torch.from_numpy(
                np.reshape(np.asarray(jlse), (b, h, tq)).copy())
            delta = fl.flash_attention_delta(
                torch.from_numpy(np.array(jout)), do, layout)
            got[case] = (emulate_bwd(q, k, v, do, lse, delta, causal, layout,
                                     want=_ALL), jgrads)
        return got[case]

    return of


def _agrees_with_jax(against_jax, case, want):
    emulation, jgrads = against_jax(case)
    for name, g, j in zip(_ALL, emulation, jgrads):
        if name in want:
            np.testing.assert_allclose(g.numpy(), np.asarray(j),
                                       rtol=2e-4, atol=2e-4, err_msg=name)


def _jax_lengths(cases):
    """The cases whose lengths are a multiple of the JAX kernels' blocks
    of 128."""
    return [c for c in cases if c[4] % 128 == 0 and c[5] % 128 == 0]


@pytest.mark.parametrize("case", _jax_lengths(_CASES), ids=_case_id)
def test_emulation_matches_jax(against_jax, case):
    """dq (at D 256), dk and dv against the JAX package's backward kernels
    in interpret mode (``_bwd`` at blocks of 128, which need lengths that
    are a multiple of them), fed the JAX forward's out and lse, at the fp32
    gradient tolerance of ``tests/test_torch_flash_attention.py`` (2e-4)."""
    _agrees_with_jax(against_jax, case, _want(case[-1]))


@pytest.mark.parametrize("case", _jax_lengths(_DQ_CASES), ids=_case_id)
def test_dq_emulation_matches_jax(against_jax, case):
    """dq at head_dim 64 and 128 against the JAX package's ``_bwd`` in
    interpret mode, as above, at 2e-4."""
    _agrees_with_jax(against_jax, case, ("dq",))


def _ratios(case, seed, pair=_pair, want=None):
    """{name: (the plain version's error, the emulation's)} against
    float64 (``chip_smoke._flash_bwd_fp64``) for the gradients in ``want``
    (by default those the head_dim's split-TF32 kernels compute)."""
    layout, causal, b, h, tq, tk, d = case
    want = want or _want(d)
    q, k, v, do = _inputs(b, h, tq, tk, layout, seed, d)
    args = _args(q, k, v, do, causal, layout)
    truth = chip_smoke._flash_bwd_fp64(torch, q, k, v, do, causal, layout)
    pdk, pdv = fl.flash_attention_dkv_plain(*args)
    plain = dict(dq=fl.flash_attention_dq_plain(*args), dk=pdk, dv=pdv)
    got = dict(zip(("dq", "dk", "dv"), emulate_bwd(*args[:-2], layout,
                                                   pair, want)))
    return {n: (float((plain[n].double() - truth[n]).abs().max()),
                float((got[n].double() - truth[n]).abs().max()))
            for n in want}


def _bound(plain_err, d=256):
    return (chip_smoke._f32_bwd_multiple(d) * plain_err
            + chip_smoke._F32_FLASH_ATOL)


_TRUTH = chip_smoke._F32_FLASH_TRUTH_CASES


@pytest.mark.parametrize("case", _TRUTH, ids=_case_id)
def test_fp64_bound_holds_the_split_and_refuses_tf32(case):
    """The card's float64 bound, ``_f32_bwd_multiple(d)`` x the plain fp32
    version's own error + _F32_FLASH_ATOL, in dq (at D 256), dk and dv: the
    emulation lies within half of it at the seeds the card check runs and
    two more, and a 1xTF32 emulation 10x or more beyond it."""
    assert _TRUTH
    d = case[-1]
    for seed in chip_smoke._F32_FLASH_SEEDS + (7, 8):
        split = _ratios(case, seed)
        single = _ratios(case, seed, _only_hi)
        for name, (p, e) in split.items():
            assert math.isfinite(e) and e <= _bound(p, d)
            assert chip_smoke._f32_bwd_multiple(d) >= 2 * e / p, (
                name, seed, e, p)
            assert single[name][1] > 10 * _bound(p, d), (name, seed,
                                                      single[name], p)


def test_fp64_bound_holds_at_the_training_length():
    """The same bound at the fp32 head_dim-256 training shape's length,
    layout and mask (``chip_smoke._F32_FLASH_TRUTH_TRAIN_D256``: T = 2048,
    causal, BTHD), at the seed the card check runs there, in one batch and
    one head (the emulation's cost): within half of it, 16 groups of 128
    rows a key's dk and dv."""
    layout, causal, _, _, tq, tk, d = chip_smoke._F32_FLASH_TRUTH_TRAIN_D256
    assert d == 256
    ratios = _ratios((layout, causal, 1, 1, tq, tk, d),
                     chip_smoke._F32_FLASH_TRAIN_SEED)
    for name, (p, e) in ratios.items():
        assert chip_smoke._F32_FLASH_BWD_MULTIPLE >= 2 * e / p, (name, e, p)


@pytest.mark.parametrize("train", [chip_smoke._F32_FLASH_TRUTH_TRAIN,
                                   chip_smoke._F32_FLASH_TRUTH_TRAIN_D128],
                         ids=["d64", "d128"])
def test_fp64_bound_holds_dk_dv_at_the_training_length(train):
    """The same bound for the head_dim-64 and 128 dk/dv at the fp32
    training shapes' length, layout and mask (T = 2048, causal, BTHD), at
    the seed the card check runs there, in one batch and one head: within
    half of it, and a 1xTF32 emulation beyond it."""
    layout, causal, _, _, tq, tk, d = train
    assert d in (64, 128)
    case = (layout, causal, 1, 1, tq, tk, d)
    ratios = _ratios(case, chip_smoke._F32_FLASH_TRAIN_SEED)
    single = _ratios(case, chip_smoke._F32_FLASH_TRAIN_SEED, _only_hi)
    for name, (p, e) in ratios.items():
        assert chip_smoke._F32_DKV_MULTIPLE >= 2 * e / p, (name, e, p)
        assert single[name][1] > 10 * _bound(p, d), (name, single[name], p)


@pytest.mark.parametrize("case", [c for c in _TRUTH if c[-1] != 256],
                         ids=_case_id)
def test_dq_fp64_bound_holds_the_split_and_refuses_tf32(case):
    """The card's float64 bound for the dq at head_dim 64 and 128,
    ``_F32_DKV_MULTIPLE`` x the plain fp32 version's own error +
    _F32_FLASH_ATOL: the emulation lies within half of it at the seeds the
    card check runs and two more (its worst ratio 9.0, at D 64, seed 1),
    and a 1xTF32 emulation 10x or more beyond it (22x at the least)."""
    d = case[-1]
    assert chip_smoke._f32_bwd_multiple(d) == chip_smoke._F32_DKV_MULTIPLE
    for seed in chip_smoke._F32_FLASH_SEEDS + (7, 8):
        (p, e), = _ratios(case, seed, want=("dq",)).values()
        (_, e1), = _ratios(case, seed, _only_hi, want=("dq",)).values()
        assert math.isfinite(e) and e <= _bound(p, d)
        assert chip_smoke._F32_DKV_MULTIPLE >= 2 * e / p, (seed, e, p)
        assert e1 > 10 * _bound(p, d), (seed, e1, p)


@pytest.mark.parametrize("train", [chip_smoke._F32_FLASH_TRUTH_TRAIN,
                                   chip_smoke._F32_FLASH_TRUTH_TRAIN_D128],
                         ids=["d64", "d128"])
def test_fp64_bound_holds_dq_at_the_training_length(train):
    """The same bound for the head_dim-64 and 128 dq at the fp32 training
    shapes' length, layout and mask (T = 2048, causal, BTHD: 16 groups of
    128 keys in the last query rows), at the seed the card check runs
    there, in one batch and one head: within half of it (ratio 6.9 at D
    64, 3.1 at 128), and a 1xTF32 emulation beyond it."""
    layout, causal, _, _, tq, tk, d = train
    case = (layout, causal, 1, 1, tq, tk, d)
    seed = chip_smoke._F32_FLASH_TRAIN_SEED
    (p, e), = _ratios(case, seed, want=("dq",)).values()
    (_, e1), = _ratios(case, seed, _only_hi, want=("dq",)).values()
    assert chip_smoke._F32_DKV_MULTIPLE >= 2 * e / p, (e, p)
    assert e1 > 10 * _bound(p, d), (e1, p)


def test_one_accumulator_over_every_tile_would_leave_the_bound(monkeypatch):
    """Without the groups (one accumulator over all 16 groups of the
    training length's causal rows), the truncating sums put dv beyond the
    float64 bound: the groups are what keep the kernels inside it."""
    layout, causal, _, _, tq, tk, _ = chip_smoke._F32_FLASH_TRUTH_TRAIN_D256
    monkeypatch.setattr(fl, "SM90_F32_BWD_FLUSH", tq // _STAGE)
    p, e = _ratios((layout, causal, 1, 1, tq, tk, 256),
                   chip_smoke._F32_FLASH_TRAIN_SEED, want=("dv",))["dv"]
    assert e > _bound(p), (e, p)


def _ablation_tool(monkeypatch):
    """tools/torch_flash_f32_d256_bwd_ablation.py as a module."""
    import importlib.util

    tools = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "tools")
    monkeypatch.syspath_prepend(tools)
    spec = importlib.util.spec_from_file_location(
        "torch_flash_f32_d256_bwd_ablation",
        os.path.join(tools, "torch_flash_f32_d256_bwd_ablation.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _ablation_texts(tool, kernels):
    """(the shared header, {kernel: its source}) as the tool reads them."""
    with open(os.path.join(tool.CSRC, tool.HEADER)) as f:
        header = f.read()
    sources = {}
    for kernel, (source, _, _) in kernels.items():
        with open(os.path.join(tool.CSRC, source)) as f:
            sources[kernel] = f.read()
    return header, sources


def test_ablation_tool_anchors_match_the_kernels(monkeypatch):
    """tools/torch_flash_f32_d256_bwd_ablation.py edits the shared header
    and the two kernels' sources by text: each anchor (the fragments'
    load and split, the score and accumulating wgmma, the flush's staging
    and TMA, each kernel's reload) is there exactly once, each variant
    differs from the sources and from every other, and an edited anchor
    raises."""
    tool = _ablation_tool(monkeypatch)
    header, sources = _ablation_texts(tool, tool.KERNELS)
    variants = tool.variants(header, sources)
    assert variants["kernel"] == (header, sources)
    texts = {(h, tuple(s.values())) for h, s in variants.values()}
    assert len(texts) == len(variants)
    with pytest.raises(RuntimeError, match="changed"):
        tool.variants(header.replace("tma_reduce_add_3d(map",
                                     "tma_reduce_add_3d( map"), sources)
    with pytest.raises(RuntimeError, match="changed"):
        tool.variants(header, {k: s.replace("load(j + 1);", "load(j+1);")
                               for k, s in sources.items()})


@pytest.mark.parametrize("d", [64, 128])
def test_ablation_tool_anchors_match_the_head_dim_64_128_kernel(monkeypatch,
                                                                d):
    """With ``--head-dim 64`` or ``128`` the tool ablates the split-TF32
    dk/dv of those head_dims (``flash_attention_dkv_f32_sm90.cu``) through
    the same header anchors and its own reload: each variant differs from
    the source and from every other, and an edited anchor raises."""
    tool = _ablation_tool(monkeypatch)
    kernels = tool.KERNELS_BY_HEAD_DIM[d]
    assert [s for s, _, _ in kernels.values()] == [
        "flash_attention_dkv_f32_sm90.cu"]
    header, sources = _ablation_texts(tool, kernels)
    variants = tool.variants(header, sources)
    assert variants["kernel"] == (header, sources)
    texts = {(h, tuple(s.values())) for h, s in variants.values()}
    assert len(texts) == len(variants)
    with pytest.raises(RuntimeError, match="changed"):
        tool.variants(header, {k: s.replace("load(j + 1);", "load(j+1);")
                               for k, s in sources.items()})
