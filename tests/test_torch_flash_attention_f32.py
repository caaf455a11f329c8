"""The fp32 flash attention forward's split-TF32 arithmetic, emulated on the
CPU, against the port's plain version, the JAX package's kernel and
float64.

The kernels (``paddle_tpu_torch/csrc/flash_attention_fwd_f32_sm90.cu`` at
head_dim 64 and 128, ``flash_attention_fwd_f32_d256_sm90.cu`` at 256)
cannot run here, so :func:`emulate` repeats their arithmetic in torch:

- each operand split as ``a = hi + lo`` with ``hi = tf32_rna(a)`` and
  ``lo = tf32_rna(a - hi)`` (``tests/test_torch_lmhead_ce_f32.py``'s
  rounding);
- the key tiles of ``SM90_F32_FWD_TILES`` (``SM90_F32_D256_FWD_TILES``)
  in order; per tile the scores ``Q K^T`` in one new accumulator, per
  8-deep slice of D ``lo_q . hi_k``, ``hi_q . lo_k``, ``hi_q . hi_k``; at
  head_dim 256 one new accumulator per 32-column box of D, the boxes added
  in fp32 as ``((c0 + c1) + (c2 + c3))`` over each half of D (a
  warpgroup's) and the two halves added last;
- the online softmax on scores prescaled by ``scale * log2(e)`` in fp32:
  ``exp2`` of ``s - m``, masked scores -inf, the row sum of the unrounded
  P kept per thread (keys ``8 j + 2 t + {0, 1}`` of quad lane t, ``l *
  alpha + sum`` one fused multiply-add) and summed over the quad at the
  end; the output rescaled by alpha;
- the tile's ``P V`` in a new accumulator, per 8-key slice in the kernel's
  permuted order (keys 0, 2, 4, 6, 1, 3, 5, 7: the P fragment's), ``lo_p .
  hi_v``, ``hi_p . lo_v``, ``hi_p . hi_v``, added to the output in fp32
  before the next tile's rescale (at head_dim 256 ``o * alpha + P V``, one
  fused multiply-add);
- out = o * (1 / l), lse = m ln 2 + log l (one fused multiply-add).

The tensor cores' fp32 accumulation is modelled pessimistically, as that
file models it: exact products, the sum rounded toward zero after every 4
(the tensor cores of earlier generations were measured to truncate).

What is held, at a few heads, T up to 384, D 64, 128 and 256, both
layouts, causal and not, Tq != Tk, and rows that see no key:

- the emulation against ``flash_attention_fwd_plain`` at
  ``chip_smoke._FLASH_TOL["float32"]``, and against the JAX package's
  ``_fwd`` in interpret mode at the fp32 parity tolerance of
  ``tests/test_torch_flash_attention.py`` (2e-5);
- its max error in out and in lse against float64 over the plain fp32
  version's own: ``chip_smoke._F32_FLASH_MULTIPLE`` is at least twice the
  worst ratio over the cases and seeds, the training shape's length (T =
  2048) among them, and a 1xTF32 emulation (hi . hi alone) lies 10x or
  more beyond that bound, so the bound can fail;
- the wrapper hands the new entry point an aligned copy of a misaligned
  input and raises on its error codes (``tests/test_torch_flash_attention.py``
  holds the routes of both dtypes), and ``chip_smoke._sm90_kernel`` names
  each instantiation.
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
from test_torch_lmhead_ce_f32 import _round_toward_zero, tf32_rna

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402

jfa = sys.modules["paddle_tpu.ops.pallas.flash_attention"]

_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
_NEG = -1e30
_PERM = (0, 2, 4, 6, 1, 3, 5, 7)  # an 8-key slice as the kernel sums it


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.float()


def _fma(a, b, c):
    """fp32 a * b + c rounded once, as nvcc contracts it (the product of
    two fp32 values is exact in float64)."""
    return _f32(a.double() * b.double() + c.double())


def _mma(acc, a, b):
    """acc (+)= a . b^T over one 8-deep slice ([.., M, 8] . [.., N, 8]^T)
    as the tensor cores sum it: two groups of 4 exact products, the sum
    rounded toward zero after each."""
    for k in (0, 4):
        part = a[..., k:k + 4].double() @ b[..., k:k + 4].double() \
            .transpose(-1, -2)
        acc = _round_toward_zero(acc.double() + part)
    return acc


def _pair(a):
    """(hi, lo) of fp32 a: hi = tf32_rna(a), lo = tf32_rna(a - hi)."""
    hi = tf32_rna(a)
    return hi, tf32_rna(a - hi)


def _only_hi(a):
    """1xTF32: hi = tf32_rna(a), lo = 0."""
    return tf32_rna(a), torch.zeros_like(a)


def _scores(q_hi, q_lo, k_hi, k_lo, c, cols):
    """One new accumulator of a key tile's scores over ``cols`` of D."""
    s = torch.zeros(q_hi.shape[:-1] + (c.stop - c.start,))
    for kd in range(cols.start, cols.stop, 8):
        ks = slice(kd, kd + 8)
        s = _mma(s, q_lo[..., ks], k_hi[..., c, ks])
        s = _mma(s, q_hi[..., ks], k_lo[..., c, ks])
        s = _mma(s, q_hi[..., ks], k_hi[..., c, ks])
    return s


def _scores_d256(q_hi, q_lo, k_hi, k_lo, c):
    """The head_dim-256 kernel's scores of a key tile: a chain per
    32-column box, ``((c0 + c1) + (c2 + c3))`` over each warpgroup's 128
    columns, then the two warpgroups' partial sums."""
    box = [_scores(q_hi, q_lo, k_hi, k_lo, c, slice(32 * x, 32 * x + 32))
           for x in range(8)]
    half = [_f32(_f32(box[4 * w] + box[4 * w + 1])
                 + _f32(box[4 * w + 2] + box[4 * w + 3])) for w in (0, 1)]
    return _f32(half[0] + half[1])


def emulate(q, k, v, causal, layout, pair=_pair):
    """(out, lse) of the fp32 forward's arithmetic on CPU tensors: out in
    the layout, lse (B, H, Tq). Every query row runs every key tile: a
    tile the kernel does not load (wholly above the causal diagonal) is
    fully masked here, which changes no bit (alpha 1, P 0)."""
    d = q.shape[-1]
    d256 = d == 256
    bkv = (fl.SM90_F32_D256_FWD_TILES if d256
           else fl.SM90_F32_FWD_TILES[d])[1]
    qh, kh, vh = (fl._heads_first(t, layout) for t in (q, k, v))
    b, h, tq, _ = qh.shape
    tk = kh.shape[2]
    tiles = -(-tk // bkv)
    pad = (0, 0, 0, tiles * bkv - tk)  # TMA's zero fill past Tk
    kh, vh = (torch.nn.functional.pad(t, pad) for t in (kh, vh))
    (q_hi, q_lo), (k_hi, k_lo), (v_hi, v_lo) = pair(qh), pair(kh), pair(vh)
    scale_log2 = torch.tensor(np.float32(1 / math.sqrt(d))
                              * np.float32(_LOG2E))
    m = torch.full((b, h, tq), _NEG)
    lq = torch.zeros((b, h, tq, 4))  # the row sum, per quad lane
    o = torch.zeros((b, h, tq, d))
    ot = None
    rows = torch.arange(tq)[:, None]
    for j in range(tiles):
        c = slice(j * bkv, (j + 1) * bkv)
        if d256:
            s = _scores_d256(q_hi, q_lo, k_hi, k_lo, c)
        else:
            s = _scores(q_hi, q_lo, k_hi, k_lo, c, slice(0, d))
        if ot is not None:
            o = _f32(o + ot)
        cols = torch.arange(j * bkv, (j + 1) * bkv)[None, :]
        keep = cols < tk
        if causal:
            keep = keep & (cols <= rows + tk - tq)
        x = torch.where(keep, _f32(s * scale_log2), torch.tensor(-math.inf))
        m_new = torch.maximum(m, x.max(-1).values.clamp_min(_NEG))
        alpha = _f32(torch.exp2(_f32(m - m_new).double()))
        p = _f32(torch.exp2(_f32(x - m_new[..., None]).double()))
        quad = p.reshape(b, h, tq, bkv // 8, 4, 2)
        part = torch.zeros((b, h, tq, 4))
        for jj in range(bkv // 8):
            for cc in range(2):
                part = _f32(part + quad[..., jj, :, cc])
        lq = _fma(lq, alpha[..., None], part)
        m = m_new
        if not d256:
            o = _f32(o * alpha[..., None])
        p_hi, p_lo = pair(p)
        ot = torch.zeros((b, h, tq, d))
        for jj in range(0, bkv, 8):
            keys = [jj + t for t in _PERM]
            vt_hi = v_hi[..., c, :][..., keys, :].transpose(-1, -2)
            vt_lo = v_lo[..., c, :][..., keys, :].transpose(-1, -2)
            ot = _mma(ot, p_lo[..., keys], vt_hi)
            ot = _mma(ot, p_hi[..., keys], vt_lo)
            ot = _mma(ot, p_hi[..., keys], vt_hi)
        if d256:
            o, ot = _fma(o, alpha[..., None], ot), None
    if ot is not None:
        o = _f32(o + ot)
    l = _f32(_f32(lq[..., 0] + lq[..., 1]) + _f32(lq[..., 2] + lq[..., 3]))
    seen = l > 0
    inv = torch.where(seen, _f32(1.0 / l.double()), torch.zeros_like(l))
    lse = torch.where(seen, _fma(m, torch.tensor(_LN2, dtype=torch.float32),
                                 _f32(torch.log(l.double()))),
                      torch.tensor(_NEG))
    return fl._to_layout(_f32(o * inv[..., None]), layout,
                         torch.float32), lse


def _inputs(b, h, tq, tk, d, layout, seed):
    """q, k, v as chip_smoke's fp32 checks make them (N(0, 1), seeded)."""
    q, k, v, _ = chip_smoke._flash_inputs(torch, b, h, tq, tk, d,
                                          torch.float32, layout, seed,
                                          device="cpu")
    return q, k, v


# (layout, causal, B, H, Tq, Tk, D): both layouts, causal and not, D 64,
# 128 and 256, Tq < Tk, Tq > Tk (rows that see no key), and lengths that
# are no multiple of the kernel's tiles
_CASES = [
    ("BHTD", False, 1, 2, 256, 256, 64),
    ("BTHD", True, 2, 2, 256, 256, 64),
    ("BTHD", False, 1, 2, 128, 128, 128),
    ("BHTD", True, 1, 2, 384, 384, 128),
    ("BHTD", True, 1, 2, 128, 384, 64),
    ("BTHD", True, 1, 2, 384, 128, 128),
    ("BTHD", True, 1, 3, 200, 200, 64),
    ("BHTD", False, 1, 2, 333, 300, 128),
    ("BHTD", False, 1, 2, 128, 128, 256),
    ("BTHD", True, 1, 2, 256, 256, 256),
    ("BTHD", False, 1, 1, 128, 256, 256),
    ("BHTD", True, 1, 2, 128, 384, 256),
    ("BTHD", True, 1, 1, 384, 128, 256),
    ("BHTD", True, 1, 1, 333, 333, 256),
    ("BTHD", False, 1, 2, 200, 333, 256),
]


def _case_id(case):
    layout, causal, b, h, tq, tk, d = case
    return (f"{layout}-{'causal' if causal else 'full'}-b{b}h{h}-"
            f"tq{tq}-tk{tk}-d{d}")


@pytest.fixture(scope="module")
def emulated():
    """{case: (q, k, v, emulated (out, lse))} at seed 40 + the case's
    index."""
    got = {}
    for i, case in enumerate(_CASES):
        layout, causal, b, h, tq, tk, d = case
        q, k, v = _inputs(b, h, tq, tk, d, layout, 40 + i)
        got[case] = (q, k, v, emulate(q, k, v, causal, layout))
    return got


@pytest.mark.parametrize("case", _CASES, ids=_case_id)
def test_emulation_matches_the_plain_version(emulated, case):
    """out and lse within chip_smoke's fp32 tolerance of the plain
    version; the rows that see no key exactly 0 and -1e30."""
    layout, causal, b, h, tq, tk, d = case
    q, k, v, (out, lse) = emulated[case]
    ref_out, ref_lse = fl.flash_attention_fwd_plain(q, k, v, causal, None,
                                                    layout)
    what = f"3xTF32 emulation, {_case_id(case)}"
    chip_smoke._flash_agrees(torch, dict(out=out, lse=lse),
                             dict(out=ref_out, lse=ref_lse), "float32", what)
    chip_smoke._no_key_rows_agree(dict(out=out, lse=lse), causal, layout, tq,
                                  tk, what)


@pytest.mark.parametrize("case", [c for c in _CASES
                                  if c[4] % 128 == 0 and c[5] % 128 == 0],
                         ids=_case_id)
def test_emulation_matches_jax(emulated, case):
    """out and lse against the JAX package's forward kernel in interpret
    mode (``_fwd`` at blocks of 128, which need lengths that are a multiple
    of them), at the fp32 parity tolerance 2e-5."""
    layout, causal, b, h, tq, tk, d = case
    q, k, v, (out, lse) = emulated[case]
    jout, jlse = jfa._fwd(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                          causal=causal, scale=1.0 / np.sqrt(d),
                          block_q=128, block_k=128, interpret=True,
                          bthd=layout == "BTHD")
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(lse.numpy(),
                               np.reshape(np.asarray(jlse), lse.shape),
                               rtol=2e-5, atol=2e-5)


def _ratios(case, seed):
    """(split's, 1xTF32's) errors over the plain version's, against
    float64, each (out, lse): ``chip_smoke._flash_fp64_errs``."""
    layout, causal, b, h, tq, tk, d = case
    q, k, v = _inputs(b, h, tq, tk, d, layout, seed)
    own = chip_smoke._flash_fp64_errs(
        torch, *fl.flash_attention_fwd_plain(q, k, v, causal, None, layout),
        q, k, v, causal, layout)
    split = chip_smoke._flash_fp64_errs(
        torch, *emulate(q, k, v, causal, layout), q, k, v, causal, layout)
    single = chip_smoke._flash_fp64_errs(
        torch, *emulate(q, k, v, causal, layout, _only_hi), q, k, v, causal,
        layout)
    return own, split, single


def _bound_holds(case, seeds):
    """At each seed: the emulation's ratio to the plain version's error is
    half _F32_FLASH_MULTIPLE or less, so the emulation passes the card's
    float64 bound, and a 1xTF32 emulation lies 10x or more beyond it."""
    for seed in seeds:
        own, split, single = _ratios(case, seed)
        for name, p, e, s in zip(("out", "lse"), own, split, single):
            bound = (chip_smoke._F32_FLASH_MULTIPLE * p
                     + chip_smoke._F32_FLASH_ATOL)
            assert chip_smoke._F32_FLASH_MULTIPLE >= 2 * e / p, (name, seed,
                                                                  e, p)
            assert e <= bound and math.isfinite(e)
            assert s >= 10 * bound, (name, seed, s, bound)


@pytest.mark.parametrize("case", chip_smoke._F32_FLASH_TRUTH_CASES,
                         ids=_case_id)
def test_fp64_bound_holds_the_split_and_refuses_tf32(case):
    """The card's float64 bound, _F32_FLASH_MULTIPLE x the plain fp32
    version's own error in out and in lse + _F32_FLASH_ATOL, over the seeds
    the card check runs and two more."""
    _bound_holds(case, chip_smoke._F32_FLASH_SEEDS + (7, 8))


def test_fp64_bound_holds_at_the_training_length():
    """The same bound at the fp32 training shape's length, layout, mask and
    head_dim (``chip_smoke._F32_FLASH_TRUTH_TRAIN``: T = 2048, causal,
    BTHD, D = 64), at the seed the card check runs there and one more, in
    one batch and one head (the emulation's cost): 64 key tiles a row
    keep the emulation's error within half the multiple."""
    layout, causal, _, _, tq, tk, d = chip_smoke._F32_FLASH_TRUTH_TRAIN
    _bound_holds((layout, causal, 1, 1, tq, tk, d),
                 (chip_smoke._F32_FLASH_TRAIN_SEED, 7))


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("layout", ["BHTD", "BTHD"])
def test_fp32_forward_clones_a_misaligned_input_and_raises(monkeypatch, d,
                                                           layout):
    """An fp32 q whose pointer is not 16-byte aligned (a view at an odd
    offset) reaches ``flash_attn_fwd_f32_sm90`` (at head_dim 256
    ``flash_attn_fwd_f32_d256_sm90``) as an aligned copy, as TMA needs; an
    error code raises naming the entry point and is not counted
    (``tests/test_torch_flash_attention.py`` holds the routes and the
    tensor-map geometry)."""
    from paddle_tpu_torch.ops import _build

    calls = []

    class Lib:
        err = 0

        def __getattr__(self, name):
            def call(*args):
                calls.append((name, args))
                return self.err
            return call

    lib = Lib()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    shape = (1, 70, 2, d) if layout == "BTHD" else (1, 2, 70, d)
    q = torch.zeros(int(np.prod(shape)) + 1)[1:].view(shape)
    assert q.data_ptr() % 16
    k = torch.zeros(shape)
    entry = "flash_attn_fwd_f32_d256_sm90" if d == 256 else \
        "flash_attn_fwd_f32_sm90"
    fl.reset_launches()
    fl._launch_fwd(q, k, k, True, 0.125, layout)
    (name, args), = calls
    assert name == entry and fl.fwd_launches == 1
    assert all(a % 16 == 0 for a in args[:3])
    lib.err = -3
    with pytest.raises(RuntimeError, match=f"{entry}.*-3"):
        fl._launch_fwd(k, k, k, True, 0.125, layout)
    assert fl.fwd_launches == 1


def test_smoke_finds_the_fp32_forward_by_name():
    """chip_smoke.py maps each instantiation of the fp32 forward (at
    head_dim 64 and 128, and its head_dim-256 kernel) to exactly one
    ``_SM90_KERNELS`` key in the build's SASS and ptxas report, and none
    of the bf16 forwards' or the fp32 CE forward's to it; a device trace
    charges each to the flash forward."""
    from types import SimpleNamespace

    space = "_ZN58_GLOBAL__N__a6c4b388_33_{}_cu_46558d5b"
    f32 = space.format("flash_attention_fwd_f32_sm90")
    names = {
        f32 + "20flash_fwd_f32_kernelILi64EEEv14CUtensorMap_stS1_S1_"
              "NS_6ParamsE": "flash_attention_fwd_f32_d64",
        f32 + "20flash_fwd_f32_kernelILi128EEEv14CUtensorMap_stS1_S1_"
              "NS_6ParamsE": "flash_attention_fwd_f32_d128",
        space.format("flash_attention_fwd_sm90")
        + "15fwd_sm90_kernelILi64EEEv14CUtensorMap_stS1_S1_NS_6ParamsE":
            "flash_attention_fwd_d64",
        space.format("lmhead_ce_fwd_f32_sm90")
        + "19fwd_f32_sm90_kernelEv14CUtensorMap_stS0_PKxPfS3_S3_iiii":
            "lmhead_ce_fwd_f32",
        space.format("flash_attention_fwd_f32_d256_sm90")
        + "24fwd_f32_d256_sm90_kernelE14CUtensorMap_stS0_S0_NS_6ParamsE":
            "flash_attention_fwd_f32_d256",
        space.format("flash_attention_fwd_d256_sm90")
        + "20fwd_d256_sm90_kernelE14CUtensorMap_stS0_S0_NS_6ParamsE":
            "flash_attention_fwd_d256"}
    for mangled, want in names.items():
        assert chip_smoke._sm90_kernel(mangled) == want, mangled
        hits = [key for key, parts in chip_smoke._SM90_KERNELS.items()
                if all(p in mangled for p in parts)]
        assert hits == [want], (mangled, hits)

    event = SimpleNamespace(
        name="void (anonymous namespace)::flash_fwd_f32_kernel<64>"
             "(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
             "(anonymous namespace)::Params)",
        device_type=torch.autograd.DeviceType.CUDA, is_user_annotation=False,
        time_range=SimpleNamespace(elapsed_us=lambda: 500.0))
    d256 = SimpleNamespace(
        name="void (anonymous namespace)::fwd_f32_d256_sm90_kernel("
             "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
             "(anonymous namespace)::Params)",
        device_type=torch.autograd.DeviceType.CUDA, is_user_annotation=False,
        time_range=SimpleNamespace(elapsed_us=lambda: 250.0))
    _, device_ms, ours, families, _ = chip_smoke._kernel_tally(
        torch, [event, d256])
    assert ours["flash_attention_fwd"] == {"calls": 2,
                                           "ms": pytest.approx(0.75)}
    assert ours["lmhead_ce_fwd"]["calls"] == 0 and families == {}
