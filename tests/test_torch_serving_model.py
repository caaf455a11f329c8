"""The port's DecodeModel against the JAX package's, on the CPU.

Both packages get the SAME numpy parameters at the tiny serving config
of tests/test_serving.py and are driven with the same tokens and block
tables. The parameters are not ``init_params``' (std 0.02 weights, unit
norms, zero biases): at that scale the tiny model's activations are so
small that, for example, a tanh GELU passes for the exact one. Here
every weight, bias and norm is random at O(1) activation scale. Tolerances: 1e-5 on the KV pages and 1e-4
on NLL and logits, the fp32 round-off of two frameworks summing in their
own order through two layers. Block 0 of the pages is excluded: it is
the scratch block that padded and inactive rows all write, where
duplicate writes leave an arbitrary winner in either framework.
"""
import torch_threads  # noqa: F401 (one torch thread a worker)
import numpy as np
import pytest

import torch

from paddle_tpu import serving as jserving
from paddle_tpu_torch import errors
from paddle_tpu_torch import serving as tserving

_CFG = dict(vocab_size=128, n_layer=2, n_head=2, d_model=32, max_seq_len=64)
_ENV = dict(max_batch=4, n_blocks=16, block_size=8, prefill_buckets=[16, 32])


def rich_params(seed=1):
    """init_params' names and shapes, every value random at a scale
    that keeps each layer's activations O(1)."""
    r = np.random.RandomState(seed)
    out = {}
    for name, a in jserving.init_params(jserving.GPTConfig(**_CFG),
                                        seed).items():
        if name.endswith(".scale"):
            v = 1.0 + 0.2 * r.randn(*a.shape)
        elif name.endswith((".b", ".bias")):
            v = 0.2 * r.randn(*a.shape)
        elif name in ("gpt.wte", "gpt.wpe"):
            v = 0.5 * r.randn(*a.shape)
        else:  # [d_in, d_out]
            v = r.randn(*a.shape) / np.sqrt(a.shape[0])
        out[name] = v.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def models():
    params = rich_params()
    jm = jserving.DecodeModel(jserving.GPTConfig(**_CFG), params=params,
                              **_ENV)
    tm = tserving.DecodeModel(tserving.GPTConfig(**_CFG), params=params,
                              device="cpu", **_ENV)
    return jm, tm


def _pages(p):
    a = p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
    return a[:, :, 1:]  # block 0 is scratch


def _prompts():
    r = np.random.RandomState(4)
    return [r.randint(1, 128, size=n).astype(np.int32) for n in (13, 27)]


def test_init_params_are_the_jax_packages():
    a = jserving.init_params(jserving.GPTConfig(**_CFG), seed=3)
    b = tserving.init_params(tserving.GPTConfig(**_CFG), seed=3)
    assert a.keys() == b.keys()
    for name in a:
        np.testing.assert_array_equal(a[name], b[name])


def test_prefill_then_decode_match(models):
    """Prefill's first token and K/V pages, then decode ticks' tokens and
    pages, for two requests in their own blocks."""
    jm, tm = models
    jp, tp = jm.init_pages(), tm.init_pages()
    blocks = [[1, 2, 3, 4], [5, 6, 7, 8]]
    firsts = []
    for prompt, ids in zip(_prompts(), blocks):
        jp, jt = jm.prefill(jp, prompt, len(prompt), ids)
        tp, tt = tm.prefill(tp, prompt, len(prompt), ids)
        assert jt == tt
        firsts.append(tt)
        np.testing.assert_allclose(_pages(tp), _pages(jp),
                                   rtol=1e-5, atol=1e-5)

    tables = np.zeros((4, jm.max_blocks_per_req), np.int32)
    tables[0, :4], tables[2, :4] = blocks[0], blocks[1]
    lens = np.zeros(4, np.int32)
    lens[0], lens[2] = 13, 27
    toks = np.zeros(4, np.int32)
    toks[0], toks[2] = firsts
    for _ in range(3):
        jp, jn = jm.decode(jp, tables, lens, toks)
        tp, tn = tm.decode(tp, tables, lens, toks)
        assert tn.dtype == np.int32 and tn.shape == (4,)
        np.testing.assert_array_equal(tn[[0, 2]], np.asarray(jn)[[0, 2]])
        np.testing.assert_allclose(_pages(tp), _pages(jp),
                                   rtol=1e-5, atol=1e-5)
        lens[[0, 2]] += 1
        toks = tn


def test_score_matches(models):
    jm, tm = models
    for prompt in _prompts():
        jn, jtot = jm.score(prompt)
        tn, ttot = tm.score(prompt)
        assert tn.shape == (len(prompt) - 1,)
        np.testing.assert_allclose(tn, jn, rtol=1e-4, atol=1e-4)
        assert ttot == pytest.approx(jtot, rel=1e-4, abs=1e-4)
        assert ttot == pytest.approx(float(tn.sum()), rel=1e-5)


def test_full_logits_match(models):
    jm, tm = models
    prompt = _prompts()[1]
    got = tm.full_logits(prompt)
    assert got.shape == (1, len(prompt), _CFG["vocab_size"])
    np.testing.assert_allclose(got, jm.full_logits(prompt),
                               rtol=1e-4, atol=1e-4)


def test_envelope_errors(models):
    _, tm = models
    assert tm.bucket_for(16) == 16 and tm.bucket_for(17) == 32
    assert tm.bucket_for(33) is None
    with pytest.raises(errors.InvalidArgument):
        tm.score(np.arange(1, 40))
    with pytest.raises(NotImplementedError):
        tserving.DecodeModel(tserving.GPTConfig(**_CFG), recipe="tp",
                             device="cpu", **_ENV)
    # the analytic cost record answers where no XLA cost insight exists
    assert tm.decode_roofline(2.0)["program"] == tm.insights[
        "decode"].key_hash


def test_warm_runs_every_path_on_one_scratch_block(models, monkeypatch):
    """warm(full=True) runs decode and every prefill bucket once, on its
    own one-block page set (so every write lands in scratch block 0)."""
    _, tm = models
    seen = []
    for name in ("prefill", "decode"):
        real = getattr(tm, name)

        def spy(pages, *args, _real=real, _name=name):
            seen.append((_name, pages.shape[2],
                         tm.bucket_for(args[1]) if _name == "prefill"
                         else None))
            return _real(pages, *args)

        monkeypatch.setattr(tm, name, spy)
    tm.warm(full=True)
    assert seen == [("decode", 1, None), ("prefill", 1, 16),
                    ("prefill", 1, 32)]


def test_calibrate_on_cpu():
    cal = tserving.calibrate(n=32, copy_mb=1, device="cpu")
    assert set(cal) == {"flops_per_sec", "bytes_per_sec", "dispatch_s"}
    assert all(v > 0 and np.isfinite(v) for v in cal.values())
