"""The port's static-graph GPT training against the JAX package's.

A tiny GPT train program (2 layers, 2 heads, d 32, vocab 128, seq 16,
batch 2) is built in both packages with ``Adam.minimize``. The JAX
startup program fills the JAX scope; every persistable (parameters, Adam
moments and beta powers) goes as numpy into the port's scope through
``weights.scope_from_numpy``, so both start from the same values (random
streams are never matched). Both then run 3 steps on the same batch.

Tolerances (fp32): every step's loss at rtol 1e-4, every parameter and
Adam moment after the steps at atol 1e-5 -- both packages run the same
fp32 arithmetic in another order (XLA fuses, the port runs op by op).
The key projection's bias gets a gradient that is rounding noise alone
(softmax ignores a per-row constant), and Adam turns that noise into a
step of size up to ~lr * |g| / eps; at lr 1e-3 it stays below 1e-5.
One bf16 step: loss at rtol 2e-2 and parameters at atol 2e-2 -- bf16
rounds at other places in the two frameworks (XLA keeps fused
intermediates in fp32, PyTorch rounds each op's output). AdamW and SGD
are held against the JAX package in ``test_torch_optimizer.py``.

The flash GPT (2 layers, 2 heads, d 128 so that head_dim is 64, vocab
256, seq 128, batch 2) runs with ``PADDLE_TPU_FLASH_MIN_SEQ=128``, so
that attention takes the flash kernels in both packages (the JAX
package's pallas kernels in interpret mode, the port's plain versions),
at the same tolerances, with Adam's epsilon at 1e-5. One ``gpt.wte``
gradient of its batch cancels to ~1e-10 (the median is 2.6e-3), and
there Adam's first step, lr * g / (|g| + eps), turns the two packages'
rounding noise (~6e-9, as large with einsum attention in both) into a
step difference of up to lr * 6e-9 / eps: 4.7e-5 at the default eps
1e-8 even at lr 1e-4, 6.5e-7 at eps 1e-5 and lr 1e-3, while the
parameters move by up to 3e-3.
"""
import torch_threads  # noqa: F401 (one torch thread a worker)
import numpy as np
import pytest

import paddle_tpu as pd
from paddle_tpu.framework import Executor as JExecutor
from paddle_tpu.framework import Scope as JScope
from paddle_tpu.framework import program_guard as jguard
from paddle_tpu.framework import unique_name as jnames
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.optimizer import Adam as JAdam

from paddle_tpu_torch.framework import CPUPlace, Executor, Scope
from paddle_tpu_torch.framework import program_guard, unique_name
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.weights import scope_from_numpy
from torch_modes import static_mode  # noqa: F401 (autouse fixture)

_CFG = dict(vocab_size=128, n_layer=2, n_head=2, d_model=32, max_seq_len=16)
_FLASH_CFG = dict(vocab_size=256, n_layer=2, n_head=2, d_model=128,
                  max_seq_len=128)
_B = 2


def _batch(seed=0, cfg=_CFG):
    r = np.random.RandomState(seed)
    shape = (_B, cfg["max_seq_len"])
    return {"tokens": r.randint(0, cfg["vocab_size"], shape).astype(np.int64),
            "labels": r.randint(0, cfg["vocab_size"], shape).astype(np.int64)}


def _jax_run(impl, dtype, steps, feed, cfg_kw=_CFG, eps=1e-8):
    """(losses, {name: np.ndarray} before the steps, after the steps)."""
    pd.enable_static()
    try:
        with jnames.guard():
            cfg = jgpt.GPTConfig(**cfg_kw, dtype=dtype, fused_lm_head=impl)
            main, startup, io = jgpt.build_train_program(
                cfg, _B, cfg_kw["max_seq_len"])
            with jguard(main, startup):
                JAdam(learning_rate=1e-3, epsilon=eps).minimize(io["loss"])
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        scope, exe = JScope(), JExecutor()
        exe.run(startup, scope=scope)
        start = {n: np.asarray(scope.get(n)) for n in names}
        losses = [float(exe.run(main, feed=feed, fetch_list=[io["loss"]],
                                scope=scope)[0]) for _ in range(steps)]
        end = {n: np.asarray(scope.get(n)) for n in names}
        return losses, start, end
    finally:
        pd.disable_static()


def _torch_run(impl, dtype, steps, feed, start, cfg_kw=_CFG, eps=1e-8):
    with unique_name.guard():
        cfg = tgpt.GPTConfig(**cfg_kw, dtype=dtype, fused_lm_head=impl)
        main, startup, io = tgpt.build_train_program(
            cfg, _B, cfg_kw["max_seq_len"])
        with program_guard(main, startup):
            Adam(learning_rate=1e-3, epsilon=eps).minimize(io["loss"])
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    assert names == sorted(start)
    scope = scope_from_numpy(start, Scope(), "cpu")
    exe = Executor(CPUPlace())
    losses = [float(exe.run(main, feed=feed, fetch_list=[io["loss"]],
                            scope=scope)[0]) for _ in range(steps)]
    end = {n: scope.get(n).float().numpy() for n in names}
    return losses, end


@pytest.mark.parametrize("impl", ["pallas", "off"])
def test_three_fp32_steps_match_jax(impl):
    feed = _batch()
    jl, start, jend = _jax_run(impl, "float32", 3, feed)
    tl, tend = _torch_run(impl, "float32", 3, feed, start)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    moments = [n for n in jend if "_moment" in n]
    assert len(moments) == 2 * len([n for n in jend if n.startswith("gpt.")
                                    and "_" not in n.split(".")[-1]])
    for name in jend:
        np.testing.assert_allclose(tend[name], jend[name].astype(np.float32),
                                   atol=1e-5, rtol=0, err_msg=name)


def test_one_bf16_step_matches_jax():
    feed = _batch(1)
    jl, start, jend = _jax_run("pallas", "bfloat16", 1, feed)
    tl, tend = _torch_run("pallas", "bfloat16", 1, feed, start)
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    for name in jend:
        np.testing.assert_allclose(tend[name], jend[name].astype(np.float32),
                                   atol=2e-2, rtol=0, err_msg=name)


def _flash_counts():
    from paddle_tpu.ops import attention as jattention

    from paddle_tpu_torch.ops import attention as tattention

    return jattention.FLASH_DISPATCH_COUNT, tattention.FLASH_DISPATCH_COUNT


@pytest.fixture
def flash_at_128(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_SEQ", "128")
    monkeypatch.delenv("PADDLE_TPU_DISABLE_FLASH", raising=False)
    before = _flash_counts()
    yield
    after = _flash_counts()
    assert after[0] > before[0] and after[1] > before[1], (before, after)


def test_flash_gpt_three_fp32_steps_match_jax(flash_at_128):
    feed = _batch(2, _FLASH_CFG)
    jl, start, jend = _jax_run("pallas", "float32", 3, feed, _FLASH_CFG, 1e-5)
    tl, tend = _torch_run("pallas", "float32", 3, feed, start, _FLASH_CFG,
                          1e-5)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    for name in jend:
        np.testing.assert_allclose(tend[name], jend[name].astype(np.float32),
                                   atol=1e-5, rtol=0, err_msg=name)


def test_flash_gpt_one_bf16_step_matches_jax(flash_at_128):
    feed = _batch(3, _FLASH_CFG)
    jl, start, jend = _jax_run("pallas", "bfloat16", 1, feed, _FLASH_CFG,
                               1e-5)
    tl, tend = _torch_run("pallas", "bfloat16", 1, feed, start, _FLASH_CFG,
                          1e-5)
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    for name in jend:
        np.testing.assert_allclose(tend[name], jend[name].astype(np.float32),
                                   atol=2e-2, rtol=0, err_msg=name)
