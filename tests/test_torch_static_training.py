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
"""
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

_CFG = dict(vocab_size=128, n_layer=2, n_head=2, d_model=32, max_seq_len=16)
_B, _T = 2, 16


def _batch(seed=0):
    r = np.random.RandomState(seed)
    return {"tokens": r.randint(0, 128, (_B, _T)).astype(np.int64),
            "labels": r.randint(0, 128, (_B, _T)).astype(np.int64)}


def _jax_run(impl, dtype, steps, feed):
    """(losses, {name: np.ndarray} before the steps, after the steps)."""
    pd.enable_static()
    try:
        with jnames.guard():
            cfg = jgpt.GPTConfig(**_CFG, dtype=dtype, fused_lm_head=impl)
            main, startup, io = jgpt.build_train_program(cfg, _B, _T)
            with jguard(main, startup):
                JAdam(learning_rate=1e-3).minimize(io["loss"])
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


def _torch_run(impl, dtype, steps, feed, start):
    with unique_name.guard():
        cfg = tgpt.GPTConfig(**_CFG, dtype=dtype, fused_lm_head=impl)
        main, startup, io = tgpt.build_train_program(cfg, _B, _T)
        with program_guard(main, startup):
            Adam(learning_rate=1e-3).minimize(io["loss"])
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
