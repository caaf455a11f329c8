"""The port's fused Adam(W) against the JAX package's.

Two references, on the same numpy state:
- the JAX pallas kernel ``fused_adam(..., interpret=True)`` (as its own
  tests run it on the CPU), for the 2-D tile-aligned params it takes;
- the JAX ``adam``/``adamw`` op lowering (its jnp rule, which the JAX
  package runs for every param off the TPU), for every shape, 1-D and
  odd ones included, with the beta-pow outputs.
The port's side is its ``adam``/``adamw`` op lowering, which calls the
kernel wrapper; on CPU tensors the wrapper runs the plain version (the
CUDA kernel is held against it on the card by ``chip_smoke.py``).

Tolerances: m, v and fp32 p at rtol 1e-6 / atol 1e-6 (the same fp32
update; AdamW's decay term is grouped differently in the jnp rule); bf16
p within one bf16 ulp (rtol 2^-7: both sides round one fp32 value, and
a last-bit difference of that value may round the other way).
"""
import torch_threads  # noqa: F401 (one torch thread a worker)
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu.framework import registry as jreg
from paddle_tpu.ops.pallas.fused_adam import fused_adam as jax_fused_adam

from paddle_tpu_torch.framework import registry as treg
from paddle_tpu_torch.ops import fused_adam as fa

_LR, _B1P, _B2P = 1e-3, 0.9 ** 3, 0.999 ** 3


def _state(shape, seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(*shape).astype(np.float32),
            (0.1 * r.randn(*shape)).astype(np.float32),
            (0.01 * r.randn(*shape)).astype(np.float32),
            np.abs(0.01 * r.randn(*shape)).astype(np.float32))


def _attrs(op):
    attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
    if op == "adamw":
        attrs.update(coeff=0.01, with_decay=True)
    return attrs


def _ins(p, g, m, v, to, pdt):
    return {"Param": [to(p, pdt)], "Grad": [to(g, pdt)],
            "Moment1": [to(m, None)], "Moment2": [to(v, None)],
            "LearningRate": [to(np.float32(_LR), None)],
            "Beta1Pow": [to(np.array([_B1P], np.float32), None)],
            "Beta2Pow": [to(np.array([_B2P], np.float32), None)]}


def _jax_to(a, dt):
    return jnp.asarray(a, jnp.bfloat16 if dt == "bf16" else jnp.float32)


def _torch_to(a, dt):
    t = torch.from_numpy(np.array(a, np.float32))
    return t.to(torch.bfloat16) if dt == "bf16" else t


def _torch_op(op, p, g, m, v, pdt):
    ins = _ins(p, g, m, v, _torch_to, pdt)
    out = treg.get_op_def(op).lower(treg.LoweringContext("cpu"), ins,
                                    _attrs(op))
    # in place: the outputs are the input tensors themselves
    assert out["ParamOut"] is ins["Param"][0]
    assert out["Moment1Out"] is ins["Moment1"][0]
    assert out["Moment2Out"] is ins["Moment2"][0]
    return {k: t.float().numpy() for k, t in out.items()}


def _close(got, want, name, bf16_p):
    rtol = 2.0 ** -7 if (bf16_p and name == "ParamOut") else 1e-6
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol,
                               atol=1e-6, err_msg=name)


@pytest.mark.parametrize("op,pdt,shape", [
    ("adam", "f32", (16, 256)), ("adam", "bf16", (16, 256)),
    ("adamw", "f32", (16, 256)), ("adamw", "bf16", (16, 256)),
])
def test_matches_the_pallas_kernel(op, pdt, shape):
    p, g, m, v = _state(shape)
    got = _torch_op(op, p, g, m, v, pdt)
    po, mo, vo = jax_fused_adam(
        _jax_to(p, pdt), _jax_to(g, pdt), jnp.asarray(m), jnp.asarray(v),
        _LR, _B1P, _B2P, weight_decay=0.01 if op == "adamw" else 0.0,
        interpret=True)
    for name, want in (("ParamOut", po), ("Moment1Out", mo),
                       ("Moment2Out", vo)):
        _close(got[name], want, name, pdt == "bf16")


@pytest.mark.parametrize("op,pdt,shape", [
    ("adam", "f32", (16, 256)), ("adam", "bf16", (32, 128)),
    ("adam", "f32", (768,)), ("adam", "f32", (7, 100)),
    ("adamw", "f32", (7, 100)), ("adamw", "bf16", (100,)),
])
def test_matches_the_reference_op_rule(op, pdt, shape):
    """Every output slot of the op, the beta powers included."""
    p, g, m, v = _state(shape, seed=1)
    got = _torch_op(op, p, g, m, v, pdt)
    want = jreg.get_op_def(op).lower(jreg.LoweringContext(), _ins(
        p, g, m, v, _jax_to, pdt), _attrs(op))
    assert sorted(got) == sorted(want)
    for name in want:
        _close(got[name], want[name], name, pdt == "bf16")
    np.testing.assert_allclose(got["Beta1PowOut"], [_B1P * 0.9], rtol=1e-6)
    np.testing.assert_allclose(got["Beta2PowOut"], [_B2P * 0.999], rtol=1e-6)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    p, g, m, v = (torch.from_numpy(a) for a in _state((4, 8)))
    lr, b1p, b2p = (torch.tensor([x]) for x in (_LR, _B1P, _B2P))
    with pytest.raises(TypeError):
        fa.fused_adam(p, g.bfloat16(), m, v, lr, b1p, b2p)
    with pytest.raises(TypeError):
        fa.fused_adam(p, g, m.double(), v, lr, b1p, b2p)
    with pytest.raises(ValueError, match="shape"):
        fa.fused_adam(p, g[:2], m, v, lr, b1p, b2p)
    with pytest.raises(ValueError, match="lr"):
        fa.fused_adam(p, g, m, v, torch.zeros(2), b1p, b2p)
    with pytest.raises(ValueError, match="contiguous"):
        fa.fused_adam(p.t(), g.t(), m.t(), v.t(), lr, b1p, b2p)
    meta = [t.to("meta") for t in (p, g, m, v, lr, b1p, b2p)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.fused_adam(*meta)
