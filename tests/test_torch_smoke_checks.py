"""The fused Adam check of ``chip_smoke.py`` (``_adam_agrees``) on the
CPU, where the plain version stands in for the kernel: the plain step
passes, and each altered step fails -- p rounded toward zero instead of
to nearest even, the weight-decay term dropped, lr off by 1e-4, and m
off by 3e-5 (three times m's rtol of 1e-5). The inputs are the card
check's own (``_adam_inputs``), at a small size."""
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
