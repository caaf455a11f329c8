"""Each ported op lowering and its gradient against the JAX package's.

One case per (op, dtype): the same numpy inputs go into a one-op program
in each package; ``gradients(target, inputs, target_gradients=[cot])``
appends the generic ``<op>_grad`` (a fed random cotangent, so that a
normalizing op's gradient is not trivially zero), and each package's
executor runs forward and backward (the port on ``CPUPlace``; a kernel's
plain version there). Tolerances: fp32 outputs and gradients at rtol =
atol = 1e-5 (the same fp32 arithmetic in another order); bf16 at the
``check_grad`` rule of ``tests/op_test.py``: relative error at most 1e-2
against ``max(|a|, |b|, 1e-3)`` (bf16 rounds at other places in the two
frameworks: a one-ulp flip is 0.4-0.8%). ``bf16r`` (gelu): the port
runs bf16 and the reference runs the same bf16 values in fp32, because
the reference's bf16 gelu backward rounds inside the formula and lands
up to 9% off the exact gradient (the port's, fp32 inside, 0.4%; see
``ROADMAP.md`` queue C).

The ``flash_*`` cases run ``fused_attention_tpu`` with
``PADDLE_TPU_FLASH_MIN_SEQ`` lowered to their sequence length, so that
both packages take their flash kernels (the JAX package's pallas kernels
in interpret mode, the port's plain versions on the CPU) and both
dispatch counters rise. Their bf16 case is held at rtol = atol = 2e-2,
the bound of ``tests/test_flash_attention.py:39``: the TPU kernel's
online softmax rounds P against the running row max, the port's plain
version the normalized P, so small outputs differ by more than the
relative rule above allows. Every other case keeps its rule above.
"""
import zlib

import numpy as np
import pytest

import jax.numpy as jnp

import paddle_tpu as pd
from paddle_tpu import framework as jfw

from paddle_tpu_torch import framework as tfw

# options of a case that takes flash attention in both packages
_FLASH = dict(env={"PADDLE_TPU_FLASH_MIN_SEQ": "128"}, flash=True,
              bf16_tol=2e-2)

_CASES = {
    # name: (op, inputs {slot: [shape | (shape, "int", high)]}, attrs,
    #        target output slot or None, slots to differentiate, dtypes
    #        [, _FLASH: env, dispatch counters and bf16 bound])
    "elementwise_add": ("elementwise_add", {"X": [(2, 3, 4)], "Y": [(3, 4)]},
                        {"axis": -1}, "Out", ["X", "Y"], ["f32", "bf16"]),
    "gelu": ("gelu", {"X": [(4, 8)]}, {"approximate": False}, "Out", ["X"],
             ["f32", "bf16r"]),
    "scale": ("scale", {"X": [(3, 5)]}, {"scale": 1.5, "bias": 0.25,
                                         "bias_after_scale": True},
              "Out", ["X"], ["f32"]),
    "matmul": ("matmul", {"X": [(2, 3, 4)], "Y": [(4, 5)]},
               {"transpose_X": False, "transpose_Y": False, "alpha": 1.0},
               "Out", ["X", "Y"], ["f32", "bf16"]),
    "matmul_transpose_y": ("matmul", {"X": [(2, 3, 4)], "Y": [(6, 4)]},
                           {"transpose_X": False, "transpose_Y": True,
                            "alpha": 0.5}, "Out", ["X", "Y"], ["f32"]),
    "matmul_v2": ("matmul_v2", {"X": [(3, 4)], "Y": [(5, 4)]},
                  {"trans_x": False, "trans_y": True}, "Out", ["X", "Y"],
                  ["f32"]),
    "mean": ("mean", {"X": [(3, 5)]}, {}, "Out", ["X"], ["f32"]),
    "sum": ("sum", {"X": [(3, 4), (3, 4), (3, 4)]}, {}, "Out", ["X"],
            ["f32"]),
    "layer_norm": ("layer_norm", {"X": [(2, 3, 8)], "Scale": [(8,)],
                                  "Bias": [(8,)]},
                   {"epsilon": 1e-5, "begin_norm_axis": 2}, "Y",
                   ["X", "Scale", "Bias"], ["f32", "bf16"]),
    "softmax_with_cross_entropy": (
        "softmax_with_cross_entropy",
        {"Logits": [(4, 10)], "Label": [((4, 1), "int", 10)]},
        {"soft_label": False, "ignore_index": -100, "axis": -1}, "Loss",
        ["Logits"], ["f32"]),
    "lookup_table_v2": ("lookup_table_v2",
                        {"W": [(10, 6)], "Ids": [((2, 3), "int", 10)]}, {},
                        "Out", ["W"], ["f32", "bf16"]),
    "cast": ("cast", {"X": [(3, 4)]}, {"out_dtype": "bfloat16"}, "Out",
             ["X"], ["f32"]),
    "reshape2": ("reshape2", {"X": [(2, 3, 4)]}, {"shape": [0, -1]}, "Out",
                 ["X"], ["f32"]),
    "transpose2": ("transpose2", {"X": [(2, 3, 4)]}, {"axis": [1, 0, 2]},
                   "Out", ["X"], ["f32"]),
    "slice": ("slice", {"Input": [(5, 4)]},
              {"axes": [0], "starts": [1], "ends": [4]}, "Out", ["Input"],
              ["f32"]),
    "fill_constant": ("fill_constant", {},
                      {"shape": [2, 3], "value": 0.5, "dtype": "float32"},
                      None, [], ["f32"]),
    "fill_zeros_like": ("fill_zeros_like", {"X": [(2, 3)]}, {}, None, [],
                        ["f32"]),
    "sgd": ("sgd", {"Param": [(3, 4)], "Grad": [(3, 4)],
                    "LearningRate": [()]}, {}, None, [], ["f32"]),
    "attention_bthd": ("fused_attention_tpu",
                       {"Q": [(2, 8, 2, 4)], "K": [(2, 8, 2, 4)],
                        "V": [(2, 8, 2, 4)]},
                       {"is_causal": True, "dropout_p": 0.0, "is_test": False,
                        "layout": "BTHD"}, "Out", ["Q", "K", "V"],
                       ["f32", "bf16"]),
    "attention_bhtd": ("fused_attention_tpu",
                       {"Q": [(2, 2, 8, 4)], "K": [(2, 2, 8, 4)],
                        "V": [(2, 2, 8, 4)]},
                       {"is_causal": True, "dropout_p": 0.0, "is_test": False,
                        "layout": "BHTD"}, "Out", ["Q", "K", "V"], ["f32"]),
    "flash_attention_bthd": ("fused_attention_tpu",
                             {"Q": [(2, 128, 2, 64)], "K": [(2, 128, 2, 64)],
                              "V": [(2, 128, 2, 64)]},
                             {"is_causal": True, "dropout_p": 0.0,
                              "is_test": False, "layout": "BTHD"}, "Out",
                             ["Q", "K", "V"], ["f32", "bf16"], _FLASH),
    "flash_attention_bhtd": ("fused_attention_tpu",
                             {"Q": [(2, 2, 128, 64)], "K": [(2, 2, 128, 64)],
                              "V": [(2, 2, 128, 64)]},
                             {"is_causal": True, "dropout_p": 0.0,
                              "is_test": False, "layout": "BHTD"}, "Out",
                             ["Q", "K", "V"], ["f32"], _FLASH),
    "fused_lm_head_ce": ("fused_lm_head_ce",
                         {"X": [(2, 4, 8)], "W": [(16, 8)],
                          "Label": [((2, 4), "int", 16)]},
                         {"impl": "pallas", "chunk_size": 4096}, "Loss",
                         ["X", "W"], ["f32"]),
}

_PARAMS = [pytest.param(name, dt, id=f"{name}-{dt}")
           for name, case in _CASES.items() for dt in case[5]]


def _round_bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _inputs(name, dt):
    """{slot: [(var name, np.ndarray)]} for one case, from a fixed seed."""
    _, ins, *_ = _CASES[name]
    r = np.random.RandomState(zlib.crc32(name.encode()) % 1000)
    out = {}
    for slot, specs in ins.items():
        vals = []
        for i, spec in enumerate(specs):
            if isinstance(spec, tuple) and len(spec) == 3 and spec[1] == "int":
                arr = r.randint(0, spec[2], spec[0]).astype(np.int64)
            else:
                arr = np.asarray(r.randn(*spec), np.float32)
                if slot == "LearningRate":
                    arr = np.asarray(0.1, np.float32)
                elif dt != "f32":  # values both sides hold exactly
                    arr = _round_bf16(arr)
            vals.append((f"{slot.lower()}_{i}", arr))
        out[slot] = vals
    return out


def _build_and_run(fw, exe, name, dt, ins, to_feed, bf16_name):
    """Build the one-op program in package ``fw`` and run it: (outputs,
    grads) as float32 numpy."""
    op_type, _, attrs, target, diff = _CASES[name][:5]
    main, startup = fw.Program(), fw.Program()
    feed = {}
    with fw.program_guard(main, startup):
        block = main.global_block()
        in_vars = {}
        for slot, vals in ins.items():
            vs = []
            for vname, arr in vals:
                is_f = arr.dtype.kind == "f"
                dtype = bf16_name if (is_f and dt != "f32"
                                      and slot != "LearningRate") else \
                    arr.dtype.name
                vs.append(block.create_var(name=vname, shape=arr.shape,
                                           dtype=dtype))
                feed[vname] = to_feed(arr, dtype)
            in_vars[slot] = vs
        out_slots = {"layer_norm": ["Y", "Mean", "Variance"],
                     "softmax_with_cross_entropy": ["Softmax", "Loss"],
                     "sgd": ["ParamOut"], "fused_lm_head_ce": ["Loss"]}
        outs = {s: [block.create_var(name=f"{s.lower()}_out")]
                for s in out_slots.get(op_type, ["Out"])}
        block.append_op(op_type, inputs=in_vars, outputs=outs, attrs=attrs)
        fetch = [v for vs in outs.values() for v in vs]
        if target is not None:
            t = outs[target][0]
            r = np.random.RandomState(7)
            cot_arr = _round_bf16(np.asarray(r.randn(*t.shape), np.float32))
            cot = block.create_var(name="cot", shape=t.shape, dtype=t.dtype)
            feed["cot"] = to_feed(cot_arr, cot.dtype)
            grads = fw.gradients([t], [v for s in diff for v in in_vars[s]],
                                 target_gradients=[cot])
            fetch += grads
    scope = fw.Scope()
    res = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    return [np.asarray(a, dtype=np.float32) for a in res]


def _jax(name, dt, ins):
    pd.enable_static()
    try:
        return _build_and_run(
            jfw, jfw.Executor(), name, "f32" if dt == "bf16r" else dt, ins,
            lambda a, d: a.astype(jnp.bfloat16) if str(d) == "bfloat16"
            else a, "bfloat16")
    finally:
        pd.disable_static()


def _torch(name, dt, ins):
    import torch

    def to_feed(a, d):
        if tfw.core.dtype_name(d) == "bfloat16":
            return torch.from_numpy(a).to(torch.bfloat16)
        return a

    return _build_and_run(tfw, tfw.Executor(tfw.CPUPlace()), name, dt, ins,
                          to_feed, "bfloat16")


def _close(got, want, dt, what, bf16_tol=None):
    if dt == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=what)
        return
    if bf16_tol is not None:
        np.testing.assert_allclose(got, want, rtol=bf16_tol, atol=bf16_tol,
                                   err_msg=what)
        return
    denom = np.maximum(np.maximum(np.abs(got), np.abs(want)), 1e-3)
    rel = np.abs(got - want) / denom
    assert rel.max() <= 1e-2, (what, float(rel.max()))


def _dispatch_counts():
    from paddle_tpu.ops import attention as jattention

    from paddle_tpu_torch.ops import attention as tattention

    return jattention.FLASH_DISPATCH_COUNT, tattention.FLASH_DISPATCH_COUNT


@pytest.mark.parametrize("name,dt", _PARAMS)
def test_op_and_grad_match_jax(monkeypatch, name, dt):
    opts = _CASES[name][6] if len(_CASES[name]) > 6 else {}
    for key, value in opts.get("env", {}).items():
        monkeypatch.setenv(key, value)
    if opts.get("flash"):
        monkeypatch.delenv("PADDLE_TPU_DISABLE_FLASH", raising=False)
    before = _dispatch_counts()
    ins = _inputs(name, dt)
    want = _jax(name, dt, ins)
    got = _torch(name, dt, ins)
    if opts.get("flash"):
        after = _dispatch_counts()
        assert after[0] > before[0] and after[1] > before[1], (before, after)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (name, i, g.shape, w.shape)
        _close(g, w, dt, f"{name} {dt} fetch #{i}", opts.get("bf16_tol"))
