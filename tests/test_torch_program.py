"""The port's static program IR against the JAX package's.

The tiny GPT train program (2 layers, 2 heads, d 32, vocab 128, seq 16,
batch 2; both loss paths) is built in both packages under a fresh
unique-name generator, before and after ``Adam.minimize``: the op type
sequence, every op's input/output wiring and attrs (the build-site
callstack aside), every variable's name, shape, dtype and flags, and the
parameter and accumulator names must be the same. The comparison is
exact: it is structure, not arithmetic -- with one mapping: JAX runs
without 64-bit types here, so its shape inference writes int32 where an
op's int64 input flows through (``reshape2`` of the int64 labels); the
port keeps int64, and the comparison reads int64 as int32 on both sides
(the feeds themselves are int64 in both). ``clone()`` (a desc copy; the
port has no protobuf) must give an equal program, as must a parse of the
serialized program (``framework/_proto.py``).
"""
import torch_threads  # noqa: F401 (one torch thread a worker)
import numpy as np
import pytest

import paddle_tpu as pd
from paddle_tpu.framework import program_guard as jguard
from paddle_tpu.framework import unique_name as jnames
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.optimizer import Adam as JAdam

from paddle_tpu_torch import errors
from paddle_tpu_torch.framework import core, program_guard, unique_name
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.optimizer import Adam
from torch_modes import static_mode  # noqa: F401 (autouse fixture)

_CFG = dict(vocab_size=128, n_layer=2, n_head=2, d_model=32, max_seq_len=16)


def _jax_build(impl, minimize):
    pd.enable_static()
    try:
        with jnames.guard():
            cfg = jgpt.GPTConfig(**_CFG, fused_lm_head=impl)
            main, startup, io = jgpt.build_train_program(cfg, 2, 16)
            if minimize:
                with jguard(main, startup):
                    JAdam(learning_rate=1e-3).minimize(io["loss"])
        return main, startup
    finally:
        pd.disable_static()


def _torch_build(impl, minimize):
    with unique_name.guard():
        cfg = tgpt.GPTConfig(**_CFG, fused_lm_head=impl)
        main, startup, io = tgpt.build_train_program(cfg, 2, 16)
        if minimize:
            with program_guard(main, startup):
                Adam(learning_rate=1e-3).minimize(io["loss"])
    return main, startup


def _jattrs(op):
    return {k: v for k, v in op.all_attrs().items() if k != "op_callstack"}


def _ops(prog, attrs=_jattrs):
    return [(op.type,
             sorted((slot, tuple(op.input(slot))) for slot in op.input_names),
             sorted((slot, tuple(op.output(slot)))
                    for slot in op.output_names),
             attrs(op))
            for op in prog.global_block().ops]


_X64_OFF = {"int64": "int32", "float64": "float32"}


def _vars(prog, dtype_name):
    return {v.name: (tuple(v.shape),
                     _X64_OFF.get(dtype_name(v.dtype), dtype_name(v.dtype)),
                     v.persistable, v.stop_gradient)
            for v in prog.list_vars()}


def _same_program(jprog, tprog):
    jops, tops = _ops(jprog), _ops(tprog)
    assert [o[0] for o in tops] == [o[0] for o in jops]
    for j, t in zip(jops, tops):
        assert t == j, (t[0], t, j)
    assert (_vars(tprog, core.dtype_name)
            == _vars(jprog, lambda d: np.dtype(d).name))
    assert (sorted(p.name for p in tprog.all_parameters())
            == sorted(p.name for p in jprog.all_parameters()))


@pytest.mark.parametrize("minimize", [False, True])
@pytest.mark.parametrize("impl", ["pallas", "off"])
def test_gpt_train_program_matches_jax(impl, minimize):
    jmain, jstart = _jax_build(impl, minimize)
    tmain, tstart = _torch_build(impl, minimize)
    _same_program(jmain, tmain)
    _same_program(jstart, tstart)
    if minimize:
        accs = sorted(v.name for v in tmain.list_vars()
                      if v.persistable and "_moment" in v.name)
        assert "gpt.wte_moment1_0" in accs and "gpt.wte_moment2_0" in accs
        types = [op.type for op in tmain.global_block().ops]
        assert types.count("adam") == len(tmain.all_parameters())
        # the tied embedding gets its two partial grads summed
        assert types.count("sum") >= 1


def test_clone_copies_descs_and_serialization_waits():
    tmain, _ = _torch_build("pallas", True)
    clone = tmain.clone()
    assert _ops(clone) == _ops(tmain)
    assert _vars(clone, core.dtype_name) == _vars(tmain, core.dtype_name)
    assert ([p.name for p in clone.all_parameters()]
            == [p.name for p in tmain.all_parameters()])
    # a copy, not a view: editing the clone leaves the original alone
    clone.global_block().ops[0]._set_attr("padding_idx", 3)
    assert tmain.global_block().ops[0].attr("padding_idx") is None
    assert clone._extra_feeds.keys() == tmain._extra_feeds.keys()
    test_prog = tmain.clone(for_test=True)
    attn = [op for op in test_prog.global_block().ops
            if op.type == "fused_attention_tpu"]
    assert attn and all(op.attr("is_test") for op in attn)
    # serialization is ported (the name is from when it raised): a parse
    # of the serialized program is the program
    parsed = type(tmain).parse_from_string(tmain.serialize_to_string())
    assert _ops(parsed) == _ops(tmain)
    assert _vars(parsed, core.dtype_name) == _vars(tmain, core.dtype_name)
    with pytest.raises(errors.InvalidArgument):
        type(tmain).parse_from_string(b"\x0a\x05")
