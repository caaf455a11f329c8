"""The port's ProgramDesc codec (``framework/_proto.py``: the
``framework.proto`` wire format without protobuf) against the JAX
package's protobuf one.

- Programs: the tiny GPT training program (2 layers, 2 heads, d 32,
  vocab 128, seq 16, batch 2, Adam), built in each package, and an eval
  program (the GPT forward cloned ``for_test``) with one more op that
  carries every ``AttrType`` (a FLOAT and a sub-block among them).
- Bytes the JAX package wrote parse in the port, and bytes the port
  wrote parse in the JAX package (``Program.parse_from_string``), to
  equal programs: blocks, every op's type, slots and typed attributes,
  every var's type, dtype, dims and flags. The port writes back the
  JAX package's bytes unchanged (stronger than required).
- The same Python value gets the same ``AttrType`` in both packages.
- Malformed bytes raise ``InvalidArgument`` in the port; the JAX
  package refuses the same samples, but for two it accepts (``_STRICTER``).
- ``save_inference_model`` / ``load_inference_model``: a model saved by
  either package loads in the other and gives the saver's logits at
  rtol 1e-5 (fp32; same startup values, copied).
"""
import torch_threads  # noqa: F401 (one torch thread a worker)
import numpy as np
import pytest

import paddle_tpu as pd
from paddle_tpu.framework import Executor as JExecutor
from paddle_tpu.framework import Scope as JScope
from paddle_tpu.framework import program as jprogram
from paddle_tpu.framework import program_guard as jguard
from paddle_tpu.framework import unique_name as jnames
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.optimizer import Adam as JAdam
from paddle_tpu.static import io as jio

from paddle_tpu_torch import errors, static
from paddle_tpu_torch.framework import (CPUPlace, Executor, Program, Scope,
                                        _proto, program_guard, unique_name)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.weights import scope_from_numpy
from torch_modes import static_mode  # noqa: F401 (autouse fixture)

_CFG = dict(vocab_size=128, n_layer=2, n_head=2, d_model=32, max_seq_len=16)
_B, _T = 2, 16
# one value of every AttrType but FLOAT (no Python value writes it: the
# probe op below sets it on the desc) and BLOCK/BLOCKS (sub-blocks)
_PROBE_ATTRS = {
    "i": 7, "i_neg": -3, "l": 2 ** 40, "f64": 0.1, "s": "text",
    "ints": [1, -2, 3], "longs": [2 ** 35, 1], "floats": [0.5, 0.1],
    "strings": ["a", "bc"], "b": True, "bools": [True, False], "empty": [],
}


def _jax_gpt(minimize, for_test=False):
    pd.enable_static()
    try:
        with jnames.guard():
            cfg = jgpt.GPTConfig(**_CFG, fused_lm_head="off")
            main, startup, io = jgpt.build_train_program(cfg, _B, _T)
            if minimize:
                with jguard(main, startup):
                    JAdam(learning_rate=1e-3).minimize(io["loss"])
        if for_test:
            main = main.clone(for_test=True)
        return main, startup, io
    finally:
        pd.disable_static()


def _torch_gpt(minimize, for_test=False):
    with unique_name.guard():
        cfg = tgpt.GPTConfig(**_CFG, fused_lm_head="off")
        main, startup, io = tgpt.build_train_program(cfg, _B, _T)
        if minimize:
            with program_guard(main, startup):
                Adam(learning_rate=1e-3).minimize(io["loss"])
    if for_test:
        main = main.clone(for_test=True)
    return main, startup, io


def _jax_probe():
    """The JAX package's eval GPT program with an op of every attr type,
    two sub-blocks among its attrs."""
    main, _, _ = _jax_gpt(False, for_test=True)
    sub1 = main._create_block()
    main._rollback()
    sub2 = main._create_block()
    main._rollback()
    blk = main.global_block()
    op = jprogram.Operator(blk, "attr_probe", attrs=dict(
        _PROBE_ATTRS, blk=sub1, blks=[sub1, sub2]), do_infer=False)
    a = op.desc.attrs.add()
    a.name, a.type, a.f = "f32", jprogram.fpb.FLOAT, 0.25
    blk.ops.append(op)
    blk.desc.ops.append(op.desc)
    return main


def _jtyped(op):
    return {a.name: (a.type, jprogram._get_attr(a)) for a in op.desc.attrs}


def _ttyped(op):
    return {n: (op.desc.attr_types.get(n, _proto.attr_type(v)), v)
            for n, v in op.desc.attrs.items()}


def _jvar(v):
    d = v.desc
    kind = _proto.ENUM_TO_KIND[d.type.type]
    td = (d.type.dense_tensor if kind == "dense_tensor"
          else d.type.selected_rows if kind == "selected_rows" else None)
    tensor = ((_proto.ENUM_TO_DTYPE[td.data_type], tuple(td.dims))
              if td is not None and td.ByteSize() else None)
    return (kind, tensor, d.persistable, d.stop_gradient, d.is_parameter,
            d.need_check_feed, tuple(d.dims_mapping))


def _tvar(v):
    d = v.desc
    tensor = ((d.dtype, d.dims) if d.type in ("dense_tensor", "selected_rows")
              else None)
    return (d.type, tensor, d.persistable, d.stop_gradient, d.is_parameter,
            d.need_check_feed, tuple(d.dims_mapping))


def _jview(prog):
    return [((b.idx, b.parent_idx, b.desc.forward_block_idx),
             {n: _jvar(v) for n, v in b.vars.items()},
             [(op.type, [(p.parameter, list(p.arguments))
                         for p in op.desc.inputs],
               [(p.parameter, list(p.arguments)) for p in op.desc.outputs],
               _jtyped(op)) for op in b.ops]) for b in prog.blocks]


def _tview(prog):
    return [((b.idx, b.parent_idx, b.desc.forward_block_idx),
             {n: _tvar(v) for n, v in b.vars.items()},
             [(op.type, [(p, list(a)) for p, a in op.desc.inputs],
               [(p, list(a)) for p, a in op.desc.outputs],
               _ttyped(op)) for op in b.ops]) for b in prog.blocks]


def _jax_programs():
    return {"gpt_train": _jax_gpt(True)[0], "eval_every_attr": _jax_probe()}


@pytest.mark.parametrize("name", ["gpt_train", "eval_every_attr"])
def test_jax_bytes_parse_in_the_port(name):
    jprog = _jax_programs()[name]
    data = jprog.serialize_to_string()
    tprog = Program.parse_from_string(data)
    assert _tview(tprog) == _jview(jpd_parse(data))
    assert len(tprog.blocks) == (3 if name == "eval_every_attr" else 1)
    # the port writes the JAX package's bytes back unchanged
    assert tprog.serialize_to_string() == data


def jpd_parse(data):
    return jprogram.Program.parse_from_string(data)


@pytest.mark.parametrize("for_test", [False, True])
def test_port_bytes_parse_in_the_jax_package(for_test):
    tprog = _torch_gpt(not for_test, for_test)[0]
    data = tprog.serialize_to_string()
    parsed = Program.parse_from_string(data)
    assert _jview(jpd_parse(data)) == _tview(parsed)
    # the parse gives the program that was written (float lists in
    # float32, as the wire holds them)
    view = _tview(tprog)
    for (_, _, ops), (_, _, got) in zip(view, _tview(parsed)):
        for op, g in zip(ops, got):
            assert op[:3] == g[:3]
            assert {n: (t, np.float32(v).tolist() if t == _proto.FLOATS
                        else v) for n, (t, v) in op[3].items()} == g[3]
    assert parsed.serialize_to_string() == data


def test_same_value_same_attr_type():
    for name, value in _PROBE_ATTRS.items():
        a = jprogram.fpb.OpDesc.Attr()
        jprogram._set_attr(a, value)
        assert _proto.attr_type(value) == a.type, name


def test_a_block_attr_keeps_its_type():
    """BLOCK, BLOCKS and FLOAT attrs (types a value alone would not give
    back) keep their type through the port; a new value drops it."""
    tprog = Program.parse_from_string(_jax_probe().serialize_to_string())
    probe = tprog.global_block().ops[-1]
    assert probe.desc.attr_types == {"blk": _proto.BLOCK,
                                     "blks": _proto.BLOCKS,
                                     "f32": _proto.FLOAT}
    assert (probe.attr("blk"), probe.attr("blks"), probe.attr("f32")) == (
        1, [1, 2], 0.25)
    probe._set_attr("blk", 2)
    assert "blk" not in probe.desc.attr_types
    back = jpd_parse(tprog.serialize_to_string()).global_block().ops[-1]
    assert _jtyped(back)["blk"] == (jprogram.fpb.INT, 2)
    assert _jtyped(back)["blks"] == (jprogram.fpb.BLOCKS, [1, 2])


def _malformed():
    good = _jax_gpt(False)[0].serialize_to_string()

    def field(num, wire, payload=b""):
        return bytes([(num << 3) | wire]) + payload

    block_no_idx = field(1, 2, bytes([2]) + field(2, 0, b"\x00"))
    return {
        "truncated": good[:-7],
        "garbage": b"\xff\xff\xff",
        "length_past_end": field(1, 2, b"\x7f") + b"\x00",
        "wire_type_7": field(1, 7),
        "block_without_idx": block_no_idx,
        "bad_utf8_op_type": field(1, 2, bytes([9]) + field(1, 0, b"\x00")
                                  + field(2, 0, b"\x00") + field(4, 2, b"\x03"
                                  + field(3, 2, b"\x01\xff"))),
        "varint_too_long": field(1, 0, b"\xff" * 11),
    }


# the JAX package's protobuf parser accepts these two (a proto2 string is
# not checked for UTF-8, and a missing required field reads as its
# default); the port refuses them (ROADMAP.md, differences kept on purpose)
_STRICTER = ("bad_utf8_op_type", "block_without_idx")


@pytest.mark.parametrize("case", sorted(_malformed()))
def test_malformed_bytes_raise_invalid_argument(case):
    data = _malformed()[case]
    with pytest.raises(errors.InvalidArgument,
                       match="malformed ProgramDesc"):
        Program.parse_from_string(data)
    if case in _STRICTER:
        jpd_parse(data)
    else:
        with pytest.raises(Exception):
            jpd_parse(data)


def _feed():
    return np.random.RandomState(3).randint(
        0, _CFG["vocab_size"], (_B, _T)).astype(np.int64)


def _jax_logits_and_scope():
    main, startup, io = _jax_gpt(False)
    pd.enable_static()
    try:
        exe, scope = JExecutor(), JScope()
        exe.run(startup, scope=scope)
        feed = {"tokens": _feed(), "labels": _feed()}
        logits = exe.run(main, feed=feed, fetch_list=[io["logits"]],
                         scope=scope)[0]
        return main, io, exe, scope, np.asarray(logits)
    finally:
        pd.disable_static()


def test_inference_model_saved_by_jax_loads_in_the_port(tmp_path):
    main, io, exe, scope, want = _jax_logits_and_scope()
    pd.enable_static()
    try:
        jio.save_inference_model(str(tmp_path), ["tokens"], [io["logits"]],
                                 exe, main, scope=scope)
    finally:
        pd.disable_static()
    texe, tscope = Executor(CPUPlace()), Scope()
    prog, feeds, fetches = static.load_inference_model(
        str(tmp_path), texe, scope=tscope)
    assert feeds == ["tokens"] and [v.name for v in fetches] == [
        io["logits"].name]
    got = texe.run(prog, feed={"tokens": _feed()}, fetch_list=fetches,
                   scope=tscope)[0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_inference_model_saved_by_the_port_loads_in_jax(tmp_path):
    jmain, _, _, jscope, _ = _jax_logits_and_scope()
    main, _, io = _torch_gpt(False)
    values = {v.name: np.asarray(jscope.get(v.name))
              for v in jmain.list_vars() if v.persistable
              and jscope.get(v.name) is not None}
    exe, scope = Executor(CPUPlace()), Scope()
    scope_from_numpy(values, scope, "cpu")
    want = exe.run(main, feed={"tokens": _feed(), "labels": _feed()},
                   fetch_list=[io["logits"]], scope=scope)[0]
    saved = static.save_inference_model(str(tmp_path), ["tokens"],
                                        [io["logits"]], exe, main,
                                        scope=scope)
    assert saved == [io["logits"].name]
    pd.enable_static()
    try:
        jscope2 = JScope()
        prog, feeds, fetches = jio.load_inference_model(
            str(tmp_path), JExecutor(), scope=jscope2)
        got = JExecutor().run(prog, feed={"tokens": _feed()},
                              fetch_list=fetches, scope=jscope2)[0]
    finally:
        pd.disable_static()
    assert feeds == ["tokens"]
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-6)
    # the pruned program keeps the logits' ops only: no loss, no labels
    assert "softmax_with_cross_entropy" not in [
        op.type for op in prog.global_block().ops]
