"""The fluid path of the port against the JAX package: a reference-style
script, ``CompiledProgram``, the static builders and the static
``Variable``'s overloads.

- The fluid LeNet script of ``chip_smoke.py``'s ``fluid_lenet`` phase
  (``fluid.layers.conv2d``/``pool2d``/``fc``, the overloads ``h + h *
  0.5``, ``-x`` and ``loss * 1.0``, ``fluid.layers.accuracy``, Adam) is
  built in both packages under ``unique_name.guard()``; the JAX
  startup values go into the port (``weights.scope_from_numpy``), and 3
  steps on fake MNIST batches (``vision.datasets.MNIST(backend="fake")``
  through ``io.DataLoader``) run in the port through ``Executor.run`` and
  through ``CompiledProgram(main).with_data_parallel(...)`` on the staged
  (replayed) route: the two agree bit for bit, and both agree with the
  JAX package's ``Executor.run`` at 1e-4 (losses, accuracy, every
  persistable).
- ``with_data_parallel`` over two places raises ``Unimplemented`` naming
  A10; the ``fluid`` dataset names raise naming A12; ``while_loop`` and
  ``cond`` raise naming A11.
- Each static builder the port adds gives the JAX package's ops (types,
  wiring, attrs) and variables.
- The overloads: with every comparison between Variables made to raise,
  the port builds the gpt2s train program (12 layers, its op count
  unchanged from the build without the overloads, no ``equal`` op), the
  recompute, clip and decay programs, the static AMP rewrite, the fluid
  LeNet and a ``jit`` capture.
"""
import torch_threads  # noqa: F401 (one torch thread a worker)
import os
import sys

import numpy as np
import pytest

import paddle_tpu as pd
from paddle_tpu import fluid as jfluid

import paddle_tpu_torch as pt
from paddle_tpu_torch import errors, io, vision
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.framework import Scope, program_guard, unique_name
from paddle_tpu_torch.framework.program import Variable
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.weights import scope_from_numpy
from test_torch_program import _ops, _vars
from torch_modes import static_mode  # noqa: F401 (autouse fixture)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

_B = 16


def _lenet(fluid, pkg, batch=_B):
    """``chip_smoke.py``'s fluid_lenet script, in either package."""
    return chip_smoke._fluid_lenet_program(fluid, pkg, batch)


def _batches(n):
    ds = vision.datasets.MNIST(mode="train", backend="fake")
    dl = io.DataLoader(ds, batch_size=_B, shuffle=False, drop_last=True)
    out = []
    for batch in dl:
        out.append({"img": np.asarray(batch[0]),
                    "label": np.asarray(batch[1])})
        if len(out) == n:
            return out


def _reference_lenet(batches):
    pd.enable_static()
    try:
        main, startup, loss, acc = _lenet(jfluid, pd)
        scope, exe = jfluid.Scope(), jfluid.Executor()
        exe.run(startup, scope=scope)
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        start = {n: np.asarray(scope.get(n)) for n in names}
        fetched = [exe.run(main, feed=b, fetch_list=[loss, acc], scope=scope)
                   for b in batches]
        return start, fetched, {n: np.asarray(scope.get(n)) for n in names}
    finally:
        pd.disable_static()


def _port_lenet(start, batches, compiled):
    main, _, loss, acc = _lenet(tfluid, pt)
    scope = scope_from_numpy(start, Scope(), "cpu")
    exe = tfluid.Executor(tfluid.CPUPlace())
    prog = main
    if compiled:
        exe.staged = True  # the card's replayed route, on the CPU
        prog = tfluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name)
    fetched = [exe.run(prog, feed=b, fetch_list=[loss, acc], scope=scope)
               for b in batches]
    if compiled:
        assert exe.phases["replay"] >= 1
    return fetched, {n: scope.get(n).numpy() for n in start}


def test_fluid_lenet_compiled_equals_plain_and_the_reference():
    batches = _batches(3)
    start, jfetch, jafter = _reference_lenet(batches)
    plain, pafter = _port_lenet(start, batches, compiled=False)
    comp, cafter = _port_lenet(start, batches, compiled=True)
    for p, c in zip(plain, comp):
        assert [np.asarray(a).tobytes() for a in p] == \
            [np.asarray(a).tobytes() for a in c]
    for n in pafter:
        np.testing.assert_array_equal(cafter[n], pafter[n], err_msg=n)
    for (pl, pa), (jl, ja) in zip(plain, jfetch):
        np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(pa, ja, rtol=1e-4, atol=1e-4)
    for n, want in jafter.items():
        np.testing.assert_allclose(pafter[n], want, rtol=1e-4, atol=1e-4,
                                   err_msg=n)


def test_with_data_parallel_over_two_places_names_a10():
    main, _, loss, _ = _lenet(tfluid, pt)
    cp = tfluid.CompiledProgram(main, tfluid.BuildStrategy())
    with pytest.raises(errors.Unimplemented, match="A10"):
        cp.with_data_parallel(loss_name=loss.name,
                              places=[tfluid.CPUPlace(), tfluid.CPUPlace()])
    one = cp.with_data_parallel(loss_name=loss.name,
                                exec_strategy=tfluid.ExecutionStrategy(),
                                places=[tfluid.CPUPlace()])
    assert one._unwrap() is main


@pytest.mark.parametrize("name", ["DatasetFactory", "InMemoryDataset",
                                  "QueueDataset"])
def test_fluid_dataset_names_a12(name):
    with pytest.raises(errors.Unimplemented, match="A12"):
        getattr(tfluid, name)()


@pytest.mark.parametrize("name", ["while_loop", "cond"])
def test_static_control_flow_names_a11(name):
    x = pt.static.data("x", [2], "float32")
    with pytest.raises(errors.Unimplemented, match="A11"):
        if name == "cond":
            pt.static.nn.cond(x, lambda: x, lambda: x)
        else:
            pt.static.nn.while_loop(lambda v: v, lambda v: v, [x])


def _fc(nn, x):
    return nn.fc(x, 5, num_flatten_dims=1, act="relu")


_BUILDERS = {
    "fc": lambda nn, x: _fc(nn, x),
    "fc_no_bias_flatten_2": lambda nn, x: nn.fc(x, 3, num_flatten_dims=2,
                                                bias_attr=False),
    "embedding": lambda nn, x: nn.embedding(
        nn.data("ids", [2, 3], "int64"), [10, 4], padding_idx=1),
    "conv2d": lambda nn, x: nn.conv2d(x, 4, 3, stride=2, padding=1,
                                      act="relu"),
    "conv2d_groups_no_bias": lambda nn, x: nn.conv2d(
        x, 6, [3, 1], groups=3, bias_attr=False, dilation=2, padding=2),
    "pool2d": lambda nn, x: nn.pool2d(x, 3, "avg", 2, 1, exclusive=False),
    "pool2d_global": lambda nn, x: nn.pool2d(x, pool_type="max",
                                             global_pooling=True),
    "batch_norm": lambda nn, x: nn.batch_norm(x, act="relu", momentum=0.8,
                                              moving_mean_name="m",
                                              moving_variance_name="v"),
    "dropout": lambda nn, x: nn.dropout(x, 0.3, seed=5),
    "cross_entropy": lambda nn, x: nn.cross_entropy(
        nn.softmax(nn.reshape(x, [2, 48])), nn.data("lbl", [2, 1], "int64")),
    "accuracy": lambda nn, x: nn.accuracy(
        nn.reshape(x, [2, 48]), nn.data("lbl", [2, 1], "int64"), k=2),
    "elementwise": lambda nn, x: nn.elementwise_div(
        nn.elementwise_mul(nn.elementwise_sub(x, x), x, act="tanh"), x),
    "unary": lambda nn, x: nn.abs(nn.log(nn.exp(nn.sqrt(nn.square(
        nn.sigmoid(nn.relu(nn.tanh(x)))))))),
    "softmax_concat": lambda nn, x: nn.concat([nn.softmax(x, axis=1), x],
                                              axis=1),
    "reduce": lambda nn, x: nn.reduce_mean(nn.reduce_sum(x, dim=[2, 3]),
                                           dim=1, keep_dim=True),
    "overloads": lambda nn, x: (-x + x * 2.0 - 1.0) / x @ x,
    "overload_comparisons": lambda nn, x: [x == x, x != 1.0, x < x,
                                           x >= 0.5],
    "getitem": lambda nn, x: x[0][:, 1:3],
}


def _build_with(pkg, guard, names, case):
    main, startup = pkg.static.Program(), pkg.static.Program()
    with names.guard(), guard(main, startup):
        x = pkg.static.data("x", [2, 3, 4, 4], "float32")
        _BUILDERS[case](pkg.static.nn, x)
    return main, startup


def _x64_off(op):
    """A Python float the overloads make a constant is float32 in the
    port; the reference writes float64, which its JAX (no 64-bit types)
    runs as float32."""
    attrs = {k: v for k, v in op.all_attrs().items() if k != "op_callstack"}
    if attrs.get("dtype") == "float64":
        attrs["dtype"] = "float32"
    return attrs


@pytest.mark.parametrize("case", sorted(_BUILDERS))
def test_static_builder_matches_the_reference(case):
    pd.enable_static()
    try:
        jmain, jstart = _build_with(pd, pd.static.program_guard,
                                    jfluid.unique_name, case)
    finally:
        pd.disable_static()
    tmain, tstart = _build_with(pt, program_guard, unique_name, case)
    for jprog, tprog in ((jmain, tmain), (jstart, tstart)):
        assert _ops(tprog) == _ops(jprog, _x64_off)
        assert _vars(tprog, pt.framework.core.dtype_name) == \
            _vars(jprog, lambda d: np.dtype(d).name)


@pytest.fixture
def comparisons_raise(monkeypatch):
    """Every ``==``, ``!=``, ``<`` ... between Variables raises: none of
    the port's own builders may compare Variables."""
    def refuse(self, other):
        raise AssertionError("a Variable comparison in the port's code")

    for name in ("__eq__", "__ne__", "__lt__", "__le__", "__gt__",
                 "__ge__"):
        monkeypatch.setattr(Variable, name, refuse)


def _gpt2s(minimize=True, **opt_kw):
    with unique_name.guard():
        cfg = tgpt.GPTConfig(vocab_size=32768, n_layer=12, n_head=12,
                             d_model=768, max_seq_len=512, dtype="bfloat16")
        main, startup, io_ = tgpt.build_train_program(cfg, 8, 512)
        if minimize:
            with program_guard(main, startup):
                pt.optimizer.Adam(learning_rate=1e-4,
                                  **opt_kw).minimize(io_["loss"])
    return [op.type for op in main.global_block().ops]


def test_overloads_leave_the_gpt2s_program_unchanged(monkeypatch):
    with_overloads = _gpt2s()
    for name in ("__eq__", "__ne__", "__lt__", "__le__", "__gt__", "__ge__",
                 "__add__", "__mul__", "__neg__", "__getitem__"):
        monkeypatch.delattr(Variable, name)
    assert Variable.__eq__ is object.__eq__
    without = _gpt2s()
    assert with_overloads == without
    assert len(with_overloads) == 824 and "equal" not in with_overloads


@pytest.mark.parametrize("program", ["gpt2s", "recompute", "clip_decay",
                                     "static_amp", "fluid_lenet", "jit"])
def test_port_builds_compare_no_variables(comparisons_raise, program):
    if program == "gpt2s":
        types = _gpt2s()
    elif program == "clip_decay":
        types = _gpt2s(grad_clip=pt.nn.ClipGradByGlobalNorm(1.0),
                       weight_decay=pt.regularizer.L2Decay(0.01))
        assert "squared_l2_norm" in types
    elif program == "recompute":
        from paddle_tpu_torch.distributed.fleet import RecomputeOptimizer

        with unique_name.guard():
            cfg = tgpt.GPTConfig(vocab_size=128, n_layer=2, n_head=2,
                                 d_model=32, max_seq_len=16)
            main, startup, io_ = tgpt.build_train_program(cfg, 2, 16)
            with program_guard(main, startup):
                RecomputeOptimizer(pt.optimizer.Adam(1e-3), {
                    "checkpoints": [v.name for v in io_["checkpoints"]]
                }).minimize(io_["loss"])
        types = [op.type for op in main.global_block().ops]
    elif program == "static_amp":
        with unique_name.guard():
            cfg = tgpt.GPTConfig(vocab_size=128, n_layer=2, n_head=2,
                                 d_model=32, max_seq_len=16)
            main, startup, io_ = tgpt.build_train_program(cfg, 2, 16)
            with program_guard(main, startup):
                pt.static.amp.decorate(pt.optimizer.Adam(1e-3)).minimize(
                    io_["loss"])
        types = [op.type for op in main.global_block().ops]
        assert "cast" in types
    elif program == "fluid_lenet":
        main = _lenet(tfluid, pt)[0]
        types = [op.type for op in main.global_block().ops]
    else:
        prev = pt.framework.core._default_place
        pt.disable_static()
        pt.set_device("cpu")
        try:
            layer = vision.models.LeNet()
            prog, _, _, _ = pt.jit._capture_program(
                layer, [pt.static.InputSpec([1, 1, 28, 28], "float32")])
        finally:
            pt.framework.core._default_place = prev
            pt.enable_static()
        types = [op.type for op in prog.global_block().ops]
        assert "conv2d" in types
    assert types and "equal" not in types
