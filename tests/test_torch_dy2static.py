"""dy2static on the port (``paddle_tpu_torch/jit/dy2static.py``): every case
of ``tests/test_dy2static.py`` and ``tests/test_dy2static_model.py``,
held against the JAX package's results on the same inputs and weights.

Each case runs in both packages through ``jit.to_static``: in the port
on the staged CPU route (``StaticFunction.staged``: the card's warm-up,
capture and replays, each graph's body called directly), each function
called several times so that replays and re-used loop bodies are
checked too. The JAX package computes its side in one subprocess for
the module (a JAX static-mode leak in this worker cannot turn it). The
comparison is exact (integers and float sums of exact values) except
the two model cases, at rtol 1e-5 (fp32). The "does not unroll" case
keeps its meaning as one captured loop body that serves three trip
counts (and three inputs read from the enclosing function); the "raises
loudly" cases raise ``Dy2StaticError`` in the port where the JAX package
raises (the unsupported ``for v in tensor``; a tensor branch under
``backend="trace"``, whose message names the value as not concrete, as
JAX's tracer error does).

Then each route's selection: "graph" for Python control flow, "loop"
for a tensor ``if`` or loop (host reads counted; ``if`` inside a loop
body selected on the device), "eager" off the staged route; a loop body
re-captured when a parameter it reads is rebound.
"""
import torch_threads  # noqa: F401 (one torch thread a worker)
import os
import subprocess
import sys
import types

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import jit as tjit  # noqa: E402
from paddle_tpu_torch.framework import core  # noqa: E402
from paddle_tpu_torch.jit.dy2static import Dy2StaticError  # noqa: E402
from paddle_tpu_torch.weights import layer_from_numpy  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _eager_on_cpu():
    was_dygraph = pt.in_dygraph_mode()
    prev = core._default_place
    pt.disable_static()
    pt.set_device("cpu")
    try:
        yield
    finally:
        core._default_place = prev
        if not was_dygraph:
            pt.enable_static()


def _is_port(paddle):
    return paddle.__name__ == "paddle_tpu_torch"


def _sf(f):
    """The StaticFunction behind what ``to_static`` returned."""
    if isinstance(f, tjit.StaticFunction):
        return f
    if hasattr(f, "static_function"):
        return f.static_function
    return f.forward.static_function


def _compiled(paddle, f, **kw):
    """``to_static(f)``; in the port on the staged route."""
    out = paddle.jit.to_static(f, **kw)
    if _is_port(paddle):
        _sf(out).staged = True
    return out


def _route(f):
    (info,) = _sf(f).routes.values()
    return info


def _f32(v):
    return np.asarray(v, np.float32)


def _val(t):
    return np.asarray(t.numpy())


# -- the cases: each returns its results and the compiled function ------


def case_collatz(paddle):
    def collatz_steps(x):
        steps = paddle.to_tensor(np.zeros((), np.int32))
        while x > 1:
            x = paddle.where(x % 2 == 0, x // 2, 3 * x + 1)
            steps = steps + 1
        return steps

    fn = _compiled(paddle, collatz_steps)
    return [_val(fn(paddle.to_tensor(np.int32(v)))).astype(np.int64)
            for v in (7, 7, 27)], fn


def case_while_no_unroll(paddle):
    def body(x, n):
        i = paddle.to_tensor(np.int32(0))
        s = paddle.to_tensor(np.float32(0))
        while i < n:
            s = s + x
            i = i + 1
        return s

    fn = _compiled(paddle, body)
    return [_val(fn(paddle.to_tensor(np.float32(x)),
                    paddle.to_tensor(np.int32(n))))
            for x, n in ((2.0, 3), (3.0, 5), (1.5, 4))], fn


def case_if_both_branches(paddle):
    def f(x):
        if x.sum() > 0:
            y = x * 2
        else:
            y = x - 10
        return y

    fn = _compiled(paddle, f)
    return [_val(fn(paddle.to_tensor(s * np.ones(3, np.float32))))
            for s in (1, -1, 1)], fn


def case_for_range_tensor_bound(paddle):
    def f(n):
        s = paddle.to_tensor(np.float32(0))
        for i in range(n):
            s = s + i
        return s

    fn = _compiled(paddle, f)
    return [_val(fn(paddle.to_tensor(np.int32(n)))) for n in (5, 5, 3)], fn


def case_python_control_flow(paddle):
    def f(x, flag):
        if flag:          # an argument: a tensor in both packages
            x = x + 1
        for _ in range(3):  # python range -> python loop
            x = x * 2
        return x

    fn = _compiled(paddle, f)
    return [_val(fn(paddle.to_tensor(np.float32(1.0)), flag))
            for flag in (True, True, False)], fn


def case_break(paddle):
    def f(x, cap):
        i = paddle.to_tensor(np.float32(0))
        while x < 100.0:
            x = x * 2.0
            i = i + 1
            if i >= cap:
                break
        return x

    fn = _compiled(paddle, f)
    return [_val(fn(paddle.to_tensor(np.float32(x)),
                    paddle.to_tensor(np.float32(c))))
            for x, c in ((1.0, 3), (1.0, 100), (50.0, 2), (1.0, 3))], fn


def case_continue(paddle):
    def f(z):
        s = z * 0.0
        for i in range(8):
            t = z * 0.0 + i
            if t % 2.0 < 1.0:
                continue
            s = s + t
        return s

    fn = _compiled(paddle, f)
    return [_val(fn(paddle.to_tensor(np.float32(1)))) for _ in range(3)], fn


def case_return_in_loop(paddle):
    def f(x):
        while x < 1000.0:
            x = x * 3.0
            if x > 50.0:
                return x * 10.0
        return x

    fn = _compiled(paddle, f)
    return [_val(fn(paddle.to_tensor(np.float32(x))))
            for x in (1.0, 2000.0, 1.0, 2.0)], fn


def case_negative_step(paddle):
    def f(x):
        s = paddle.to_tensor(np.float32(0))
        for i in range(5, 0, -1):
            s = s + i * x
        return s

    fn = _compiled(paddle, f)
    return [_val(fn(paddle.to_tensor(np.float32(1.0)))) for _ in range(3)], fn


def case_break_leaves_index(paddle):
    def f(z):
        j = z * 0.0
        for i in range(10):
            j = z * 0.0 + i
            if j >= 3.0:
                break
        return j

    fn = _compiled(paddle, f)
    return [_val(fn(paddle.to_tensor(np.float32(1)))) for _ in range(3)], fn


def case_nested_break(paddle):
    def f(x):
        for i in range(5):
            for j in range(3):
                if j > 1:
                    break
                x = x + 1.0
        return x

    fn = _compiled(paddle, f)
    return [_val(fn(paddle.to_tensor(np.float32(0.0)))) for _ in range(3)], fn


def case_helper_after(paddle):
    """Module-level helpers defined below the decorated function resolve
    at call time (live globals)."""
    mod = types.ModuleType("dy2st_live_globals_probe")
    code = f"""
import numpy as np
import {paddle.__name__} as paddle
from {paddle.__name__} import jit

@jit.to_static
def f(x):
    return helper(x)

def helper(x):
    return x + 1
"""
    exec(compile(code, "<probe>", "exec"), mod.__dict__)
    if _is_port(paddle):
        mod.f.staged = True
    return [_val(mod.f(paddle.to_tensor(np.float32(2.0))))
            for _ in range(3)], mod.f


def _layer_m(paddle):
    nn = paddle.nn

    class M(nn.Layer):
        def __init__(self):
            super().__init__()
            self.lin = nn.Linear(4, 4)

        def forward(self, x, n):
            h = self.lin(x)
            i = paddle.to_tensor(np.int32(0))
            while i < n:
                h = h + 1
                i = i + 1
            return h

    return M()


def _weights(name, weights):
    return {k.split("/", 1)[1]: v for k, v in weights.items()
            if k.startswith(name + "/")}


def case_nested_loop_in_layer_method(paddle, weights):
    m = _layer_m(paddle)
    if weights is not None:
        layer_from_numpy(m, _weights("m", weights))
    sm = _compiled(paddle, m)
    x = paddle.to_tensor(np.ones((2, 4), np.float32))
    out = [_val(sm(x, paddle.to_tensor(np.int32(n)))) for n in (3, 3, 2)]
    return out, sm, {f"m/{k}": np.asarray(v) for k, v in
                     m.state_dict().items()}


def case_loop_twice_in_one_call(paddle):
    """One tensor `while` run twice in a call (a Python `for` unrolls
    it): the second run's body reads `scale`, rebound since the first,
    and the eager result comes first."""
    def f(x, n):
        acc = x * 0.0
        for k in range(2):
            scale = x * (k + 1.0)
            i = paddle.to_tensor(np.float32(0))
            while i < n:
                acc = acc + scale
                i = i + 1.0
        return acc

    args = [(paddle.to_tensor(np.float32(x)), paddle.to_tensor(np.float32(n)))
            for x, n in ((1.0, 3), (2.0, 3), (1.0, 2))]
    fn = _compiled(paddle, f)
    return [_val(f(*args[0]))] + [_val(fn(*a)) for a in args], fn


def _tiny_lm(paddle):
    nn = paddle.nn

    class TinyLM(nn.Layer):
        def __init__(self, vocab=32, d=16, heads=2):
            super().__init__()
            self.emb = nn.Embedding(vocab, d)
            enc_layer = nn.TransformerEncoderLayer(
                d_model=d, nhead=heads, dim_feedforward=2 * d, dropout=0.0)
            self.encoder = nn.TransformerEncoder(enc_layer, num_layers=2)
            self.head = nn.Linear(d, vocab)

        def forward(self, ids):
            h = self.emb(ids)
            h = self.encoder(h)
            return self.head(h)

    return TinyLM()


_IDS = np.random.RandomState(0).randint(0, 32, (2, 6)).astype(np.int64)
_IDS2 = np.random.RandomState(1).randint(0, 32, (2, 4)).astype(np.int64)


def case_transformer_lm_forward(paddle, weights):
    model = _tiny_lm(paddle)
    if weights is not None:
        layer_from_numpy(model, _weights("lm", weights))
    ids = paddle.to_tensor(_IDS)
    eager = _val(model(ids))
    fwd = _compiled(paddle, model.forward)
    return [eager] + [_val(fwd(ids)) for _ in range(3)], fwd, {
        f"lm/{k}": np.asarray(v) for k, v in model.state_dict().items()}


def case_greedy_decode(paddle, weights):
    model = _tiny_lm(paddle)
    if weights is not None:
        layer_from_numpy(model, _weights("dec", weights))

    def decode_scores(ids, max_new):
        total = paddle.to_tensor(np.float32(0))
        steps = paddle.to_tensor(np.float32(0))
        while steps < max_new:
            logits = model(ids)
            nxt = logits[:, -1, :].max(axis=-1)
            total = total + nxt.sum()
            steps = steps + 1.0
            if total > 5.0:
                break
        return total

    ids = paddle.to_tensor(_IDS2)
    limit = paddle.to_tensor(np.float32(8))
    eager = _val(decode_scores(ids, limit))
    fn = _compiled(paddle, decode_scores)
    return [eager] + [_val(fn(ids, limit)) for _ in range(3)], fn, {
        f"dec/{k}": np.asarray(v) for k, v in model.state_dict().items()}


CASES = {n[5:]: f for n, f in list(globals().items())
         if n.startswith("case_")}
_MODEL_CASES = ("nested_loop_in_layer_method", "transformer_lm_forward",
                "greedy_decode")


def _raises_for_loop(paddle):
    def f(x):
        s = x * 0
        for v in x:  # iterating a tensor: unsupported
            s = s + v
        return s

    fn = _compiled(paddle, f)
    try:
        fn(paddle.to_tensor(np.ones(3, np.float32)))
    except Exception as e:  # noqa: BLE001 (the message is compared)
        return type(e).__name__, str(e)
    return None, None


def _raises_trace_backend(paddle):
    def f(x):
        if x.sum() > 0:
            return x * 2
        return x

    fn = _compiled(paddle, f, backend="trace")
    try:
        fn(paddle.to_tensor(np.ones(3, np.float32)))
    except Exception as e:  # noqa: BLE001
        return type(e).__name__, str(e)
    return None, None


def _reference_main(out):
    """Run in a subprocess: every case in the JAX package, saved to
    ``out`` (the model cases' weights too, for the port)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import paddle_tpu as pd

    res = {}
    # the model cases first: the JAX package's tracer makes its key at
    # the first parameter, which must not fall inside a jax.jit trace
    for name in sorted(CASES, key=lambda n: n not in _MODEL_CASES):
        case = CASES[name]
        if name in _MODEL_CASES:
            vals, _, weights = case(pd, None)
            res.update(weights)
        else:
            vals, _ = case(pd)
        for i, v in enumerate(vals):
            res[f"{name}/{i}"] = np.asarray(v)
    for name, fn in (("for_loop", _raises_for_loop),
                     ("trace", _raises_trace_backend)):
        kind, msg = fn(pd)
        res[f"raises/{name}"] = np.array([str(kind), str(msg)])
    np.savez(out, **res)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dy2static_ref") / "ref.npz")
    code = (f"import importlib.util, sys; sys.path.insert(0, {_REPO!r}); "
            f"sys.path.insert(0, {os.path.dirname(__file__)!r}); "
            f"s = importlib.util.spec_from_file_location('t', {__file__!r});"
            f" m = importlib.util.module_from_spec(s); "
            f"s.loader.exec_module(m); m._reference_main({out!r})")
    env = torch_threads.subprocess_env(JAX_PLATFORMS="cpu", PYTHONPATH=_REPO)
    done = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stdout[-3000:] + done.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


# the route each case's entry takes, and counts it must show
_ROUTES = {
    "collatz": ("loop", {"loop_captures": 1, "tensor_ifs": 0}),
    "while_no_unroll": ("loop", {"loop_captures": 1, "loop_bodies": 2}),
    "if_both_branches": ("loop", {"tensor_ifs": 3, "host_reads": 3,
                                  "tensor_loops": 0}),
    "for_range_tensor_bound": ("loop", {"loop_captures": 1}),
    "python_control_flow": ("loop", {"tensor_ifs": 3, "tensor_loops": 0}),
    "break": ("loop", {"loop_captures": 1}),
    "continue": ("loop", {"tensor_loops": 0}),
    "return_in_loop": ("loop", {"loop_captures": 1}),
    "negative_step": ("graph", {"host_reads": 0}),
    "loop_twice_in_one_call": ("loop", {"tensor_loops": 6,
                                        "loop_captures": 1}),
    "break_leaves_index": ("loop", {}),
    "nested_break": ("graph", {"host_reads": 0}),
    "helper_after": ("graph", {"host_reads": 0}),
    "nested_loop_in_layer_method": ("loop", {"loop_captures": 1}),
    "transformer_lm_forward": ("graph", {"host_reads": 0}),
    "greedy_decode": ("loop", {"loop_captures": 1, "tensor_ifs": 1}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_matches_the_reference(reference, name):
    if name in _MODEL_CASES:
        got, fn, _ = CASES[name](pt, reference)
    else:
        got, fn = CASES[name](pt)
    want = [reference[f"{name}/{i}"] for i in range(len(got))]
    for g, w in zip(got, want):
        if name in _MODEL_CASES:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(_f32(g), _f32(w))
    route, counts = _ROUTES[name]
    info = _route(fn)
    assert info["route"] == route, info
    assert {k: info[k] for k in counts} == counts, info


def test_does_not_unroll_one_body_serves_every_trip_count():
    """The loop body is one captured graph: trip counts 3, 5 and 4 and
    three values of `x` (read from the enclosing function) all replay
    it; the int32 counter's first trip (int32 + 1 is int64 in the port)
    runs op by op, then the int64 body is warmed, captured and
    replayed."""
    got, fn = case_while_no_unroll(pt)
    assert [float(v) for v in got] == [6.0, 15.0, 6.0]
    info = _route(fn)
    assert info["loop_captures"] == 1 and info["trips"] == 12
    assert info["host_reads"] == 12 + 3


def test_unsupported_iteration_raises_like_the_reference(reference):
    kind, msg = _raises_for_loop(pt)
    assert kind == "Dy2StaticError" and "for loop" in msg
    ref_kind, ref_msg = reference["raises/for_loop"]
    assert ref_kind == "Dy2StaticError" and "for loop" in ref_msg


def test_trace_backend_raises_on_data_dependent_branch(reference):
    kind, msg = _raises_trace_backend(pt)
    assert kind == "Dy2StaticError"
    assert "concrete" in msg
    ref_kind, ref_msg = reference["raises/trace"]
    assert ref_kind != "None" and ("racer" in ref_msg
                                   or "concrete" in ref_msg)


def test_a_host_read_inside_a_compiled_function_raises():
    def f(x):
        return x * float(x.sum())

    fn = _compiled(pt, f)
    with pytest.raises(Dy2StaticError, match="not concrete"):
        fn(pt.to_tensor(np.ones(3, np.float32)))
    # the same function runs eagerly outside
    assert float(f(pt.to_tensor(np.ones(3, np.float32))).sum()) == 9.0


def test_if_inside_a_loop_body_selects_on_the_device():
    got, fn = case_break(pt)
    info = _route(fn)
    # the break's `if` ran in the captured body (both branches, a where)
    assert info["selects"] > 0 and info["tensor_ifs"] == 0
    assert [float(v) for v in got] == [8.0, 128.0, 100.0, 8.0]


def test_off_the_staged_route_the_function_runs_eagerly():
    def f(x):
        if x.sum() > 0:
            y = x * 2
        else:
            y = x - 10
        return y

    fn = pt.jit.to_static(f)
    out = fn(pt.to_tensor(-np.ones(3, np.float32)))
    np.testing.assert_array_equal(_val(out), [-11, -11, -11])
    assert out.stop_gradient
    info = _route(fn)
    assert info["route"] == "eager" and info["phases"]["eager"] == 1
    assert info["host_reads"] == 0  # plain Python: the unit is not used


def test_set_value_between_calls_is_seen_on_the_loop_route():
    """The layer reads its weight op by op (the loop route's function
    part): a ``set_value`` between calls shows in the next output."""
    m = _layer_m(pt)
    sm = _compiled(pt, m)
    x = pt.to_tensor(np.ones((2, 4), np.float32))
    n = pt.to_tensor(np.int32(3))
    for _ in range(3):
        sm(x, n)
    m.lin.weight.set_value(np.full((4, 4), 0.5, np.float32))
    got = _val(sm(x, n))
    np.testing.assert_allclose(got, _val(m.lin(x)) + 3, rtol=1e-6)


def test_a_loop_body_reading_a_parameter_captures_again():
    lin = pt.nn.Linear(3, 3)

    def f(x, n):
        i = pt.to_tensor(np.int32(0))
        while i < n:
            x = lin(x)
            i = i + 1
        return x

    fn = _compiled(pt, f)
    x = pt.to_tensor(np.ones((1, 3), np.float32))
    n = pt.to_tensor(np.int32(4))
    for _ in range(2):
        fn(x, n)
    unit = next(iter(_sf(fn)._cache.values())).unit
    captured = {id(b): b.run for b in unit.loops.values() if b.run.captured}
    lin.weight.set_value(np.eye(3, dtype=np.float32) * 2)
    got = _val(fn(x, n))
    want = _val(f(x, n))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    moved = [b for b in unit.loops.values()
             if id(b) in captured and b.run is not captured[id(b)]]
    assert moved, "the body that read the weight kept its old graph"
