"""``paddle_tpu_torch.jit`` against the JAX package's ``paddle_tpu.jit``.

The reference's ``tests/test_jit.py`` cases on the port (the conv model
waits for conv, ROADMAP A11), held against the JAX package's numbers on
the same numpy weights and inputs at rtol 1e-5 (fp32): function parity,
cache reuse, the layer decorator, the save/load round trip, and the
saved program run through ``Executor`` directly. The JAX package
computes its side in one subprocess for the module.

Then the export path across packages: a model saved by
``paddle_tpu.jit.save`` loads in ``paddle_tpu_torch.jit.load`` and gives
the JAX package's outputs at rtol 1e-5, and a model the port saved loads
in ``paddle_tpu.jit.load`` and gives the port's. The masked-LM encoder
of ``chip_smoke`` (tiny widths) reads a position table that is no
parameter: the port saves it with the parameters, the JAX package does
not and its own saved encoder fails to run (a difference kept on
purpose). At head_dim 256 (a narrow encoder of one head of 256, flash
forced on through ``PADDLE_TPU_FLASH_MIN_SEQ``) the port's loaded fp32
forward runs ``flash_attention_fwd`` at (fp32, 256) once a layer, the
route of the head_dim-256 split-TF32 kernel on the card, and gives the
JAX package's forward of the same weights at the flash kernels' fp32
parity tolerance (2e-5).

And the port's own contract on the staged CPU route
(``StaticFunction.staged``, ``Executor.staged``: the card's phases with
each body called directly): warm-up, capture, replays; a ``set_value``
between calls captures again and is seen; the key takes the
``auto_cast`` state and the kwargs' values; host values reach a capture
only through the warm-up's recorded constants; a compiled call inside
another is inlined; outputs take no gradient.
"""
import torch_threads  # noqa: F401 (one torch thread a worker)
import importlib
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import chip_smoke  # noqa: E402
import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import amp, jit, nn  # noqa: E402
from paddle_tpu_torch.framework import (CPUPlace, Executor, Program,  # noqa: E402
                                        Scope, core)
from paddle_tpu_torch.jit.dy2static import Dy2StaticError  # noqa: E402

RTOL = 1e-5
_MLM = dict(vocab=64, seq=16, d_model=32, n_head=2, n_layer=2, dropout=0.0)
# the encoder at head_dim 256: one head of 256, flash attention from seq
# 128 on (PADDLE_TPU_FLASH_MIN_SEQ) in both packages
_MLM256 = dict(vocab=64, seq=128, d_model=256, n_head=1, n_layer=2,
               dropout=0.0)


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


def _model(paddle):
    nn_ = paddle.nn
    return nn_.Sequential(nn_.Linear(4, 8), nn_.ReLU(), nn_.Linear(8, 2))


def _x(seed, shape):
    return np.random.RandomState(seed).rand(*shape).astype("float32")


def _ids(cfg=_MLM):
    return np.random.RandomState(5).randint(
        0, cfg["vocab"] - 1, (1, cfg["seq"])).astype(np.int64)


class _FlashOn:
    """``PADDLE_TPU_FLASH_MIN_SEQ`` at ``_MLM256``'s seq inside, so that
    both packages' attention takes its flash path."""

    def __enter__(self):
        self.saved = os.environ.get("PADDLE_TPU_FLASH_MIN_SEQ")
        os.environ["PADDLE_TPU_FLASH_MIN_SEQ"] = str(_MLM256["seq"])

    def __exit__(self, *exc):
        if self.saved is None:
            os.environ.pop("PADDLE_TPU_FLASH_MIN_SEQ", None)
        else:
            os.environ["PADDLE_TPU_FLASH_MIN_SEQ"] = self.saved


def _weights():
    """Numpy weights of every model, from the port's initializers."""
    pt.seed(11)
    out = {}
    for name, layer in (("lin", nn.Linear(3, 2)), ("model", _model(pt)),
                        ("mlm", chip_smoke._masked_lm(pt, **_MLM)),
                        ("mlm256", chip_smoke._masked_lm(pt, **_MLM256))):
        for k, v in layer.state_dict().items():
            out[f"{name}/{k}"] = np.asarray(v)
    return out


def _load(layer, weights, name):
    layer.set_state_dict({k.split("/", 1)[1]: v for k, v in weights.items()
                          if k.startswith(name + "/")})
    return layer


def _cases(paddle, weights, root):
    """Every numbered result both packages compute, and the models each
    saves under ``root``."""
    res = {}
    lin = _load(paddle.nn.Linear(3, 2), weights, "lin")

    def f(x):
        return lin(x) * 2.0

    x = paddle.to_tensor(_x(0, (5, 3)))
    res["function/eager"] = np.asarray(f(x).numpy())
    res["function/static"] = np.asarray(paddle.jit.to_static(f)(x).numpy())
    model = _load(_model(paddle), weights, "model")
    res["layer/eager"] = np.asarray(model(paddle.to_tensor(
        _x(1, (3, 4)))).numpy())
    res["layer/static"] = np.asarray(paddle.jit.to_static(model)(
        paddle.to_tensor(_x(1, (3, 4)))).numpy())
    model = _load(_model(paddle), weights, "model")
    model.eval()
    path = os.path.join(root, "jit_model")
    paddle.jit.save(model, path,
                    input_spec=[paddle.jit.InputSpec([None, 4], "float32")])
    res["roundtrip/expected"] = np.asarray(
        model(paddle.to_tensor(_x(2, (4, 4)))).numpy())
    res["roundtrip/loaded"] = np.asarray(paddle.jit.load(path)(
        paddle.to_tensor(_x(2, (4, 4)))).numpy())
    mlm = _load(chip_smoke._masked_lm(paddle, **_MLM), weights, "mlm")
    mlm.eval()
    res["mlm/eager"] = np.asarray(mlm(paddle.to_tensor(_ids())).numpy())
    paddle.jit.save(mlm, os.path.join(root, "mlm"), input_spec=[
        paddle.jit.InputSpec([None, _MLM["seq"]], "int64")])
    mlm256 = _load(chip_smoke._masked_lm(paddle, **_MLM256), weights,
                   "mlm256")
    mlm256.eval()
    attention = importlib.import_module(paddle.__name__ + ".ops.attention")
    before = attention.FLASH_DISPATCH_COUNT
    with _FlashOn():
        res["mlm256/eager"] = np.asarray(mlm256(paddle.to_tensor(
            _ids(_MLM256))).numpy())
    res["mlm256/flash"] = np.asarray(attention.FLASH_DISPATCH_COUNT - before)
    return res


def _run_saved(paddle, root):
    """Outputs of ``root``'s saved models through ``paddle.jit.load``, or
    the error a model raised."""
    res = {}
    res["saved/jit_model"] = np.asarray(paddle.jit.load(os.path.join(
        root, "jit_model"))(paddle.to_tensor(_x(2, (4, 4)))).numpy())
    try:
        res["saved/mlm"] = np.asarray(paddle.jit.load(os.path.join(
            root, "mlm"))(paddle.to_tensor(_ids())).numpy())
    except Exception as e:  # noqa: BLE001 (the message is kept)
        res["saved/mlm_error"] = np.array(f"{type(e).__name__}: {e}")
    return res


def _reference_main(weights_file, ref_root, port_root, out):
    """Run in a subprocess: the cases in the JAX package (saving its
    models under ``ref_root``), then the port's saved models and its own
    through ``paddle_tpu.jit.load``."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import paddle_tpu as pd

    with np.load(weights_file) as z:
        weights = {k: z[k] for k in z.files}
    res = _cases(pd, weights, ref_root)
    res.update({f"port/{k}": v for k, v in _run_saved(pd, port_root).items()})
    res.update({f"ref/{k}": v for k, v in _run_saved(pd, ref_root).items()})
    np.savez(out, **res)


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """(weights, the port's results, the JAX package's, the roots)."""
    root = tmp_path_factory.mktemp("jit")
    weights = _weights()
    np.savez(root / "weights.npz", **weights)
    port_root, ref_root = str(root / "port"), str(root / "ref")
    os.makedirs(port_root)
    os.makedirs(ref_root)
    port = _cases(pt, weights, port_root)
    out = str(root / "ref.npz")
    code = (f"import importlib.util, sys; sys.path.insert(0, {_REPO!r}); "
            f"sys.path.insert(0, {os.path.dirname(__file__)!r}); "
            f"s = importlib.util.spec_from_file_location('t', {__file__!r});"
            f" m = importlib.util.module_from_spec(s); "
            f"s.loader.exec_module(m); m._reference_main("
            f"{str(root / 'weights.npz')!r}, {ref_root!r}, {port_root!r}, "
            f"{out!r})")
    env = torch_threads.subprocess_env(JAX_PLATFORMS="cpu", PYTHONPATH=_REPO)
    done = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stdout[-3000:] + done.stderr[-3000:]
    with np.load(out) as z:
        ref = {k: z[k] for k in z.files}
    return weights, port, ref, port_root, ref_root


def _staged(f):
    sf = f if isinstance(f, jit.StaticFunction) else (
        f.static_function if hasattr(f, "static_function")
        else f.forward.static_function)
    sf.staged = True
    return f, sf


# -- the reference's test_jit.py cases ------------------------------------


def test_to_static_function_parity(shared):
    weights, port, ref, _, _ = shared
    np.testing.assert_allclose(port["function/static"],
                               port["function/eager"], rtol=1e-6)
    np.testing.assert_allclose(port["function/static"],
                               ref["function/static"], rtol=RTOL)
    lin = _load(nn.Linear(3, 2), weights, "lin")

    def f(x):
        return lin(x) * 2.0

    sf, _ = _staged(jit.to_static(f))
    x = pt.to_tensor(_x(0, (5, 3)))
    for _ in range(3):
        np.testing.assert_allclose(sf(x).numpy(), ref["function/static"],
                                   rtol=RTOL)


def test_to_static_cache_reuse():
    def f(x):
        return x * 3.0

    sf, _ = _staged(jit.to_static(f))
    a = pt.to_tensor(np.ones((2, 2), "float32"))
    sf(a)
    assert len(sf._cache) == 1
    sf(a)
    assert len(sf._cache) == 1  # same shape: cache hit
    b = pt.to_tensor(np.ones((4, 2), "float32"))
    np.testing.assert_array_equal(sf(b).numpy(), np.full((4, 2), 3.0))
    assert len(sf._cache) == 2  # new shape: a new entry


def test_to_static_layer_decorator(shared):
    weights, port, ref, _, _ = shared
    assert port["layer/static"].shape == (3, 2)
    np.testing.assert_allclose(port["layer/static"], ref["layer/static"],
                               rtol=RTOL)
    model, sf = _staged(jit.to_static(_load(_model(pt), weights, "model")))
    for _ in range(3):
        out = model(pt.to_tensor(_x(1, (3, 4))))
        np.testing.assert_allclose(out.numpy(), ref["layer/static"],
                                   rtol=RTOL)
    assert list(sf.routes.values())[0]["phases"] == {
        "eager": 1, "capture": 1, "replay": 1, "op": 0}


def test_jit_save_load_roundtrip(shared):
    _, port, ref, port_root, _ = shared
    np.testing.assert_allclose(port["roundtrip/loaded"],
                               port["roundtrip/expected"], rtol=RTOL)
    np.testing.assert_allclose(port["roundtrip/loaded"],
                               ref["roundtrip/loaded"], rtol=RTOL)
    loaded = jit.load(os.path.join(port_root, "jit_model"))
    loaded._exe.staged = True
    x = pt.to_tensor(_x(2, (4, 4)))
    for _ in range(3):
        np.testing.assert_allclose(loaded(x).numpy(),
                                   port["roundtrip/expected"], rtol=RTOL)
    assert loaded._exe.phases == {"eager": 1, "capture": 1, "replay": 1}


def test_jit_saved_model_serves_via_predictor(shared):
    """jit.save output is a static program: run it through the Executor
    directly (inference-format parity)."""
    _, port, ref, port_root, _ = shared
    path = os.path.join(port_root, "jit_model")
    with open(path + ".pdmodel", "rb") as f:
        payload = pickle.load(f)
    with open(path + ".pdiparams", "rb") as f:
        params = pickle.load(f)
    prog = Program.parse_from_string(payload["program"])
    scope = Scope()
    for k, v in params.items():
        scope.set(k, torch.from_numpy(np.asarray(v)))
    out = Executor(CPUPlace()).run(
        prog, feed={payload["feeds"][0]: _x(2, (4, 4))},
        fetch_list=payload["fetches"], scope=scope)[0]
    np.testing.assert_allclose(out, ref["roundtrip/expected"], rtol=RTOL)


# -- across packages ---------------------------------------------------------


def test_a_model_saved_by_jax_loads_in_the_port(shared):
    _, _, ref, _, ref_root = shared
    got = jit.load(os.path.join(ref_root, "jit_model"))(
        pt.to_tensor(_x(2, (4, 4)))).numpy()
    np.testing.assert_allclose(got, ref["roundtrip/expected"], rtol=RTOL)


def test_a_model_saved_by_the_port_loads_in_jax(shared):
    _, port, ref, _, _ = shared
    np.testing.assert_allclose(ref["port/saved/jit_model"],
                               port["roundtrip/expected"], rtol=RTOL)
    np.testing.assert_allclose(ref["port/saved/mlm"], port["mlm/eager"],
                               rtol=RTOL, atol=1e-6)


def test_export_at_head_dim_256_runs_the_fp32_flash_forward(shared,
                                                            tmp_path,
                                                            monkeypatch):
    """An encoder with one head of 256 saved in fp32 and loaded: the loaded
    forward reaches ``flash_attention_fwd`` at (fp32, 256) once a layer
    (on the card ``flash_attn_fwd_f32_d256_sm90``; here its plain
    version) and gives the JAX package's forward of the same weights, its
    flash path taken too, at the flash kernels' fp32 parity tolerance
    (2e-5)."""
    from paddle_tpu_torch.ops import flash_attention as fl

    weights, port, ref, _, _ = shared
    assert int(ref["mlm256/flash"]) == _MLM256["n_layer"]
    assert int(port["mlm256/flash"]) == _MLM256["n_layer"]
    net = _load(chip_smoke._masked_lm(pt, **_MLM256), weights, "mlm256")
    net.eval()
    path = str(tmp_path / "mlm256")
    jit.save(net, path, input_spec=[jit.InputSpec([None, _MLM256["seq"]],
                                                  "int64")])
    loaded = jit.load(path)
    calls, fwd = [], fl.flash_attention_fwd

    def recorded(q, *args, **kwargs):
        calls.append((q.dtype, q.shape[-1]))
        return fwd(q, *args, **kwargs)

    monkeypatch.setattr(fl, "flash_attention_fwd", recorded)
    with _FlashOn():
        got = loaded(pt.to_tensor(_ids(_MLM256))).numpy()
    assert calls == [(torch.float32, 256)] * _MLM256["n_layer"]
    # the fp32 parity tolerance of the flash kernels' tests
    # (tests/test_torch_flash_attention.py): logits near 0 differ by
    # some 1e-6 between the two packages' sums
    np.testing.assert_allclose(got, ref["mlm256/eager"], rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(port["mlm256/eager"], ref["mlm256/eager"],
                               rtol=2e-5, atol=2e-5)


def test_a_layer_buffer_is_saved_where_the_reference_drops_it(shared):
    """The encoder's position table is neither a parameter nor an input:
    the port's save keeps it (persistable in the program), so its model
    runs in both packages; the JAX package's save leaves it out, and its
    own load fails on it."""
    _, port, ref, port_root, ref_root = shared
    loaded = jit.load(os.path.join(port_root, "mlm"))
    block = loaded._program.global_block()
    np.testing.assert_allclose(loaded(pt.to_tensor(_ids())).numpy(),
                               port["mlm/eager"], rtol=RTOL, atol=1e-6)
    with open(os.path.join(port_root, "mlm.pdiparams"), "rb") as f:
        params = pickle.load(f)
    buffers = [n for n, v in params.items()
               if np.asarray(v).dtype == np.int64]
    assert len(buffers) == 1 and block.var(buffers[0]).persistable
    np.testing.assert_array_equal(params[buffers[0]], np.arange(_MLM["seq"]))
    assert "ref/saved/mlm" not in ref
    assert "PreconditionNotMet" in str(ref["ref/saved/mlm_error"])
    # the JAX package's saved encoder lacks only that table
    with open(os.path.join(ref_root, "mlm.pdiparams"), "rb") as f:
        ref_params = pickle.load(f)
    assert len(ref_params) == len(params) - 1


# -- the port's compiled route -----------------------------------------------


def test_staged_route_has_three_phases_and_outputs_take_no_gradient():
    lin = nn.Linear(3, 2)

    def f(x):
        return lin(x) * 2.0

    sf, _ = _staged(jit.to_static(f))
    x = pt.to_tensor(_x(0, (5, 3)))
    outs = [sf(x) for _ in range(4)]
    (info,) = sf.routes.values()
    assert info["route"] == "graph" and info["phases"] == {
        "eager": 1, "capture": 1, "replay": 2, "op": 0}
    assert all(o.stop_gradient for o in outs)
    want = f(x).numpy()
    for o in outs:
        np.testing.assert_array_equal(o.numpy(), want)
    # outputs are copies: a later call leaves an earlier output alone
    outs[0]._value.add_(1.0)
    np.testing.assert_array_equal(sf(x).numpy(), want)


def test_set_value_between_calls_captures_again():
    lin = nn.Linear(3, 2)

    def f(x):
        return lin(x) * 2.0

    sf, _ = _staged(jit.to_static(f))
    x = pt.to_tensor(_x(0, (5, 3)))
    for _ in range(3):
        sf(x)
    lin.weight.set_value(np.full((3, 2), 0.25, np.float32))
    got = sf(x).numpy()
    np.testing.assert_array_equal(got, f(x).numpy())
    (info,) = sf.routes.values()
    assert info["recaptures"] == 1
    assert info["phases"] == {"eager": 1, "capture": 2, "replay": 1, "op": 0}
    sf(x)
    assert sf.routes[next(iter(sf._cache))]["recaptures"] == 1


def test_auto_cast_is_part_of_the_key():
    """The reference keys on shapes, dtypes, ``training`` and kwarg names
    (its jax.jit trace sees no autocast state); the port's capture bakes
    the casts in, so the ``auto_cast`` state and dtype are in the key."""
    lin = nn.Linear(4, 4)

    def f(x):
        return lin(x)

    sf, _ = _staged(jit.to_static(f))
    x = pt.to_tensor(_x(3, (2, 4)))
    plain = sf(x).numpy()
    with amp.auto_cast(dtype="bfloat16"):
        cast = sf(x).numpy()
        cast_eager = f(x).numpy()
        cast_again = sf(x).numpy()
    assert len(sf._cache) == 2
    np.testing.assert_array_equal(plain, f(x).numpy())
    np.testing.assert_array_equal(cast, cast_eager)
    np.testing.assert_array_equal(cast_again, cast_eager)
    assert not np.array_equal(plain, cast)


def test_kwarg_values_are_part_of_the_key():
    """The reference keys on kwarg names and bakes the first call's
    values; the port keys on the values too."""
    def f(x, scale=1.0):
        return x * scale

    sf, _ = _staged(jit.to_static(f))
    x = pt.to_tensor(np.ones(2, np.float32))
    assert sf(x, scale=2.0).numpy().tolist() == [2.0, 2.0]
    assert sf(x, scale=3.0).numpy().tolist() == [3.0, 3.0]
    assert len(sf._cache) == 2


def test_host_values_reach_a_capture_through_recorded_constants():
    calls = [0]

    def f(x):
        return x * 2.0 + pt.to_tensor(np.arange(3, dtype=np.float32))

    sf, _ = _staged(jit.to_static(f))
    x = pt.to_tensor(np.ones(3, np.float32))
    for _ in range(3):
        np.testing.assert_array_equal(sf(x).numpy(), [2.0, 3.0, 4.0])
    (info,) = sf.routes.values()
    assert info["constants"] == 2

    def g(x):
        calls[0] += 1  # a host array the warm-up never made
        return x + pt.to_tensor(np.arange(3, dtype=np.float32) * calls[0])

    def h(x):
        calls[0] += 1  # a single host value the warm-up never made
        return x + pt.to_tensor(np.float32(calls[0]))

    for fn in (g, h):
        sg, _ = _staged(jit.to_static(fn))
        sg(x)
        with pytest.raises(Dy2StaticError, match="warm-up"):
            sg(x)


def test_a_compiled_call_inside_another_is_inlined():
    def triple(x):
        return x * 3.0

    inner, _ = _staged(jit.to_static(triple))

    def outer(x):
        return inner(x) + 1.0

    sf, _ = _staged(jit.to_static(outer))
    x = pt.to_tensor(np.ones(2, np.float32))
    for _ in range(3):
        assert sf(x).numpy().tolist() == [4.0, 4.0]
    assert len(inner._cache) == 0  # inlined: no entry of its own


def test_the_export_path_stands_alone(tmp_path):
    """``jit``, ``jit.dy2static``, ``io.fs`` and the codec import neither
    jax, nor protobuf, nor the JAX package: with all three unimportable a
    tensor loop compiles and a model saves, loads and runs."""
    import textwrap

    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "paddle_tpu", "google.protobuf"):
            sys.modules[name] = None  # any import of them now fails
        import numpy as np
        import paddle_tpu_torch as pt
        from paddle_tpu_torch import jit, nn
        from paddle_tpu_torch.framework import _proto
        from paddle_tpu_torch.io import fs
        from paddle_tpu_torch.jit import dy2static
        pt.set_device("cpu")

        def f(x, n):
            i = pt.to_tensor(np.int32(0))
            while i < n:
                x = x * 2.0
                i = i + 1
            return x

        sf = jit.to_static(f)
        sf.staged = True
        for _ in range(3):
            out = sf(pt.to_tensor(np.float32(1)), pt.to_tensor(np.int32(3)))
            assert float(out) == 8.0
        net = nn.Linear(4, 2)
        net.eval()
        jit.save(net, {str(tmp_path / "m")!r},
                 input_spec=[jit.InputSpec([None, 4], "float32")])
        x = np.ones((3, 4), np.float32)
        got = jit.load({str(tmp_path / "m")!r})(x).numpy()
        assert np.allclose(got, net(pt.to_tensor(x)).numpy())
        assert not any(k.split(".")[0] in ("jax", "paddle_tpu")
                       or k.startswith("google.protobuf")
                       for k, v in sys.modules.items() if v is not None)
        print("ISOLATED_OK")
    """)
    script = tmp_path / "standalone.py"  # a file: the transform reads it
    script.write_text(code)
    env = torch_threads.subprocess_env(PYTHONPATH=_REPO)
    out = subprocess.run([sys.executable, str(script)], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "ISOLATED_OK" in out.stdout
