"""``Model.fit`` of the port against the JAX package, and the fit loop's
checkpoints.

The model is ``chip_smoke._masked_lm``, the eager path's masked-LM
encoder, here at 2 layers, d 256, 4 heads (head_dim 64, the smallest
that either package's flash route takes), vocab 256, seq 128, batch 2,
dropout 0, written once against either package's ``nn`` API. The JAX
package computes its results in a subprocess (one for the module), so a
JAX static-mode leak in this worker cannot turn them; it writes its
initial weights, which the port takes through
``weights.layer_from_numpy``. With ``PADDLE_TPU_FLASH_MIN_SEQ=64`` in both
processes attention takes the flash route (the plain versions on the
CPU, the pallas kernels in interpret mode on the JAX side).

The port's loss is ``F.cross_entropy(logits, labels, ignore_index=-100)``
as the eager path writes it. The JAX package's rule counts a label of
-100 (ROADMAP, kept differences), so its side computes the same function
as the mean over positions of the per-position loss on labels clipped to
0, times the mask of the labels that are not -100.

The checkpoint scenarios are ``tests/test_checkpoint_recovery.py``'s, run
on the port.
"""
import torch_threads  # noqa: F401 (one torch thread a worker)
import contextlib
import glob
import os
import subprocess
import sys

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import chip_smoke  # noqa: E402
import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import checkpoint as ckpt_mod  # noqa: E402
from paddle_tpu_torch import errors, nn  # noqa: E402
from paddle_tpu_torch.framework import core  # noqa: E402
from paddle_tpu_torch.hapi.model import Model  # noqa: E402
from paddle_tpu_torch.optimizer import Adam  # noqa: E402
from paddle_tpu_torch.weights import layer_from_numpy  # noqa: E402

CFG = dict(vocab=256, seq=128, d_model=256, n_head=4, n_layer=2,
           dropout=0.0)
# Adam at lr 1e-3 and, as the flash legs do (ROADMAP, kept differences),
# epsilon 1e-5: Adam turns a gradient that cancels to rounding noise into
# a step of about lr whatever its size
BATCH, STEPS, LR, EPS = 2, 3, 1e-3, 1e-5
FP32 = dict(rtol=1e-4, atol=1e-5)
BF16_RTOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _eager_on_cpu():
    """Dygraph mode (the default, which a static file in this worker may
    have left off) on the CPU place; restores both."""
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


def _data():
    ids, labels = chip_smoke._mlm_batch(CFG["vocab"], BATCH, CFG["seq"],
                                        seed=3)
    return ids, labels


def _masked_mean_ce(pkg):
    """The masked-LM loss as the JAX package computes it correctly: the
    per-position CE on labels clipped to 0, times the mask of labels
    that are not -100, averaged over every position."""
    F = pkg.nn.functional

    def loss(logits, labels):
        kept = pkg.greater_equal(labels, pkg.zeros_like(labels))
        safe = pkg.multiply(labels, pkg.cast(kept, "int64"))
        keep = pkg.cast(kept, "float32")
        per = F.cross_entropy(logits, safe, reduction="none")
        return pkg.mean(pkg.multiply(pkg.reshape(per, list(keep.shape)),
                                     keep))

    return loss


def _fit(pkg, net, loss, amp):
    ids, labels = _data()
    data = [(ids[i % BATCH], labels[i % BATCH])
            for i in range(STEPS * BATCH)]
    model = pkg.Model(net)
    model.prepare(pkg.optimizer.Adam(learning_rate=LR, epsilon=EPS,
                                     parameters=net.parameters()), loss)
    rec = chip_smoke._step_log(pkg)
    ctx = (pkg.amp.auto_cast(dtype="bfloat16") if amp
           else contextlib.nullcontext())
    with ctx:
        model.fit(data, batch_size=BATCH, epochs=1, shuffle=False,
                  verbose=0, callbacks=[rec])
    return rec.losses, net.state_dict()


def _reference_main(out):
    """Run in a subprocess: the JAX package's fits, saved to ``out``."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import paddle_tpu as pd
    from paddle_tpu.ops import attention as jatt

    net = chip_smoke._masked_lm(pd, **CFG)
    init = {k: np.asarray(v) for k, v in net.state_dict().items()}
    res = {f"init/{k}": v for k, v in init.items()}
    before = jatt.FLASH_DISPATCH_COUNT
    losses, final = _fit(pd, net, _masked_mean_ce(pd), False)
    res["fp32/losses"] = np.asarray(losses)
    res["fp32/flash"] = np.asarray(jatt.FLASH_DISPATCH_COUNT - before)
    for k, v in final.items():
        res[f"fp32/final/{k}"] = np.asarray(v)
    # the same fit under auto_cast: the JAX package's eager backward
    # re-runs each op on its uncast inputs, and the VJP of a matmul in
    # fp32 refuses the bf16 cotangent
    net.set_state_dict(init)
    try:
        _fit(pd, net, _masked_mean_ce(pd), True)
        res["bf16/error"] = np.asarray("")
    except Exception as e:  # noqa: BLE001 - the error is the result
        res["bf16/error"] = np.asarray(f"{type(e).__name__}: {e}"[:2000])
    np.savez(out, **res)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("hapi_ref") / "ref.npz")
    code = (f"import importlib.util, sys; sys.path.insert(0, {_REPO!r}); "
            f"s = importlib.util.spec_from_file_location('t', {__file__!r});"
            f" m = importlib.util.module_from_spec(s); "
            f"s.loader.exec_module(m); m._reference_main({out!r})")
    env = torch_threads.subprocess_env(
        JAX_PLATFORMS="cpu", PADDLE_TPU_FLASH_MIN_SEQ="64", PYTHONPATH=_REPO)
    done = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stdout[-3000:] + done.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _port_fit(reference, amp, monkeypatch):
    from paddle_tpu_torch.ops import attention

    monkeypatch.setenv("PADDLE_TPU_FLASH_MIN_SEQ", "64")
    init = {k[len("init/"):]: v for k, v in reference.items()
            if k.startswith("init/")}
    net = layer_from_numpy(chip_smoke._masked_lm(pt, **CFG), init)
    before = attention.FLASH_DISPATCH_COUNT
    losses, final = _fit(pt, net, chip_smoke._mlm_loss(pt), amp)
    return losses, final, attention.FLASH_DISPATCH_COUNT - before


def test_fit_fp32_matches_the_reference(reference, monkeypatch):
    losses, final, flash = _port_fit(reference, False, monkeypatch)
    assert flash == STEPS * CFG["n_layer"]
    assert int(reference["fp32/flash"]) > 0
    np.testing.assert_allclose(losses, reference["fp32/losses"], **FP32)
    assert len(final) == 2 + 16 * CFG["n_layer"] + 4
    for k, v in final.items():
        np.testing.assert_allclose(v, reference[f"fp32/final/{k}"], **FP32,
                                   err_msg=k)


def test_fit_bf16_autocast_is_held_to_the_reference_fp32(reference,
                                                        monkeypatch):
    """Under ``auto_cast(bfloat16)`` (O1) the port's matmuls and attention
    run in bf16, forward and backward (the flash route in bf16), with fp32
    parameters and Adam state. The JAX package cannot run this fit (next
    test), so the port's bf16 fit is held to the reference's fp32 one: the
    losses at rtol 2e-2, and each parameter's update (final - initial)
    within 10% relative (Frobenius) of the reference's. Adam moves an
    element by about lr a step whatever its gradient's size, so a bf16
    gradient near 0 may take the other sign: the key biases, whose
    gradient is 0 in exact arithmetic (softmax ignores a shift common to a
    row's scores), move by rounding noise on both sides and are only held
    to Adam's largest move, lr a step."""
    losses, final, flash = _port_fit(reference, True, monkeypatch)
    assert flash == STEPS * CFG["n_layer"]
    np.testing.assert_allclose(losses, reference["fp32/losses"],
                               rtol=BF16_RTOL)
    for k, v in final.items():
        init, want = reference[f"init/{k}"], reference[f"fp32/final/{k}"]
        assert v.dtype == np.float32, k
        if k.endswith("k_proj.bias"):
            assert np.abs(v - init).max() <= STEPS * LR * (1 + 1e-3), k
            continue
        moved, want_moved = v - init, want - init
        rel = (np.linalg.norm(moved - want_moved)
               / np.linalg.norm(want_moved))
        assert rel <= 0.1, (k, rel)


def test_reference_eager_autocast_backward_raises(reference):
    """Kept difference: the JAX package's eager backward differentiates a
    re-run of each op on the tape's uncast values, so under ``auto_cast``
    the VJP of a bf16 matmul re-run in fp32 refuses the bf16 cotangent and
    ``loss.backward()`` raises; the port records each op's own bf16 run
    (the cast inside the record) and trains (previous test)."""
    err = str(reference["bf16/error"])
    assert "matmul" in err and "bfloat16" in err and "float32" in err, err


def test_fit_loss_falls_and_reference_losses_are_the_masked_mean(reference):
    """The reference's losses fall over the 3 steps, and its first loss is
    the port's ``F.cross_entropy(ignore_index=-100)`` on the initial
    weights (no update yet)."""
    assert reference["fp32/losses"][-1] < reference["fp32/losses"][0]
    init = {k[len("init/"):]: v for k, v in reference.items()
            if k.startswith("init/")}
    net = layer_from_numpy(chip_smoke._masked_lm(pt, **CFG), init)
    ids, labels = _data()
    with pt.no_grad():
        got = float(chip_smoke._mlm_loss(pt)(net(pt.to_tensor(ids)),
                                             pt.to_tensor(labels)))
        masked = float(_masked_mean_ce(pt)(net(pt.to_tensor(ids)),
                                           pt.to_tensor(labels)))
    assert got == pytest.approx(masked, rel=1e-6)
    assert got == pytest.approx(float(reference["fp32/losses"][0]),
                                rel=1e-4)


def test_data_parallel_network_waits_for_a10():
    net = nn.Linear(2, 1)
    net.scale_loss = lambda loss: loss
    net.apply_collective_grads = lambda: None
    model = Model(net)
    model.prepare(Adam(parameters=net.parameters()),
                  lambda p, y: ((p - y) ** 2).mean())
    with pytest.raises(errors.Unimplemented, match="A10"):
        model.train_batch([np.ones((1, 2), np.float32)],
                          np.ones((1, 1), np.float32))


def test_evaluate_predict_save_load(tmp_path):
    model = _build_model()
    ds = _dataset(8)
    model.fit(ds, batch_size=4, epochs=1, shuffle=False, verbose=0)
    ev = model.evaluate(ds, batch_size=4, verbose=0)
    assert np.isfinite(ev["eval_loss"])
    preds = model.predict([(x,) for x, _ in ds], batch_size=4,
                          stack_outputs=True)
    assert preds[0].shape == (8, 1)
    path = str(tmp_path / "m")
    model.save(path)
    other = _build_model(seed=9)
    other.load(path)
    for (k, a), (_, b) in zip(model.network.state_dict().items(),
                              other.network.state_dict().items()):
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_optimizer_from_numpy_continues_where_the_state_was_taken():
    """``weights.optimizer_from_numpy`` seeds an eager Adam's moments by
    structured parameter name: a model given another's parameters and
    Adam state takes the same next step, bit for bit."""
    from paddle_tpu_torch.weights import optimizer_from_numpy

    ds = _dataset(8)
    first = _build_model()
    first.fit(ds[:4], batch_size=4, epochs=1, shuffle=False, verbose=0)
    params = first.network.state_dict()
    names = {p.name: qual for qual, p in first.network.named_parameters()}
    accs = {slot: {names[pname]: acc.numpy()
                   for pname, acc in per.items()}
            for slot, per in first._optimizer._accumulators.items()}
    second = _build_model(seed=9)
    layer_from_numpy(second.network, params)
    optimizer_from_numpy(second._optimizer, second.network, accs)
    for m in (first, second):
        m.fit(ds[4:], batch_size=4, epochs=1, shuffle=False, verbose=0)
    for (k, a), (_, b) in zip(first.network.state_dict().items(),
                              second.network.state_dict().items()):
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_summary_counts_parameters_and_footprint(capsys):
    net = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2))
    info = pt.summary(net, input_size=(-1, 4))
    assert info["total_params"] == 4 * 8 + 8 + 8 * 2 + 2
    assert info["trainable_params"] == info["total_params"]
    assert info["param_bytes"] == 4 * info["total_params"]
    out = capsys.readouterr().out
    assert "Linear" in out and "[1, 8]" in out


def test_async_loss_reads_once_and_floats():
    from paddle_tpu_torch.hapi.model import _LazyLossValue

    lazy = _LazyLossValue(pt.to_tensor(np.float32(2.5)))
    assert float(lazy) == 2.5 and f"{lazy:.1f}" == "2.5"
    assert lazy + 1 == 3.5 and lazy < 3 and lazy._host is None


# -- the checkpoint scenarios of tests/test_checkpoint_recovery.py ----------


def _build_model(seed=3):
    net = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 1))
    rng = np.random.RandomState(seed)
    for p in net.parameters():
        p.set_value(rng.uniform(-0.1, 0.1, p.shape).astype(np.float32))
    model = Model(net)
    model.prepare(Adam(learning_rate=0.01, parameters=net.parameters()),
                  loss=lambda pred, y: ((pred - y) ** 2).mean())
    return model


def _dataset(n=32):
    r = np.random.RandomState(5)
    x = r.randn(n, 8).astype(np.float32)
    y = (x[:, :1] * 2).astype(np.float32)
    return [(x[i], y[i]) for i in range(n)]


@pytest.fixture
def ckpt_env(tmp_path, monkeypatch):
    d = str(tmp_path / "ckpt")
    monkeypatch.setenv("PADDLE_TPU_CKPT_DIR", d)
    monkeypatch.setenv("PADDLE_TPU_CKPT_STEPS", "4")
    monkeypatch.setenv("PADDLE_TPU_CKPT_KEEP", "2")
    return d


def test_roundtrip_bit_identical(ckpt_env):
    model = _build_model()
    model.fit(_dataset(), batch_size=4, epochs=1, shuffle=False, verbose=0)
    ck = ckpt_mod.TrainCheckpointer(ckpt_env)
    path = ckpt_mod.latest_path(ckpt_env)
    assert path and path.endswith("step00000008.pdz")
    doc = ckpt_mod.load(path)
    assert doc["step"] == 8
    assert doc["data_cursor"] == {"epoch": 0, "step_in_epoch": 8}
    fresh = _build_model()
    assert ck.restore(fresh.network, fresh._optimizer, doc) == 8
    assert ck.current_digest(fresh.network, fresh._optimizer) \
        == doc["digest"]
    moments = fresh._optimizer._accumulators.get("moment1", {})
    assert moments and any(float(m._value.abs().sum()) > 0
                           for m in moments.values())


@pytest.mark.parametrize("shuffle", [False, True])
def test_resumed_fit_matches_uninterrupted_run(ckpt_env, shuffle):
    ds = _dataset()
    np.random.seed(1234)
    full = _build_model()
    full.fit(ds, batch_size=4, epochs=2, shuffle=shuffle, verbose=0)
    ck = ckpt_mod.TrainCheckpointer(ckpt_env)
    digest_full = ck.current_digest(full.network, full._optimizer)
    for p in glob.glob(os.path.join(ckpt_env, "*.pdz")):
        os.unlink(p)
    np.random.seed(1234)
    interrupted = _build_model()
    interrupted.fit(ds, batch_size=4, epochs=1, shuffle=shuffle, verbose=0)
    np.random.seed(999)  # the respawned process has unrelated RNG state
    resumed = _build_model()
    resumed.fit(ds, batch_size=4, epochs=2, shuffle=shuffle, verbose=0)
    assert resumed._global_step == 16
    assert ck.current_digest(resumed.network, resumed._optimizer) \
        == digest_full


def test_resume_draws_the_crashed_runs_dropout_masks(ckpt_env):
    """The port draws new dropout masks each step, so the checkpoint
    carries the tracer's (seed, step): a run with dropout, resumed from
    its step-4 checkpoint into a fresh model, ends bit-identical to the
    uninterrupted run (the chip's ``_eager_resume`` at a tiny size)."""
    res = chip_smoke._eager_resume(
        pt, dict(vocab=32, seq=16, d_model=16, n_head=2, n_layer=1,
                 dropout=0.3), 2, seed=4, steps=8,
        root=os.path.join(ckpt_env, "eager"))
    assert res["bit_identical"] and res["resumed_at"] == 4
    assert res["checkpoints"][0].endswith("step00000004.pdz")
    assert res["losses_full"][4:] == res["losses_resumed"]


def test_retention_window_sweeps(ckpt_env):
    model = _build_model()
    model.fit(_dataset(64), batch_size=4, epochs=1, shuffle=False,
              verbose=0)  # 16 steps, cadence 4 -> 4 saves, keep 2
    kept = sorted(os.path.basename(p)
                  for p in glob.glob(os.path.join(ckpt_env, "*.pdz")))
    assert kept == ["trainckpt.rank0.step00000012.pdz",
                    "trainckpt.rank0.step00000016.pdz"], kept
    assert not glob.glob(os.path.join(ckpt_env, "*.tmp.*"))


def test_maybe_save_respects_cadence(tmp_path):
    ck = ckpt_mod.TrainCheckpointer(str(tmp_path), every_steps=5, keep=3)
    model = _build_model()
    assert ck.maybe_save(model.network, model._optimizer, 3) is None
    assert ck.maybe_save(model.network, model._optimizer, 5) is not None
    assert ck.maybe_save(model.network, model._optimizer, 5) is None


def test_numpy_rng_cursor_roundtrips(tmp_path):
    model = _build_model()
    np.random.seed(42)
    np.random.rand(10)
    expected_next = np.random.get_state()
    np.random.set_state(expected_next)
    ck = ckpt_mod.TrainCheckpointer(str(tmp_path), every_steps=1)
    path = ck.save(model.network, model._optimizer, step=1)
    np.random.rand(100)
    ck.restore(model.network, model._optimizer, ckpt_mod.load(path))
    want = np.random.RandomState()
    want.set_state(expected_next)
    np.testing.assert_array_equal(np.random.rand(5), want.rand(5))


def test_alien_file_rejected_and_env_off(tmp_path, monkeypatch):
    import pickle

    p = str(tmp_path / "trainckpt.rank0.step00000001.pdz")
    with open(p, "wb") as f:
        pickle.dump({"schema": "something-else"}, f)
    with pytest.raises(ValueError):
        ckpt_mod.load(p)
    assert ckpt_mod.TrainCheckpointer(str(tmp_path)).load_latest() is None
    monkeypatch.delenv("PADDLE_TPU_CKPT_DIR", raising=False)
    assert ckpt_mod.from_env() is None


def test_dp_comms_residuals_wait_for_a10():
    model = _build_model()
    with pytest.raises(errors.Unimplemented, match="A10"):
        model._optimizer.set_state_dict({"__dp_comms__": {"x": 1}})

