"""The port's ``vision`` package against the JAX package's.

- Models: LeNet (1 x 28 x 28), resnet18 and MobileNet v1 and v2, fp32:
  the JAX package's initial weights, BatchNorm's running mean and
  variance included, go into the port (``weights.layer_from_numpy``);
  the eval forward at 3 x 32 x 32, batch 2 (running statistics), and the
  training forward at 3 x 64 x 64, batch 4 (batch statistics, after which
  every running mean and variance has moved), agree at rtol 1e-4 with an
  atol of 1e-4 of the reference output's largest magnitude, and so do the
  moved statistics.
- resnet50 (1000 classes): 267 parameter tensors, 25,610,152 values; 161
  trainable with 25,557,032, and BatchNorm's 106 running statistics, in
  both packages; one forward at 1 x 3 x 64 x 64 is finite.
- ``Model.fit``: LeNet 3 steps on fake MNIST (Adam), and a conv,
  BatchNorm and linear head 4 steps under Momentum 0.9 with L2 decay
  (``_fit``): the losses (1e-4 absolute) and every final parameter and
  statistic at the tolerance above.
- ``Model.fit`` of the smoke's ``vision_fit`` recipe (Momentum 0.9,
  ``weight_decay=L2Decay(1e-4)``), one step at a time (``_stepwise``):
  before each step the port takes the reference's parameters, running
  statistics and Momentum velocity, and after it its loss (1e-4) and
  every parameter and statistic must be the reference's: the first
  resnet18 step at the tolerance above, each step's update within
  ``STEPWISE``'s limit of the reference's. A free run cannot be held
  that way: at batch 4 x 64 x 64
  a rounding apart after the first step (4e-5 of an update) grows to 1%
  of an update at the second and 20% at the third in both packages' runs
  (ReLU units near 0 flip). Cases: resnet18 (10 classes) at
  ``chip_smoke._VISION_LR``, two steps over two batches of 4 x 3 x 64 x
  64 (the second step's update carries the first one's velocity); and
  resnet50 (1000 classes) at the recipe's own rate 0.1 on one batch of 8
  x 3 x 64 x 64 for 8 steps, the witness that the reference's loss climbs
  at that rate as the card's did (7.6 to 14.1 at batch 64 x 224 x 224,
  which is why ``vision_fit`` runs at 0.025), with the port taking the
  same steps.
- Datasets (``backend="fake"``) give the JAX package's arrays, and the
  transforms its outputs.

The JAX package computes its side in one subprocess for the module, as
``tests/test_torch_nn.py`` does.
"""
import torch_threads  # noqa: F401 (one torch thread a worker)
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import chip_smoke  # noqa: E402
import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import vision  # noqa: E402
from paddle_tpu_torch.framework import core  # noqa: E402
from paddle_tpu_torch.weights import layer_from_numpy  # noqa: E402

RTOL = 1e-4
# (make, eval input shape, training input shape): a training forward
# normalizes by batch statistics, which at 1 x 1 cells and batch 2 (a
# 32 x 32 image's last stage) are so ill-conditioned that one rounding
# apart in a convolution moves the output at 1e-2; at 64 x 64 and batch
# 4 each statistic spans 16 values
MODELS = {
    "lenet": (lambda v: v.models.LeNet(), (2, 1, 28, 28), (2, 1, 28, 28)),
    "resnet18": (lambda v: v.models.resnet18(num_classes=10),
                 (2, 3, 32, 32), (4, 3, 64, 64)),
    "mobilenet_v1": (lambda v: v.models.mobilenet_v1(num_classes=10),
                     (2, 3, 32, 32), (4, 3, 64, 64)),
    "mobilenet_v2": (lambda v: v.models.mobilenet_v2(num_classes=10),
                     (2, 3, 32, 32), (4, 3, 64, 64)),
}


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


def _np(state):
    return {k: np.asarray(v, np.float32) for k, v in state.items()}


def _forwards(pkg, name, init=None):
    """(initial state, eval output, train output, state after the train
    forward) of one model."""
    make, eval_shape, train_shape = MODELS[name]
    net = make(pkg.vision)
    if init is not None:
        layer_from_numpy(net, init)
    start = _np(net.state_dict())
    r = np.random.RandomState(5)
    x = pkg.to_tensor(r.randn(*eval_shape).astype(np.float32))
    xt = pkg.to_tensor(r.randn(*train_shape).astype(np.float32))
    net.eval()
    with pkg.no_grad():
        ev = net(x).numpy()
        net.train()
        for sub in net.sublayers():
            if isinstance(sub, pkg.nn.Dropout):  # the draws differ
                sub.eval()
        tr = net(xt).numpy()
    return start, ev, tr, _np(net.state_dict())


def _samples(n, image_shape, classes, seed):
    r = np.random.RandomState(seed)
    return [(r.randn(*image_shape).astype(np.float32),
             np.asarray([r.randint(classes)], np.int64)) for _ in range(n)]


def _conv_bn(pkg):
    nn = pkg.nn
    return nn.Sequential(nn.Conv2D(3, 8, 3, padding=1), nn.BatchNorm2D(8),
                         nn.ReLU(), nn.AdaptiveAvgPool2D(1), nn.Flatten(),
                         nn.Linear(8, 10))


def _fit(pkg, name, init=None):
    """(initial state, losses, final state) of ``Model.fit``: LeNet 3
    steps of Adam over fake MNIST; ``conv_bn_momentum`` (``_conv_bn``) 4
    steps of the recipe's Momentum 0.9 at lr 0.1 with a strong L2 decay
    (0.05, so that the decay moves each update by a share the tolerance
    sees) over 4 batches of 16 x 3 x 8 x 8, each BatchNorm statistic
    spanning 1,024 values: conditioned well enough that a free run is held
    step for step."""
    if name == "lenet":
        net = MODELS["lenet"][0](pkg.vision)
        ds = pkg.vision.datasets.MNIST(mode="train", backend="fake")
        data, batch = [ds[i] for i in range(6)], 2
        opt = pkg.optimizer.Adam(learning_rate=1e-3,
                                 parameters=net.parameters())
        metrics = None
    else:
        net = _conv_bn(pkg)
        data, batch = _samples(64, (3, 8, 8), 10, seed=12), 16
        opt = pkg.optimizer.Momentum(
            learning_rate=0.1, momentum=0.9, parameters=net.parameters(),
            weight_decay=pkg.regularizer.L2Decay(0.05))
        metrics = pkg.metric.Accuracy()
    if init is not None:
        layer_from_numpy(net, init)
    start = _np(net.state_dict())
    model = pkg.Model(net)
    model.prepare(opt, pkg.nn.CrossEntropyLoss(), metrics=metrics)
    losses = []

    class Log(pkg.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            loss = (logs or {}).get("loss")
            losses.append(float(np.asarray(loss).reshape(-1)[0]))

    model.fit(data, batch_size=batch, epochs=1, shuffle=False, verbose=0,
              callbacks=[Log()])
    return start, np.asarray(losses), _np(net.state_dict())


# (architecture, classes, learning rate, batch, image size, steps, one
# batch repeated, update limit): resnet18 at the smoke's rate; resnet50 at
# the recipe's own 0.1, at which the card's loss climbed. The update
# limit bounds each step's worst parameter or statistic as
# ``chip_smoke._leaves_agree`` reads it (||port's update - reference's|| /
# (||reference's|| + 1e-4 of the largest)). These batches are small for
# BatchNorm (resnet50's last stage normalizes 8 x 2 x 2 values a channel),
# so a step's update is ill-conditioned: roundings apart in the forward
# show in it at a few percent. Sound, the worst steps read 5.6e-2
# (resnet50, step 1) and 4.8e-3 (resnet18, step 2); a Momentum without
# its velocity or a gradient 2^15 too large reads O(1) and more.
STEPWISE = {
    "resnet18": ("resnet18", 10, chip_smoke._VISION_LR, 4, 64, 2, False,
                 2e-2),
    "resnet50_lr0.1": ("resnet50", 1000, 0.1, 8, 64, 8, True, 0.25),
}


def _excess(got, want) -> float:
    """The largest |got - want| beyond ``_close``'s tolerance (<= 0
    passes)."""
    atol = RTOL * max(float(np.abs(want).max(initial=0.0)), 1.0)
    return float((np.abs(got - want) - atol - RTOL * np.abs(want))
                 .max(initial=-atol))


def _stepwise(pd, case):
    """Run with both packages: ``Model.fit`` of the ``vision_fit`` recipe
    one step at a time in the reference; before each step the port's
    model takes the reference's state (``layer_from_numpy``) and Momentum
    velocity (``weights.optimizer_from_numpy``) and takes the same step.
    Returns the reference's losses, the port's, and per step the largest
    excess of the port's state over ``_close``'s tolerance and its leaf."""
    from paddle_tpu_torch.weights import optimizer_from_numpy

    arch, classes, lr, batch, size, steps, repeat, _ = STEPWISE[case]
    data = _samples(batch * (1 if repeat else steps), (3, size, size),
                    classes, seed=11)

    def build(pkg):
        net = getattr(pkg.vision.models, arch)(num_classes=classes)
        opt = pkg.optimizer.Momentum(
            learning_rate=lr, momentum=0.9, parameters=net.parameters(),
            weight_decay=pkg.regularizer.L2Decay(1e-4))
        model = pkg.Model(net)
        model.prepare(opt, pkg.nn.CrossEntropyLoss(),
                      metrics=pkg.metric.Accuracy())
        return net, opt, model

    def step(pkg, model, chunk):
        losses = []

        class Log(pkg.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                loss = (logs or {}).get("loss")
                losses.append(float(np.asarray(loss).reshape(-1)[0]))

        model.fit(chunk, batch_size=batch, epochs=1, shuffle=False,
                  verbose=0, callbacks=[Log()])
        return losses[0]

    (rnet, ropt, rmodel), (tnet, topt, tmodel) = build(pd), build(pt)
    ref, port, excess, leaf, update = [], [], [], [], []
    for k in range(steps):
        chunk = data if repeat else data[k * batch:(k + 1) * batch]
        before = _np(rnet.state_dict())
        layer_from_numpy(tnet, before)
        velocity = ropt._accumulators.get("velocity", {})
        if velocity:
            optimizer_from_numpy(topt, tnet, {"velocity": {
                q: np.asarray(velocity[p.name].numpy())
                for q, p in rnet.named_parameters() if p.name in velocity}})
        ref.append(step(pd, rmodel, chunk))
        port.append(step(pt, tmodel, chunk))
        want, got = _np(rnet.state_dict()), _np(tnet.state_dict())
        worst = max(want, key=lambda n: _excess(got[n], want[n]))
        excess.append(_excess(got[worst], want[worst]))
        leaf.append(worst)
        update.append(chip_smoke._leaves_agree(
            *({n: torch.from_numpy(after[n].astype(np.float64) - before[n])
               for n in want} for after in (got, want)),
            float("inf"), "update")["worst"])
    return {"ref_losses": np.asarray(ref), "port_losses": np.asarray(port),
            "excess": np.asarray(excess), "leaf": np.asarray(leaf),
            "update": np.asarray(update)}


def _reference_main(out):
    """Run in a subprocess: the JAX package's results, and the stepwise
    runs with both packages (``_stepwise``), saved to ``out``."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import paddle_tpu as pd

    pt.set_device("cpu")
    res = {}
    for name in MODELS:
        start, ev, tr, after = _forwards(pd, name)
        res.update({f"{name}/init/{k}": v for k, v in start.items()})
        res.update({f"{name}/after/{k}": v for k, v in after.items()})
        res[f"{name}/eval"], res[f"{name}/train"] = ev, tr
    for case in STEPWISE:
        res.update({f"step_{case}/{k}": v
                    for k, v in _stepwise(pd, case).items()})
    for name in ("lenet", "conv_bn_momentum"):
        start, losses, final = _fit(pd, name)
        res.update({f"fit_{name}/init/{k}": v for k, v in start.items()})
        res.update({f"fit_{name}/final/{k}": v for k, v in final.items()})
        res[f"fit_{name}/losses"] = losses
    ps = pd.vision.models.resnet50(num_classes=1000).parameters()
    res["resnet50/counts"] = np.asarray([
        len(ps), sum(int(np.prod(p.shape)) for p in ps),
        sum(1 for p in ps if p.trainable),
        sum(int(np.prod(p.shape)) for p in ps if p.trainable)])
    np.savez(out, **res)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("vision_ref") / "ref.npz")
    code = (f"import importlib.util, sys; sys.path.insert(0, {_REPO!r}); "
            f"s = importlib.util.spec_from_file_location('t', {__file__!r});"
            f" m = importlib.util.module_from_spec(s); "
            f"s.loader.exec_module(m); m._reference_main({out!r})")
    env = torch_threads.subprocess_env(JAX_PLATFORMS="cpu", PYTHONPATH=_REPO)
    done = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=900)
    assert done.returncode == 0, done.stdout[-3000:] + done.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _part(reference, prefix):
    return {k[len(prefix):]: v for k, v in reference.items()
            if k.startswith(prefix)}


def _close(got, want, what):
    np.testing.assert_allclose(
        got, want, rtol=RTOL,
        atol=RTOL * max(float(np.abs(want).max(initial=0.0)), 1.0),
        err_msg=what)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_forward_matches_the_reference(reference, name):
    init = _part(reference, f"{name}/init/")
    start, ev, tr, after = _forwards(pt, name, init)
    assert sorted(start) == sorted(init)
    _close(ev, reference[f"{name}/eval"], "eval")
    _close(tr, reference[f"{name}/train"], "train")
    want = _part(reference, f"{name}/after/")
    stats = [k for k in want if k.endswith(("_mean", "_variance"))]
    assert (len(stats) > 0) == (name != "lenet")
    for k in stats:
        assert not np.array_equal(want[k], init[k]), k
        _close(after[k], want[k], k)


def test_resnet50_parameters_and_forward(reference):
    net = vision.models.resnet50(num_classes=1000)
    ps = net.parameters()
    counts = [len(ps), sum(int(np.prod(p.shape)) for p in ps),
              sum(1 for p in ps if p.trainable),
              sum(int(np.prod(p.shape)) for p in ps if p.trainable)]
    assert counts == reference["resnet50/counts"].tolist()
    assert counts == [267, 25610152, 161, 25557032]
    x = pt.to_tensor(np.random.RandomState(0).randn(1, 3, 64, 64)
                     .astype(np.float32))
    net.eval()
    with pt.no_grad():
        out = net(x).numpy()
    assert out.shape == (1, 1000) and np.isfinite(out).all()


@pytest.mark.parametrize("name", ["lenet", "conv_bn_momentum", "resnet18"])
def test_model_fit_matches_the_reference(reference, name):
    if name in STEPWISE:
        got = _stepwise_agrees(reference, name)
        # the first step, from the reference's initial state, holds every
        # parameter and statistic as the one-step run did
        assert got["excess"][0] <= 0.0, (got["excess"][0], got["leaf"][0])
        return
    init = _part(reference, f"fit_{name}/init/")
    _, losses, final = _fit(pt, name, init)
    np.testing.assert_allclose(losses, reference[f"fit_{name}/losses"],
                               rtol=RTOL, atol=RTOL)
    want = _part(reference, f"fit_{name}/final/")
    assert sorted(final) == sorted(want)
    for k, w in want.items():
        _close(final[k], w, k)


@pytest.mark.parametrize("name,mode", [("MNIST", "train"), ("MNIST", "test"),
                                       ("FashionMNIST", "train"),
                                       ("Cifar10", "train"),
                                       ("Cifar100", "test")])
def test_fake_datasets_match_the_reference(name, mode):
    from paddle_tpu.vision import datasets as jdatasets

    got = getattr(vision.datasets, name)(mode=mode, backend="fake")
    want = getattr(jdatasets, name)(mode=mode, backend="fake")
    assert len(got) == len(want)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    for i in (0, len(got) - 1):
        for g, w in zip(got[i], want[i]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_transforms_match_the_reference():
    from paddle_tpu.vision import transforms as jt

    tt = vision.transforms
    img = np.random.RandomState(2).randint(0, 256, (37, 29, 3)) \
        .astype(np.uint8)

    def pipeline(t):
        return [
            t.Compose([t.Resize(24), t.CenterCrop(20), t.ToTensor(),
                       t.Normalize([0.5, 0.4, 0.3], [0.2, 0.25, 0.3])]),
            t.Compose([t.Resize((16, 12), interpolation="nearest"),
                       t.Transpose()]),
            t.Compose([t.RandomCrop(20, padding=2),
                       t.RandomHorizontalFlip(0.5),
                       t.Normalize(127.0, 60.0, data_format="HWC")]),
        ]

    for g, w in zip(pipeline(tt), pipeline(jt)):
        for seed in range(3):
            random.seed(seed)
            got = g(img)
            random.seed(seed)
            np.testing.assert_array_equal(got, w(img))


def _stepwise_agrees(reference, case):
    """Each step's loss at ``RTOL`` and update within the case's limit;
    returns the case's arrays."""
    got = _part(reference, f"step_{case}/")
    assert len(got["ref_losses"]) == STEPWISE[case][5]
    np.testing.assert_allclose(got["port_losses"], got["ref_losses"],
                               rtol=RTOL, atol=RTOL)
    assert got["update"].max() <= STEPWISE[case][7], got["update"].tolist()
    return got


def test_resnet50_at_the_recipes_rate_climbs_in_the_reference(reference):
    """The witness for ``vision_fit``'s rate: at 0.1 the reference's own
    loss on one batch climbs above its first step's, as the card's did,
    and the port takes each of its 8 steps."""
    _stepwise_agrees(reference, "resnet50_lr0.1")
    losses = reference["step_resnet50_lr0.1/ref_losses"]
    print("resnet50 lr 0.1, reference losses:", losses.tolist(),
          "port from the reference's state:",
          reference["step_resnet50_lr0.1/port_losses"].tolist(),
          "update:", reference["step_resnet50_lr0.1/update"].tolist())
    assert losses.max() > 2 * losses[0], losses
