"""The port stands alone: it imports neither jax nor paddle_tpu, and it
never falls back to the CPU on its own."""
import torch_threads  # noqa: F401 (one torch thread a worker)
import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch_modes import static_mode  # noqa: F401 (autouse fixture)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _port_files():
    out = [os.path.join(_REPO, "chip_smoke.py")]
    out += [os.path.join(_REPO, "tools", f)
            for f in os.listdir(os.path.join(_REPO, "tools"))
            if f.startswith("torch_") and f.endswith(".py")]
    for root, _, files in os.walk(os.path.join(_REPO, "paddle_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__"):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant):
                    yield str(arg.value)


def test_no_jax_or_paddle_tpu_import_anywhere_in_the_port():
    files = _port_files()
    assert len(files) > 10 and all(os.path.exists(f) for f in files[:2])
    assert any(f.endswith(os.path.join("tools", "torch_serve_replica.py"))
               for f in files)
    assert any(f.endswith(os.path.join("ops", "flash_attention.py"))
               for f in files)
    bad = [(os.path.relpath(f, _REPO), name) for f in files
           for name in _imported_roots(f)
           if name.split(".")[0] in _FORBIDDEN]
    assert bad == []


def test_port_serves_where_jax_cannot_be_imported():
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "paddle_tpu"):
            sys.modules[name] = None  # any import of them now fails
        import numpy as np
        import paddle_tpu_torch
        from paddle_tpu_torch import serving
        cfg = serving.GPTConfig(vocab_size=64, n_layer=1, n_head=2,
                                d_model=16, max_seq_len=32)
        m = serving.DecodeModel(cfg, max_batch=2, n_blocks=8, block_size=4,
                                prefill_buckets=[8, 16], device="cpu")
        eng = serving.ServingEngine(m)
        h = eng.submit([3, 1, 4, 1, 5], max_new_tokens=3)
        eng.run_until_idle()
        nll, total = m.score([3, 1, 4, 1, 5])
        assert len(h.result(timeout=5)) == 3 and np.isfinite(total)
        assert not any(k.split(".")[0] in ("jax", "paddle_tpu")
                       for k, v in sys.modules.items() if v is not None)
        print("ISOLATED_OK")
    """)
    env = torch_threads.subprocess_env(PYTHONPATH=_REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "ISOLATED_OK" in out.stdout


def test_no_device_and_no_card_raises(monkeypatch):
    """With no device named and no CUDA card the model refuses to start
    instead of quietly running on the CPU."""
    from paddle_tpu_torch import errors, serving

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = serving.GPTConfig(vocab_size=32, n_layer=1, n_head=2, d_model=8,
                            max_seq_len=16)
    with pytest.raises(errors.Unavailable, match="device='cpu'"):
        serving.DecodeModel(cfg, max_batch=1, n_blocks=4, block_size=4,
                            prefill_buckets=[8])
    with pytest.raises(errors.Unavailable):
        serving.DecodeModel(cfg, max_batch=1, n_blocks=4, block_size=4,
                            prefill_buckets=[8], device="cuda")


def test_port_trains_where_jax_cannot_be_imported():
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "paddle_tpu"):
            sys.modules[name] = None  # any import of them now fails
        import paddle_tpu_torch
        paddle_tpu_torch.enable_static()  # a static program; eager is the default
        import numpy as np
        from paddle_tpu_torch.framework import (CPUPlace, Executor, Scope,
                                                program_guard)
        from paddle_tpu_torch.models.gpt import (GPTConfig,
                                                 build_train_program)
        from paddle_tpu_torch.optimizer import Adam
        cfg = GPTConfig(vocab_size=64, n_layer=1, n_head=2, d_model=16,
                        max_seq_len=8)
        main, startup, io = build_train_program(cfg, batch=2, seq=8)
        with program_guard(main, startup):
            Adam(learning_rate=1e-3).minimize(io["loss"])
        scope, exe = Scope(), Executor(CPUPlace())
        exe.run(startup, scope=scope)
        toks = np.arange(16, dtype=np.int64).reshape(2, 8) % 64
        loss, = exe.run(main, feed={"tokens": toks, "labels": toks},
                        fetch_list=[io["loss"]], scope=scope)
        assert np.isfinite(loss) and io["lm_head_impl"] == "pallas"
        assert not any(k.split(".")[0] in ("jax", "paddle_tpu")
                       for k, v in sys.modules.items() if v is not None)
        print("TRAIN_ISOLATED_OK")
    """)
    env = torch_threads.subprocess_env(PYTHONPATH=_REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "TRAIN_ISOLATED_OK" in out.stdout


def test_executor_without_a_card_raises(monkeypatch):
    """Executor() means the card; with none it refuses instead of quietly
    running on the CPU."""
    from paddle_tpu_torch import errors
    from paddle_tpu_torch.framework import CPUPlace, CUDAPlace, Executor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(errors.Unavailable, match="CPUPlace"):
        Executor()
    with pytest.raises(errors.Unavailable):
        Executor(CUDAPlace(0))
    assert Executor(CPUPlace()).device == torch.device("cpu")


def _attention(t, monkeypatch, **env):
    from paddle_tpu_torch.framework import registry

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    q = torch.from_numpy(np.random.RandomState(t).randn(1, t, 1, 64)
                         .astype(np.float32))
    rule = registry.get_op_def("fused_attention_tpu").lower
    out = rule(registry.LoweringContext("cpu"), {"Q": [q], "K": [q],
                                                 "V": [q]},
               {"is_causal": True, "layout": "BTHD"})["Out"]
    return out, q


def test_attention_raises_where_the_reference_takes_flash(monkeypatch):
    """Where the JAX op takes its flash kernels (T >= 1024, head_dim 64,
    no mask) the port takes its own (the test keeps the name it had
    while the port raised there): FLASH_DISPATCH_COUNT rises, and the
    result is the einsum path's. At T = 512, and at T = 1024 under
    PADDLE_TPU_DISABLE_FLASH=1 (the reference's switch to the einsum
    path), the port takes the einsum path and the count stays."""
    from paddle_tpu_torch.ops import attention

    monkeypatch.delenv("PADDLE_TPU_DISABLE_FLASH", raising=False)
    monkeypatch.delenv("PADDLE_TPU_FLASH_MIN_SEQ", raising=False)
    count = attention.FLASH_DISPATCH_COUNT
    out, q = _attention(1024, monkeypatch)
    assert attention.FLASH_DISPATCH_COUNT == count + 1
    ref = attention._sdpa_einsum(q, q, q, is_causal=True, layout="BTHD")
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    out, _ = _attention(512, monkeypatch)
    assert out.shape == (1, 512, 1, 64)
    assert attention.FLASH_DISPATCH_COUNT == count + 1
    out, _ = _attention(1024, monkeypatch, PADDLE_TPU_DISABLE_FLASH="1")
    assert out.shape == (1, 1024, 1, 64)
    assert attention.FLASH_DISPATCH_COUNT == count + 1


def test_unported_paths_raise():
    """What still waits for a later slice says so: mesh programs and the
    rest of fleet (A10); program serialization, refused here until it was
    ported (A8b), now round-trips. The chunked lm-head
    CE and recompute, refused here until they were ported, now run (held
    against the JAX package in tests/test_torch_recipe.py); the chunked
    path's loss here is the materialized logits' CE."""
    from paddle_tpu_torch import errors
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework import CPUPlace, Executor, Program, Scope
    from paddle_tpu_torch.framework import registry

    # program serialization is ported: an empty program round-trips, and
    # malformed bytes raise the typed error
    data = Program().serialize_to_string()
    assert Program.parse_from_string(data).serialize_to_string() == data
    with pytest.raises(errors.InvalidArgument, match="malformed"):
        Program.parse_from_string(b"\xff")
    mesh = Program()
    mesh._mesh = object()
    with pytest.raises(errors.Unimplemented, match="A10"):
        Executor(CPUPlace()).run(mesh, scope=Scope())
    with pytest.raises(errors.Unimplemented, match="A10"):
        fleet.DistributedStrategy
    assert fleet.RecomputeOptimizer.__name__ == "RecomputeOptimizer"

    r = np.random.RandomState(0)
    x = torch.from_numpy(r.randn(1, 3, 4).astype(np.float32))
    w = torch.from_numpy(r.randn(8, 4).astype(np.float32))
    lbl = torch.tensor([[1, 7, 0]])
    loss = registry.get_op_def("fused_lm_head_ce").lower(
        registry.LoweringContext("cpu"),
        {"X": [x], "W": [w], "Label": [lbl]},
        {"impl": "chunked", "chunk_size": 2})["Loss"]
    logits = x[0] @ w.t()
    want = torch.logsumexp(logits, -1) - logits[range(3), lbl[0]]
    torch.testing.assert_close(loss.reshape(-1), want)


@pytest.mark.parametrize("op, item", [
    ("pool3d", "A11"), ("pool3d_grad", "A11"), ("lstm", "A11"),
    ("c_allreduce_sum", "A10"), ("alltoall", "A10"),
    ("c_broadcast_grad", "A10")])
def test_unregistered_op_names_its_queue_item(op, item):
    """An op with no lowering raises Unimplemented naming the ROADMAP
    queue item that ports it: the collectives A10, the rest A11."""
    from paddle_tpu_torch import errors
    from paddle_tpu_torch.framework import registry

    with pytest.raises(errors.Unimplemented, match=f"item {item}\\)"):
        registry.get_op_def(op)


_RECIPE_MODULES = ("nn/clip", "regularizer",
                   "distributed/fleet/meta_optimizers",
                   "ops/control_flow_ops")


def test_pretraining_recipe_stands_alone():
    """The recipe's modules are in the scan above, and a step of the
    recipe (dropout, recompute, AdamW with weight decay and a global-norm
    clip, replayed on the staged route) runs where jax and paddle_tpu
    cannot be imported."""
    files = _port_files()
    for mod in _RECIPE_MODULES:
        path = os.path.join(_REPO, "paddle_tpu_torch", mod + ".py")
        assert path in files, mod
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "paddle_tpu"):
            sys.modules[name] = None  # any import of them now fails
        import paddle_tpu_torch
        paddle_tpu_torch.enable_static()  # a static program; eager is the default
        import torch
        from paddle_tpu_torch.distributed.fleet import RecomputeOptimizer
        from paddle_tpu_torch.framework import (CPUPlace, Executor, Scope,
                                                program_guard, unique_name)
        from paddle_tpu_torch.models.gpt import (GPTConfig,
                                                 build_train_program)
        from paddle_tpu_torch.nn import ClipGradByGlobalNorm
        from paddle_tpu_torch.optimizer import AdamW
        with unique_name.guard():
            main, startup, io = build_train_program(GPTConfig(
                vocab_size=64, n_layer=2, n_head=2, d_model=16,
                max_seq_len=8, dropout=0.1), batch=2, seq=8)
            main.random_seed = 5
            with program_guard(main, startup):
                RecomputeOptimizer(AdamW(
                    learning_rate=1e-3, weight_decay=0.01,
                    grad_clip=ClipGradByGlobalNorm(1.0)), {"checkpoints": [
                        v.name for v in io["checkpoints"]]}).minimize(
                            io["loss"])
        scope, exe = Scope(), Executor(CPUPlace())
        exe.run(startup, scope=scope)
        exe.staged = True
        feed = {k: torch.randint(0, 64, (2, 8)) for k in ("tokens",
                                                          "labels")}
        for _ in range(3):
            loss, = exe.run(main, feed=feed, fetch_list=[io["loss"]],
                            scope=scope)
        assert exe.phases == {"eager": 1, "capture": 1, "replay": 1}
        assert not any(k.split(".")[0] in ("jax", "paddle_tpu")
                       for k, v in sys.modules.items() if v is not None)
        print("ISOLATED_OK")
    """)
    env = torch_threads.subprocess_env(PYTHONPATH=_REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "ISOLATED_OK" in out.stdout


_A9_MODULES = ("device", "memwatch", "dynamics", "recovery",
               "framework/xla_insight", "static/io",
               "incubate/checkpoint/auto_checkpoint")


def test_step_observability_stands_alone():
    """The step-side observability modules are in the scan above, and a
    training step with every one of their hooks on runs where jax and
    paddle_tpu cannot be imported."""
    files = _port_files()
    for mod in _A9_MODULES:
        path = os.path.join(_REPO, "paddle_tpu_torch", mod + ".py")
        assert path in files, mod
    code = textwrap.dedent("""
        import os, sys, tempfile
        for name in ("jax", "jaxlib", "paddle_tpu"):
            sys.modules[name] = None  # any import of them now fails
        import paddle_tpu_torch
        paddle_tpu_torch.enable_static()  # a static program; eager is the default
        tmp = tempfile.mkdtemp()
        os.environ["PADDLE_TPU_CHECK_NUMERICS"] = "1"
        os.environ["PADDLE_TPU_XLA_DUMP_DIR"] = tmp
        import torch
        from paddle_tpu_torch import (device, dynamics, goodput, memwatch,
                                      recovery, static, status)
        from paddle_tpu_torch.framework import (CPUPlace, Executor, Scope,
                                                program_guard, unique_name,
                                                xla_insight)
        from paddle_tpu_torch.incubate.checkpoint import auto_checkpoint
        from paddle_tpu_torch.models.gpt import (GPTConfig,
                                                 build_train_program)
        from paddle_tpu_torch.optimizer import Adam
        with unique_name.guard():
            main, startup, io = build_train_program(GPTConfig(
                vocab_size=64, n_layer=1, n_head=2, d_model=16,
                max_seq_len=8), batch=2, seq=8)
            with program_guard(main, startup):
                Adam(learning_rate=1e-3).minimize(io["loss"])
        scope, exe = Scope(), Executor(CPUPlace())
        exe.run(startup, scope=scope)
        feed = {k: torch.randint(0, 64, (2, 8)) for k in ("tokens",
                                                          "labels")}
        for epoch in auto_checkpoint.train_epoch_range(
                1, "iso", checkpoint_dir=tmp, exe=exe, program=main,
                scope=scope):
            loss, = exe.run(main, feed=feed, fetch_list=[io["loss"]],
                            scope=scope)
            dynamics.feed(loss=float(loss), grad_norm=dynamics.grad_health(
                [("w", scope.get("gpt.wte"))])[0])
            goodput.end_step(0.1)
        assert memwatch.totals()["steps"] == 1
        assert dynamics.totals()["steps"] == 1
        assert len(exe.compiled_insights()) == 2
        assert xla_insight.load_dump_dir(tmp)
        assert device.memory_stats("cpu")["source"] == "synthetic"
        assert not any(k.split(".")[0] in ("jax", "paddle_tpu")
                       for k, v in sys.modules.items() if v is not None)
        print("ISOLATED_OK")
    """)
    env = torch_threads.subprocess_env(PYTHONPATH=_REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "ISOLATED_OK" in out.stdout


_EAGER_MODULES = ("dygraph/__init__", "dygraph/varbase", "dygraph/tracer",
                  "dygraph/base", "ops/api", "amp/__init__",
                  "tensor/__init__", "tensor/math", "nn/__init__",
                  "nn/layers", "nn/common", "nn/transformer",
                  "nn/functional/__init__", "io/__init__",
                  "metric/__init__", "checkpoint", "callbacks",
                  "hapi/__init__", "hapi/model", "hapi/model_io")


def test_import_enables_dygraph_and_makes_no_cuda_context():
    """``import paddle_tpu_torch`` starts in dygraph mode, as the
    reference does, and touches no device: the tracer makes its lowering
    context at its first op."""
    code = textwrap.dedent("""
        import torch
        import paddle_tpu_torch
        from paddle_tpu_torch.framework import program
        assert paddle_tpu_torch.in_dygraph_mode()
        assert program._current_tracer() is not None
        assert program._current_tracer()._ctx is None
        assert not torch.cuda.is_initialized()
        print("EAGER_DEFAULT_OK")
    """)
    env = torch_threads.subprocess_env(PYTHONPATH=_REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "EAGER_DEFAULT_OK" in out.stdout


def test_eager_api_stands_alone(monkeypatch):
    """The eager API's modules are in the scan above; ``to_tensor`` and
    ``Model.fit`` on the default place (the card) raise where there is no
    card; and a fit of a small encoder runs on the CPU where jax and
    paddle_tpu cannot be imported."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import errors
    from paddle_tpu_torch.framework import core

    files = _port_files()
    for mod in _EAGER_MODULES:
        path = os.path.join(_REPO, "paddle_tpu_torch", mod + ".py")
        assert path in files, mod
    monkeypatch.delenv("PADDLE_TPU_DEFAULT_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    was_dygraph = pt.in_dygraph_mode()
    pt.disable_static()
    try:
        monkeypatch.setattr(core, "_default_place", core.CPUPlace())
        net = pt.nn.Linear(2, 1)  # made on the CPU, asked for
        model = pt.Model(net)
        model.prepare(pt.optimizer.Adam(parameters=net.parameters()),
                      lambda p, y: ((p - y) ** 2).mean())
        monkeypatch.setattr(core, "_default_place", None)  # the card
        with pytest.raises(errors.Unavailable):
            pt.to_tensor(np.ones(3, np.float32))
        with pytest.raises(errors.Unavailable):
            model.fit([(np.ones(2, np.float32), np.ones(1, np.float32))],
                      verbose=0)
    finally:
        if not was_dygraph:
            pt.enable_static()
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "paddle_tpu"):
            sys.modules[name] = None  # any import of them now fails
        import numpy as np
        import paddle_tpu_torch as pt
        pt.set_device("cpu")
        nn, F = pt.nn, pt.nn.functional
        net = nn.Sequential(nn.Embedding(16, 8), nn.TransformerEncoder(
            nn.TransformerEncoderLayer(8, 2, 16, dropout=0.1,
                                       activation="gelu",
                                       normalize_before=True), 1),
            nn.Linear(8, 16))
        model = pt.Model(net)
        model.prepare(pt.optimizer.Adam(learning_rate=1e-2,
                                        parameters=net.parameters()),
                      lambda p, y: F.cross_entropy(p, y))
        r = np.random.RandomState(0)
        data = [(r.randint(0, 16, 6), r.randint(0, 16, 6))
                for _ in range(8)]
        with pt.amp.auto_cast(dtype="bfloat16"):
            hist = model.fit(data, batch_size=4, epochs=2, verbose=0)
        assert np.isfinite(hist["loss"]).all()
        assert not any(k.split(".")[0] in ("jax", "paddle_tpu")
                       for k, v in sys.modules.items() if v is not None)
        print("ISOLATED_OK")
    """)
    env = torch_threads.subprocess_env(PYTHONPATH=_REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "ISOLATED_OK" in out.stdout
