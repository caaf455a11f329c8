"""The port stands alone: it imports neither jax nor paddle_tpu, and it
never falls back to the CPU on its own."""
import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _port_files():
    out = [os.path.join(_REPO, "chip_smoke.py")]
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
    assert len(files) > 10 and os.path.exists(files[0])
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
    env = dict(os.environ, PYTHONPATH=_REPO)
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
    env = dict(os.environ, PYTHONPATH=_REPO)
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
    """The JAX package's chunked lm-head CE, recompute and serialization
    wait for later slices and say so."""
    from paddle_tpu_torch import errors
    from paddle_tpu_torch.framework import registry
    from paddle_tpu_torch.framework.backward import (
        append_backward_with_checkpoints)

    x = torch.zeros((1, 2, 4))
    with pytest.raises(errors.Unimplemented, match="chunked"):
        registry.get_op_def("fused_lm_head_ce").lower(
            registry.LoweringContext("cpu"),
            {"X": [x], "W": [torch.zeros((8, 4))],
             "Label": [torch.zeros((1, 2), dtype=torch.int64)]},
            {"impl": "chunked"})
    with pytest.raises(errors.Unimplemented, match="recompute"):
        append_backward_with_checkpoints(None, [])
