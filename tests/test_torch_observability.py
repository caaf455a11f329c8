"""The port's observability planes on the CPU: the profiler's device trace
(``torch.profiler`` where the JAX package used ``jax.profiler``) and the
serving engine's lifecycle spans and ledger windows."""
import json

import torch

from paddle_tpu_torch import profiler, serving
from paddle_tpu_torch.serving import ledger


def test_device_trace_exports_a_chrome_trace(tmp_path):
    profiler.start_profiler(profile_dir=str(tmp_path))
    try:
        with profiler.RecordEvent("matmul"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    finally:
        profiler.stop_profiler(print_table=False)
    path = tmp_path / f"device_trace.rank{profiler.current_rank()}.json"
    doc = json.loads(path.read_text())
    names = {e.get("name", "") for e in doc["traceEvents"]}
    assert any("mm" in n for n in names), sorted(names)[:20]
    assert not profiler.is_profiler_enabled()


def test_engine_emits_lifecycle_spans_and_ledger_windows(tmp_path):
    cfg = serving.GPTConfig(vocab_size=64, n_layer=1, n_head=2, d_model=16,
                            max_seq_len=32)
    model = serving.DecodeModel(cfg, max_batch=2, n_blocks=8, block_size=4,
                                prefill_buckets=[8, 16], device="cpu")
    ledger.reset()
    profiler.start_profiler()
    try:
        eng = serving.ServingEngine(model)
        h = eng.submit([3, 1, 4, 1, 5], max_new_tokens=3)
        eng.run_until_idle()
        assert len(h.result(timeout=5)) == 3
        names = [e["name"] for e in profiler.get_events()]
    finally:
        profiler.stop_profiler(print_table=False)
        profiler.clear_events()
    for span in ("serve/admit", "serve/queue", "serve/prefill",
                 "serve/decode_tick", "serve/done"):
        assert span in names, names
    totals = ledger.totals()
    assert totals["buckets"]["prefill_compute"] > 0
    assert totals["buckets"]["decode_compute"] > 0
    assert totals["decode_tokens"] == 2
    ledger.reset()
