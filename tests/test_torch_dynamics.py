"""The port's training-dynamics telemetry (``paddle_tpu_torch/dynamics.py``)
against the JAX package's.

The JAX package's own sequences (``tests/test_dynamics.py``) run through
both packages with the same fed values: the series and its EMA, the
goodput step boundary, staged values composing across call sites, each
anomaly episode (loss spike and re-arm, warm-up floor, divergence,
plateau, grad explode and vanish, non-finite loss and grad), the journal
(flush, load, resume, the pristine guard, an alien file, a resumed
trajectory, the rank change), the cross-rank merge with its desync probe,
and the disabled mode give equal documents (clock fields aside). Then the
fused reduction: ``grad_health`` and ``layer_breakdown`` over the same
numpy values (fp32 and bf16, through torch tensors on the port's side)
against the JAX package's ``_fused_norms``, to 1e-6 relative.
"""
import torch_threads  # noqa: F401 (one torch thread a worker)
import json
import math
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu import dynamics as jdynamics
from paddle_tpu import goodput as jgoodput
from paddle_tpu import monitor as jmonitor
from paddle_tpu_torch import dynamics, goodput, monitor

_PACKAGES = ((dynamics, goodput, monitor), (jdynamics, jgoodput, jmonitor))
_VOLATILE = ("time_unix", "pid", "t", "started_unix")
_QUIET = {
    "PADDLE_TPU_DYNAMICS_SPIKE_Z": "1000",
    "PADDLE_TPU_DYNAMICS_DIVERGE_STEPS": "100000",
    "PADDLE_TPU_DYNAMICS_PLATEAU_STEPS": "100000",
}
_ENV = tuple(_QUIET) + ("PADDLE_TPU_DYNAMICS",)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in _ENV:  # restored when the test ends
        monkeypatch.delenv(k, raising=False)
    for dyn, gp, mon in _PACKAGES:
        mon.enable(True)
        dyn.reset()
        gp.reset()
    yield
    for dyn, gp, _ in _PACKAGES:
        dyn.disable_persistence()
        dyn.reset()
        gp.reset()


def _stable(doc):
    if isinstance(doc, dict):
        return {k: _stable(v) for k, v in doc.items() if k not in _VOLATILE}
    if isinstance(doc, list):
        return [_stable(v) for v in doc]
    return doc


def _run(dyn, losses, grads=None, lrs=None, start_step=0):
    out = []
    for i, loss in enumerate(losses):
        dyn.feed(loss=loss, grad_norm=grads[i] if grads else None,
                 lr=lrs[i] if lrs else None)
        out.append(dyn.end_step(step=start_step + i))
    return out


def _quiet(**more):
    os.environ.update(_QUIET)
    os.environ.update(more)


def _series(dyn, gp, tmp):
    recs = _run(dyn, [2.0, 1.9, 1.8], grads=[1.0, 1.1, 0.9],
                lrs=[0.1, 0.1, 0.1])
    return recs + [dyn.totals(), dyn.trajectory(), dyn.summary()]


def _no_feed(dyn, gp, tmp):
    return [dyn.end_step(step=0), dyn.totals()["steps"]]


def _goodput_boundary(dyn, gp, tmp):
    dyn.feed(loss=1.5)
    gp.end_step(0.1, step=7)
    return [dyn.totals()]


def _ema(dyn, gp, tmp):
    return _run(dyn, [2.0] * 30)[-3:]


def _staged(dyn, gp, tmp):
    dyn.feed(loss=3.0)
    dyn.feed(grad_norm=0.5, layers={"l1": {"grad_norm": 0.5}})
    return [dyn.end_step(step=0)]


def _spike(dyn, gp, tmp):
    os.environ["PADDLE_TPU_DYNAMICS_DIVERGE_STEPS"] = "100000"
    os.environ["PADDLE_TPU_DYNAMICS_PLATEAU_STEPS"] = "100000"
    out = _run(dyn, [2.0] * 30)
    out += _run(dyn, [20.0, 25.0], start_step=30)
    out += _run(dyn, [2.0] * 40, start_step=32)
    out += _run(dyn, [50.0], start_step=72)
    return out + [dyn.totals()["anomaly_counts"]]


def _warmup_floor(dyn, gp, tmp):
    _quiet(PADDLE_TPU_DYNAMICS_SPIKE_Z="3")
    return _run(dyn, [2.0] * 5 + [20.0]) + [dyn.totals()]


def _divergence(dyn, gp, tmp):
    _quiet(PADDLE_TPU_DYNAMICS_DIVERGE_STEPS="5")
    _run(dyn, [1.0] * 25)
    out = _run(dyn, [1.0 + 0.3 * i for i in range(1, 30)], start_step=25)
    return out + [dyn.totals()["anomaly_counts"]]


def _plateau(dyn, gp, tmp):
    _quiet(PADDLE_TPU_DYNAMICS_PLATEAU_STEPS="10")
    return _run(dyn, [1.0] * 45) + [dyn.totals()["anomaly_counts"]]


def _grad_episodes(dyn, gp, tmp):
    _quiet()
    _run(dyn, [1.0] * 30, grads=[1.0] * 30)
    return _run(dyn, [1.0, 1.0], grads=[1000.0, 0.0], start_step=30)


def _nonfinite(dyn, gp, tmp):
    _quiet()
    _run(dyn, [2.0] * 25, grads=[1.0] * 25)
    out = _run(dyn, [float("nan")], grads=[float("nan")], start_step=25)
    doc = json.dumps(dyn.totals())
    out += [dyn.ledger().grad_ema, "NaN" in doc or "Infinity" in doc]
    out += _run(dyn, [2.0] * 5 + [2.0], grads=[1.0] * 5 + [1000.0],
                start_step=26)
    out += _run(dyn, [float("inf"), 2.0], start_step=32)
    return out + [dyn.totals()["anomaly_counts"]]


def _journal(dyn, gp, tmp):
    _run(dyn, [2.0, 1.5, 1.0], grads=[1.0, 1.0, 1.0])
    path = dyn.flush(str(tmp / "dynamics.rank0.jsonl"))
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    return [len(lines), json.loads(lines[0]), dyn.load_journal(path)]


def _resume(dyn, gp, tmp):
    _run(dyn, [2.0, 1.8])
    dyn.configure(dir=str(tmp))
    dyn.flush()
    dyn.configure(dir=str(tmp))  # not pristine: no double resume
    guarded = dyn.totals()["steps"]
    dyn.reset()
    dyn.configure(dir=str(tmp))  # pristine: resumes the base
    _run(dyn, [1.6], start_step=2)
    _run(dyn, [1.5], start_step=0)  # a restarted counter
    return [guarded, dyn.totals(), dyn.trajectory()]


def _alien(dyn, gp, tmp):
    path = tmp / "dynamics.rank0.jsonl"
    path.write_text(json.dumps({"schema": "something/else"}) + "\n")
    with pytest.raises(ValueError, match="not a dynamics journal"):
        dyn.load_journal(str(path))
    return [dyn.load_journals(str(tmp))]


def _rank_change(dyn, gp, tmp):
    mon = jmonitor if dyn is jdynamics else monitor
    dyn.configure(dir=str(tmp))
    _run(dyn, [2.0])
    dyn.flush()
    dyn.reset()
    dyn.configure(dir=str(tmp))  # resumes rank 0's journal
    resumed = dyn.totals()["steps"]
    mon.set_trainer_rank(3)
    try:
        after = dyn.totals()["steps"]
        path = os.path.basename(dyn.journal_path("/d"))
        _run(dyn, [1.0], start_step=1)
        doc = dyn.load_journal(dyn.flush())
    finally:
        mon.set_trainer_rank(0)
    return [resumed, after, path, doc]


def _write_rank_journal(dyn, dirpath, rank, losses, anomalies=None):
    header = {"schema": dyn.SCHEMA, "rank": rank, "steps": len(losses),
              "anomaly_counts": anomalies or {}}
    lines = [json.dumps(header)]
    lines += [json.dumps({"step": i, "t": 1.0 + i, "loss": v})
              for i, v in enumerate(losses)]
    with open(os.path.join(dirpath, f"dynamics.rank{rank}.jsonl"), "w") as f:
        f.write("\n".join(lines) + "\n")


def _merge(dyn, gp, tmp):
    skew, equal = tmp / "skew", tmp / "equal"
    skew.mkdir()
    equal.mkdir()
    for r in range(3):
        _write_rank_journal(dyn, skew, r, [2.0 - 0.1 * i + 0.001 * r
                                           for i in range(10)])
    _write_rank_journal(dyn, skew, 3, [2.0 + 0.2 * i for i in range(10)])
    for r in range(4):
        _write_rank_journal(dyn, equal, r, [1.0 - 0.01 * i + 0.0001 * r
                                            for i in range(20)],
                            anomalies={"loss_spike": 1})
    a, b = dyn.load_journals(str(skew)), dyn.load_journals(str(equal))
    mk = lambda r, v: {"schema": dyn.SCHEMA, "rank": r,  # noqa: E731
                       "series": [{"step": 0, "loss": v}]}
    return [a, b, dyn.render_summary(a), dyn.render_summary(b),
            dyn.load_journals(str(skew), ranks=range(2)),
            dyn.check_desync([mk(0, 1.0), mk(1, 1.0), mk(2, 1.04)]),
            dyn.check_desync([mk(0, 1.0), mk(1, 1.0), mk(2, 1.06)])]


def _disabled(dyn, gp, tmp):
    os.environ["PADDLE_TPU_DYNAMICS"] = "0"
    dyn.feed(loss=1.0)
    return [dyn.end_step(step=0), dyn.totals()["steps"],
            dyn.should_sample_layers(0)]


_SEQUENCES = [_series, _no_feed, _goodput_boundary, _ema, _staged, _spike,
              _warmup_floor, _divergence, _plateau, _grad_episodes,
              _nonfinite, _journal, _resume, _alien, _rank_change, _merge,
              _disabled]


@pytest.mark.parametrize("seq", _SEQUENCES,
                         ids=[s.__name__.strip("_") for s in _SEQUENCES])
def test_same_calls_same_dynamics(seq, tmp_path):
    got = []
    for (dyn, gp, _), name in zip(_PACKAGES, ("port", "reference")):
        d = tmp_path / name
        d.mkdir()
        got.append(_stable(seq(dyn, gp, d)))
        dyn.disable_persistence()
        for k in _ENV:
            os.environ.pop(k, None)
    assert got[0] == got[1]


def test_sequences_say_what_the_reference_asserts(tmp_path):
    """The reference's headline verdicts, on the port's side."""
    recs = _spike(dynamics, goodput, tmp_path)
    assert recs[-1]["loss_spike"] == 2
    dynamics.reset()
    for k in _ENV:
        os.environ.pop(k, None)
    merged = _merge(dynamics, goodput, tmp_path)
    assert merged[0]["desync"]["suspects"] == ["3"]
    assert merged[1]["desync"]["ok"]
    dynamics.reset()
    (tmp_path / "r").mkdir()
    resumed, after, path, doc = _rank_change(dynamics, goodput,
                                             tmp_path / "r")
    assert (resumed, after, path) == (1, 0, "dynamics.rank3.jsonl")
    assert doc["rank"] == 3 and doc["steps"] == 1


def _named(rs, dtype):
    """(name, numpy) pairs: tensors of several shapes and scales, one
    non-finite, one at explosion scale (its f32 sum of squares
    overflows)."""
    arrays = [("w.a", rs.randn(37, 5)), ("w.b", rs.randn(128) * 1e-3),
              ("l2.c", rs.randn(3, 4, 5) * 30.0), ("l2.bad",
                                                   np.array([1.0, np.nan])),
              ("l3.huge", np.full((16,), 1e20))]
    return [(n, a.astype(dtype)) for n, a in arrays]


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16],
                         ids=["float32", "bfloat16"])
def test_grad_health_equals_the_reference_fused_norms(dtype):
    import jax.numpy as jnp

    named = _named(np.random.RandomState(0), dtype)
    both = dynamics._fused_norms([_torch(a) for _, a in named])
    sq, fin = dynamics._host_norms(both)
    jsq, jfin = jdynamics._fused_norms([jnp.asarray(a) for _, a in named])
    jsq = jdynamics._clamp_overflow(np.asarray(jsq, dtype=np.float64))
    assert (fin == np.asarray(jfin)).all()
    np.testing.assert_allclose(sq[fin], jsq[fin], rtol=1e-6)
    norm, bad = dynamics.grad_health((n, _torch(a)) for n, a in named)
    jnorm, jbad = jdynamics.grad_health((n, jnp.asarray(a))
                                        for n, a in named)
    assert bad == jbad == ["l2.bad"]
    assert norm == pytest.approx(jnorm, rel=1e-6)
    assert math.isfinite(norm) and norm > 1e18
    # numpy inputs take the same reduction on the CPU
    assert dynamics.grad_health(named)[0] == pytest.approx(jnorm, rel=1e-6)
    triples = [(n, _torch(a), _torch(a) * 0.5) for n, a in named]
    jtriples = [(n, jnp.asarray(a), jnp.asarray(a) * 0.5)
                for n, a in named]
    got = dynamics.layer_breakdown(triples, lr=0.1)
    want = jdynamics.layer_breakdown(jtriples, lr=0.1)
    assert set(got) == set(want) == {"w", "l2", "l3"}
    for group in want:
        for k, v in want[group].items():
            assert got[group][k] == pytest.approx(v, rel=1e-6), (group, k)


def test_grad_health_reads_the_host_once(monkeypatch):
    """The reduction's result comes back in one transfer: one (2, n)
    tensor, read by one ``.cpu()``."""
    calls = []
    real = torch.Tensor.cpu

    def cpu(self, *a, **k):
        calls.append(tuple(self.shape))
        return real(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    tensors = [("a", torch.ones(3)), ("b", torch.full((2, 2), 2.0))]
    norm, bad = dynamics.grad_health(tensors)
    assert calls == [(2, 2)]
    assert norm == pytest.approx(math.sqrt(3 + 16)) and bad == []
