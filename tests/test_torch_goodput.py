"""The port's goodput ledger (``paddle_tpu_torch/goodput.py``) against the
JAX package's: the same sequence of calls into both gives equal closed
steps, ledgers, ``status()`` documents and metric series, equal journals
(flushed, reloaded, resumed and merged across ranks), and equal offline
span attribution. Clock, pid and uptime fields, and each package's own
flight-recorder tail and progress count, are left out of the comparison.
"""
import torch_threads  # noqa: F401 (one torch thread a worker)
import json

import pytest

from paddle_tpu import goodput as jgoodput
from paddle_tpu import monitor as jmonitor
from paddle_tpu_torch import goodput, monitor

_PACKAGES = ((goodput, monitor), (jgoodput, jmonitor))
_VOLATILE = ("time_unix", "pid", "uptime_seconds", "flight_tail",
             "progress_count")


@pytest.fixture(autouse=True)
def _fresh():
    saved = [(g, g._JOURNAL_DIR, g._FLUSH_STEPS) for g, _ in _PACKAGES]
    for g, m in _PACKAGES:
        m.enable(True)
        g.reset()
    yield
    for g, d, n in saved:
        g._JOURNAL_DIR, g._FLUSH_STEPS = d, n
        g.reset()
    for _, m in _PACKAGES:
        m.enable(True)


def _stable(doc):
    if isinstance(doc, dict):
        return {k: _stable(v) for k, v in doc.items() if k not in _VOLATILE}
    if isinstance(doc, list):
        return [_stable(v) for v in doc]
    return doc


def _series(m, name):
    fam = m.snapshot().get("metrics", {}).get(name, {})
    return {json.dumps(s.get("labels", {}), sort_keys=True): s["value"]
            for s in fam.get("series", [])}


def _basic(g, m):
    g.add("input_wait", 0.2)
    g.add("device_compute", 0.5)
    return [g.end_step(1.0, samples=32, step=7)]


def _over_attributed(g, m):
    g.add("device_compute", 2.0)
    return [g.end_step(1.0)]


def _nested_window(g, m):
    m0 = g.mark()
    g.add("compile", 0.4)
    inner = g.mark() - m0
    g.add("device_compute", 1.0 - inner)
    return [g.end_step(1.25)]


def _discarded(g, m):
    g.add("device_compute", 5.0)
    g.discard_open()
    g.add("device_compute", 0.4)
    return [g.end_step(0.5)]


def _open_tail(g, m):
    g.add("device_compute", 0.5)
    out = [g.end_step(0.5)]
    g.add("device_compute", 10.0)
    g.add("collective", 0.25)
    return out


def _many_steps(g, m):
    out = []
    for i in range(6):
        g.add("device_compute", 0.1 * (i + 1))
        g.add("input_wait", 0.01 * i)
        g.add("collective", 0.02)
        out.append(g.end_step(0.2 * (i + 1), samples=8 * (i + 1)))
    return out


def _disabled(g, m):
    m.enable(False)
    try:
        g.add("device_compute", 1.0)
        return [g.end_step(1.0)]
    finally:
        m.enable(True)


def _unknown_bucket(g, m):
    try:
        g.add("coffee_break", 1.0)
    except Exception as e:
        return [type(e).__name__, str(e)]
    return ["no error"]


_SEQUENCES = [_basic, _over_attributed, _nested_window, _discarded,
              _open_tail, _many_steps, _disabled, _unknown_bucket]


@pytest.mark.parametrize("seq", _SEQUENCES, ids=[s.__name__.strip("_")
                                                  for s in _SEQUENCES])
def test_same_calls_same_ledger(seq):
    got = []
    for g, m in _PACKAGES:
        before = _series(m, "goodput_bucket_seconds_total")
        closed = seq(g, m)
        after = _series(m, "goodput_bucket_seconds_total")
        delta = {k: v - before.get(k, 0.0) for k, v in after.items()
                 if v != before.get(k, 0.0)}
        got.append({"closed": closed, "totals": _stable(g.totals()),
                    "closed_only": _stable(g.totals(include_open=False)),
                    "summary": _stable(g.summary()),
                    "status": _stable(g.status()),
                    "top_badput": g.top_badput(),
                    "bucket_series_delta": delta})
    # a counter's increment is read as a difference of its totals, which
    # earlier tests in the process may have left at other values in the
    # two packages: equal to a few ulps of those totals
    deltas = [d.pop("bucket_series_delta") for d in got]
    assert got[0] == got[1]
    assert deltas[0] == pytest.approx(deltas[1], rel=0, abs=1e-9)


def test_journals_flush_resume_and_merge_alike(tmp_path):
    """Flush two ranks' journals, resume one, merge and render: both
    packages write, read and merge the same documents."""
    docs = []
    for (g, m), name in zip(_PACKAGES, ("port", "reference")):
        d = tmp_path / name
        d.mkdir()
        g.configure(dir=str(d), flush_steps=2)
        for i in range(4):
            g.add("device_compute", 0.3)
            g.add("compile", 0.05 * i)
            g.end_step(0.5, samples=4)
        path = g.journal_path()
        j = g.load_journal(path)
        # a second rank's journal beside it, and an alien file
        other = dict(j, rank=1)
        (d / "goodput.rank1.json").write_text(json.dumps(other))
        (d / "goodput.rank9.json").write_text('{"schema": "other"}')
        merged = g.load_journals(str(d))
        only0 = g.load_journals(str(d), ranks=[0])
        # a restarted rank resumes from its journal
        g.reset()
        g.configure(dir=str(d))
        g.add("device_compute", 0.1)
        g.end_step(0.2)
        resumed = g.totals()
        docs.append({"journal": _stable(j), "merged": merged,
                     "only0": only0, "text": g.render_summary(merged),
                     "resumed": _stable(resumed)})
        g.disable_persistence()
    assert docs[0] == docs[1]
    assert docs[0]["resumed"]["resumed_from_journal"] is True
    assert docs[0]["merged"]["ranks"] == [0, 1]


@pytest.mark.parametrize("name,cat", [
    ("collective/allreduce", ""), ("dataloader/next", ""),
    ("executor/run", ""), ("x", "collective"), ("wait_dataloader", ""),
])
def test_span_attribution_alike(name, cat):
    events = [{"name": name, "cat": cat, "dur": 1500.0},
              {"name": "fit/step", "cat": "", "dur": 9000.0}]
    assert goodput.classify_span(name, cat) == \
        jgoodput.classify_span(name, cat)
    assert goodput.attribute_events(events) == \
        jgoodput.attribute_events(events)


def test_rank_change_reanchors_journal_resume(tmp_path):
    """ROADMAP C5: the JAX package's own sequence
    (``tests/test_goodput.py::test_rank_change_reanchors_journal_resume``)
    on both packages. A late rank change (``profiler.set_rank`` after
    import) must drop rank 0's resumed journal: 0 steps after the change
    and a rank-3 journal of 1 step, equal on both."""
    got = []
    for (g, m), name in zip(_PACKAGES, ("port", "reference")):
        d = tmp_path / name
        d.mkdir()
        g.configure(dir=str(d))
        g.end_step(1.0)
        g.flush()  # goodput.rank0.json exists
        g.reset()
        g.configure(dir=str(d))  # resumes rank 0's journal
        resumed = g.totals()["steps"]
        m.set_trainer_rank(3)  # late identity: rank 3 has no journal
        try:
            after = g.totals()["steps"]
            g.end_step(1.0)
            doc = g.load_journal(g.flush())
        finally:
            m.set_trainer_rank(0)
            g.disable_persistence()
        got.append({"resumed": resumed, "after_change": after,
                    "journal": _stable(doc)})
    assert got[0] == got[1]
    assert got[0]["resumed"] == 1 and got[0]["after_change"] == 0
    assert got[0]["journal"]["rank"] == 3
    assert got[0]["journal"]["steps"] == 1
