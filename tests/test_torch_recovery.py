"""The port's post-recovery drift audit (``paddle_tpu_torch/recovery.py``)
against the JAX package's: the drift-audit cases of
``tests/test_checkpoint_recovery.py`` (a clean recovery, each corruption,
the rendering) give the same verdicts, checks and text in both, and so
do the single-purpose audits and a goodput journal written by the port's
ledger across a restart. The audit is pure Python; the packages share
its text, so any difference is a fault.
"""
import torch_threads  # noqa: F401 (one torch thread a worker)
import pytest

from paddle_tpu import recovery as jrecovery
from paddle_tpu_torch import goodput, recovery


def _gp(steps, wall, dc):
    rest = (wall - dc) / 4.0
    return {"steps": steps, "wall_seconds": wall, "samples": steps * 16.0,
            "buckets": {"device_compute": dc, "collective": rest,
                        "input_wait": rest, "compile": rest,
                        "host_other": rest},
            "goodput_fraction": dc / wall if wall else None}


def _series(n, start=0, loss0=1.0):
    return [{"step": s, "loss": round(loss0 * 0.9 ** s, 6)}
            for s in range(start, n)]


_GB, _GA = _gp(7, 7.0, 5.0), _gp(13, 13.0, 9.0)
_DB = {"series": _series(7)}
_DA = {"series": _series(7) + _series(12, start=4)}
_CASES = {
    "clean": (_GB, _GA, _DB, _DA, True),
    "buckets_off_wall": (_GB, dict(_GA, wall_seconds=20.0), _DB, _DA,
                         False),
    "totals_shrank": (_GB, _gp(3, 3.0, 2.0), _DB, _DA, False),
    "fraction_above_1": (_GB, dict(_GA, goodput_fraction=1.2), _DB, _DA,
                         False),
    "history_rewritten": (_GB, _GA, _DB, {"series": _series(12, loss0=2.0)},
                          False),
    "gap": (_GB, _GA, _DB, {"series": _series(7) + _series(12, start=9)},
            False),
    "stuck": (_GB, _GA, _DB, {"series": _series(7) + _series(6, start=4)},
              False),
    # an absent snapshot is a failed check, never a pass
    "no_dynamics": (_GB, _GA, None, None, False),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_drift_audit_alike(case):
    gb, ga, db, da, ok = _CASES[case]
    got = recovery.drift_audit(goodput_before=gb, goodput_after=ga,
                               dynamics_before=db, dynamics_after=da)
    want = jrecovery.drift_audit(goodput_before=gb, goodput_after=ga,
                                 dynamics_before=db, dynamics_after=da)
    assert got == want
    assert got["ok"] is ok
    assert recovery.render_audit(got) == jrecovery.render_audit(want)
    if case == "clean":
        cont = [c for c in got["checks"]
                if c["check"] == "trajectory_continuation"][0]
        assert cont["resumed_at"] == 4 and cont["steps_rerun"] == 3
        assert "PASS" in recovery.render_audit(got)


def test_single_audits_alike():
    assert recovery.audit_goodput_doc(_GA) == jrecovery.audit_goodput_doc(
        _GA)
    assert recovery.audit_monotone(_GB, _GA) == jrecovery.audit_monotone(
        _GB, _GA)
    assert recovery.audit_trajectory(_DB["series"], _DA["series"]) == \
        jrecovery.audit_trajectory(_DB["series"], _DA["series"])


def test_audit_passes_on_a_resumed_goodput_journal(tmp_path):
    """The port's goodput ledger, journaled, then resumed by a fresh
    ledger (a restarted process): the audit passes on its documents."""
    goodput.reset()
    goodput.configure(dir=str(tmp_path))
    try:
        for _ in range(3):
            goodput.add("device_compute", 0.3)
            goodput.end_step(0.5, samples=4)
        before = goodput.load_journal(goodput.flush())
        goodput.reset()
        goodput.configure(dir=str(tmp_path))
        goodput.add("compile", 0.1)
        goodput.end_step(0.25, samples=4)
        after = goodput.load_journal(goodput.flush())
    finally:
        goodput.disable_persistence()
        goodput.reset()
    dyn = {"series": _series(3)}
    audit = recovery.drift_audit(goodput_before=before, goodput_after=after,
                                 dynamics_before=dyn, dynamics_after={
                                     "series": _series(4)})
    assert audit["ok"], recovery.render_audit(audit)
    assert after["steps"] == 4
    bad = recovery.drift_audit(goodput_before=after, goodput_after=before,
                               dynamics_before=dyn, dynamics_after=dyn)
    assert [c["check"] for c in bad["checks"] if not c["ok"]] == [
        "goodput_totals_monotone", "trajectory_continuation"]
