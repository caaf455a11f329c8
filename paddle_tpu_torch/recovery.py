"""Post-recovery drift audit: did the books survive the crash?

Port of ``paddle_tpu/recovery.py`` (pure Python; the text is the JAX
package's).

Recovery that "works" but corrupts the accounting is a silent failure of
the whole observability stack — a resumed rank double-counting its
lifetime goodput, or a dynamics journal whose trajectory silently forked,
would poison every later perf_gate/curve_gate verdict. This module is the
audit the chaos harness runs AFTER a kill-and-recover cycle, in the
memwatch/shard_insight verdict idiom (explicit checks, an ``ok``
headline, honest notes):

  goodput_buckets_sum_to_wall   closed-step bucket seconds still sum to
                                the wall clock (the two-phase accounting
                                invariant end_step maintains)
  goodput_fraction_bounded      productive fraction stays <= 1.0
  goodput_totals_monotone       lifetime totals (steps, wall, every
                                bucket) only grew across the restart —
                                a resume that re-counted or dropped its
                                journal base shows up here
  trajectory_prefix_intact      the dynamics series recorded BEFORE the
                                crash is a literal prefix of the
                                post-recovery series (the journal resume
                                must append, never rewrite history)
  trajectory_continuation       the appended records re-enter at or
                                before the crash point + 1 (no gap: the
                                checkpoint resume honestly re-runs the
                                steps the kill lost), advance one step
                                at a time, and extend past the crash

The inputs are journal documents (``goodput.load_journal(s)`` /
``dynamics.load_journal(s)``) snapshotted before the kill and after
recovery. In the JAX package ``tools/chaos_bench.py`` wires it end to
end; in this one ``chip_smoke.py``'s ``train_observed`` phase audits a
resumed epoch loop with it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

__all__ = [
    "SCHEMA", "audit_goodput_doc", "audit_monotone", "audit_trajectory",
    "drift_audit", "render_audit",
]

SCHEMA = "paddle_tpu.recovery_audit/1"

# closed-step buckets must sum to wall by construction; the tolerance
# absorbs float rounding across journal round-trips, nothing more
_SUM_REL_TOL = 0.02
_SUM_ABS_TOL = 0.05  # seconds
_MONO_EPS = 1e-6
_LOSS_REL_TOL = 1e-9


def _check(name: str, ok: bool, note: str, **detail) -> Dict[str, Any]:
    out = {"check": name, "ok": bool(ok), "note": note}
    out.update(detail)
    return out


def audit_goodput_doc(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The self-consistency half: buckets-sum-to-wall + bounded
    fraction, over one (possibly merged) goodput ledger doc."""
    buckets = doc.get("buckets") or {}
    wall = float(doc.get("wall_seconds") or 0.0)
    total = float(sum(buckets.values()))
    gap = abs(total - wall)
    sum_ok = gap <= max(_SUM_ABS_TOL, _SUM_REL_TOL * max(wall, total))
    frac = doc.get("goodput_fraction")
    frac_ok = frac is None or (math.isfinite(float(frac))
                               and float(frac) <= 1.0 + 1e-9)
    return [
        _check("goodput_buckets_sum_to_wall", sum_ok,
               f"bucket seconds {total:.3f} vs wall {wall:.3f} "
               f"(gap {gap:.3f}s)",
               bucket_seconds=round(total, 6), wall_seconds=round(wall, 6)),
        _check("goodput_fraction_bounded", frac_ok,
               f"goodput_fraction {frac}", goodput_fraction=frac),
    ]


def audit_monotone(before: Dict[str, Any],
                   after: Dict[str, Any]) -> Dict[str, Any]:
    """Lifetime totals may only grow across a restart: the resumed base
    plus new work is never less than what the journal held at the kill."""
    regressions = []
    for key in ("steps", "wall_seconds", "samples"):
        b = float(before.get(key) or 0.0)
        a = float(after.get(key) or 0.0)
        if a < b - _MONO_EPS - 1e-4 * abs(b):
            regressions.append(f"{key} {b:.6g}->{a:.6g}")
    bb = before.get("buckets") or {}
    ab = after.get("buckets") or {}
    for bucket, bval in bb.items():
        aval = float(ab.get(bucket, 0.0))
        if aval < float(bval) - _MONO_EPS - 1e-4 * abs(float(bval)):
            regressions.append(f"buckets.{bucket} {bval:.6g}->{aval:.6g}")
    return _check(
        "goodput_totals_monotone", not regressions,
        "lifetime totals grew monotonically" if not regressions
        else "totals shrank across the restart: " + "; ".join(regressions),
        regressions=regressions)


def _series_steps(series: Sequence[Dict[str, Any]]) -> List[int]:
    return [int(s.get("step", -1)) for s in series]


def _loss_equal(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    fa, fb = float(a), float(b)
    if not (math.isfinite(fa) and math.isfinite(fb)):
        return str(fa) == str(fb)
    return abs(fa - fb) <= _LOSS_REL_TOL * max(1.0, abs(fa), abs(fb))


def audit_trajectory(before_series: Sequence[Dict[str, Any]],
                     after_series: Sequence[Dict[str, Any]]
                     ) -> List[Dict[str, Any]]:
    """Prefix + continuation over dynamics step records ({step, loss}).
    The journal resume APPENDS the re-run steps after the persisted
    prefix, so the recorded-before-crash records must survive verbatim,
    and the appended records must re-enter at or before crash+1 and walk
    forward one step at a time."""
    before = list(before_series)
    after = list(after_series)
    n = len(before)
    prefix_ok = len(after) >= n
    mismatch = None
    if prefix_ok:
        for i, (b, a) in enumerate(zip(before, after[:n])):
            if int(b.get("step", -1)) != int(a.get("step", -2)) or \
                    not _loss_equal(b.get("loss"), a.get("loss")):
                prefix_ok = False
                mismatch = (f"record {i}: before step "
                            f"{b.get('step')}/loss {b.get('loss')} vs "
                            f"after {a.get('step')}/{a.get('loss')}")
                break
    else:
        mismatch = (f"post-recovery series shorter than the pre-crash "
                    f"one ({len(after)} < {n})")
    checks = [_check(
        "trajectory_prefix_intact", prefix_ok,
        "pre-crash records survived verbatim" if prefix_ok
        else f"journal history was rewritten: {mismatch}")]

    cont = after[n:]
    last_before = max(_series_steps(before)) if before else -1
    if not cont:
        checks.append(_check(
            "trajectory_continuation", False,
            "no post-recovery steps recorded", resumed_at=None))
        return checks
    cont_steps = _series_steps(cont)
    resumed_at = cont_steps[0]
    gapless = resumed_at <= last_before + 1
    walk_ok = all(cont_steps[i + 1] == cont_steps[i] + 1
                  for i in range(len(cont_steps) - 1))
    advanced = cont_steps[-1] > last_before
    ok = gapless and walk_ok and advanced
    note = (f"resumed at step {resumed_at} (crash point "
            f"{last_before}), advanced to {cont_steps[-1]}")
    if not gapless:
        note = (f"GAP: continuation starts at step {resumed_at}, "
                f"{resumed_at - last_before - 1} step(s) after the "
                f"recorded history ends at {last_before}")
    elif not walk_ok:
        note = "continuation steps are not consecutive"
    elif not advanced:
        note = (f"continuation never advanced past the crash point "
                f"{last_before}")
    checks.append(_check(
        "trajectory_continuation", ok, note,
        resumed_at=resumed_at, crash_step=last_before,
        final_step=cont_steps[-1],
        steps_rerun=max(0, last_before - resumed_at + 1)))
    return checks


def drift_audit(goodput_before: Optional[Dict[str, Any]] = None,
                goodput_after: Optional[Dict[str, Any]] = None,
                dynamics_before: Optional[Dict[str, Any]] = None,
                dynamics_after: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
    """The full audit verdict over before/after journal snapshots; any
    absent input honestly records a skipped check rather than passing."""
    checks: List[Dict[str, Any]] = []
    if goodput_after is not None:
        checks.extend(audit_goodput_doc(goodput_after))
        if goodput_before is not None:
            checks.append(audit_monotone(goodput_before, goodput_after))
        else:
            checks.append(_check("goodput_totals_monotone", True,
                                 "skipped: no pre-crash snapshot",
                                 skipped=True))
    else:
        checks.append(_check("goodput_buckets_sum_to_wall", False,
                             "no post-recovery goodput ledger"))
    if dynamics_before is not None and dynamics_after is not None:
        checks.extend(audit_trajectory(
            dynamics_before.get("series") or [],
            dynamics_after.get("series") or []))
    else:
        checks.append(_check("trajectory_prefix_intact", False,
                             "missing dynamics journal snapshot(s)"))
    return {
        "schema": SCHEMA,
        "ok": all(c["ok"] for c in checks),
        "checks": checks,
    }


def render_audit(audit: Dict[str, Any],
                 title: str = "recovery drift audit") -> str:
    lines = [f"== {title}: {'PASS' if audit.get('ok') else 'FAIL'} =="]
    for c in audit.get("checks", []):
        mark = "ok " if c.get("ok") else "FAIL"
        lines.append(f"  [{mark}] {c.get('check'):<30} {c.get('note')}")
    return "\n".join(lines)
