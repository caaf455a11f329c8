"""The planner's calibration half: committed rounds and their correction
factors.

Port of two functions of ``paddle_tpu/planner.py``, the ones the serving
capacity planner (``serving/capacity.py``) calls: :func:`load_round_history`
reads committed ``<name>_r<N>.json`` rounds oldest to newest, and
:func:`calibrate` turns (predicted, measured) pairs into a median
correction factor with its stated errors. Neither holds device code, so
each is the JAX package's, line for line. The training auto-planner
around them (layout enumeration, scoring through the compiler's cost
analysis, ``decide``, ``plan``, the comms re-pricing and
``planner_regret``) is not ported yet (ROADMAP A12).
"""
from __future__ import annotations

import glob
import json
import os
import re
import statistics
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["load_round_history", "calibrate"]


_ROUND_RE = re.compile(r"_r(\d+)\.json$")


def load_round_history(history_dir: str,
                       patterns: Sequence[str] = ("MULTICHIP_r*.json",
                                                  "BENCH_r*.json")
                       ) -> Dict[str, List[Tuple[str, dict]]]:
    """{pattern: [(round_name, doc), ...]} sorted oldest -> newest by
    the r<N> in the filename; unreadable rounds shrink the window."""
    out: Dict[str, List[Tuple[str, dict]]] = {}
    for pattern in patterns:
        rounds: List[Tuple[int, str, dict]] = []
        for path in glob.glob(os.path.join(history_dir, pattern)):
            base = os.path.basename(path)
            m = _ROUND_RE.search(base)
            if not m:
                continue
            try:
                with open(path) as f:
                    rounds.append((int(m.group(1)), base, json.load(f)))
            except (OSError, ValueError):
                continue
        out[pattern] = [(name, doc) for _, name, doc
                        in sorted(rounds, key=lambda r: r[0])]
    return out


def calibrate(pairs: Dict[str, List[dict]],
              max_pairs_kept: int = 12,
              link_class_bandwidth: Optional[Dict[str, dict]] = None
              ) -> Dict[str, Any]:
    """Per-metric predictor calibration from replayed history pairs:
    the correction factor is the median measured/predicted ratio (what
    a prediction must be multiplied by to match this harness), and the
    errors are stated — ``raw_error`` the median |ratio - 1| before
    correction, ``residual_error`` the median relative deviation that
    REMAINS after applying the factor.

    Predictor error is not uniform across layouts (the analytic model
    is more optimistic about some recipes than others — that asymmetry
    IS the measured signal), so each metric also carries ``by_config``:
    the per-config median ratio for every config with history pairs.
    ``capacity.score_config`` (and the JAX package's training planner)
    ranks on the per-config-corrected prediction where one exists —
    measurements outvote the model for configurations the harness has
    already timed. An empty metric calibrates to factor None
    (predictions ride uncorrected, and the report says so).

    ``link_class_bandwidth`` (a measured per-link-class bus bandwidth
    table) rides along under the ``link_class_bandwidth`` key, as the
    JAX package's training planner passes it; the serving planner
    passes none."""
    out: Dict[str, Any] = {}
    if link_class_bandwidth is not None:
        out["link_class_bandwidth"] = dict(link_class_bandwidth)
    for metric, rows in pairs.items():
        if not rows:
            out[metric] = {"n_pairs": 0, "correction_factor": None,
                           "raw_error": None, "residual_error": None,
                           "by_config": {}, "pairs": []}
            continue
        ratios = [r["ratio"] for r in rows]
        factor = statistics.median(ratios)
        raw = statistics.median([abs(r - 1.0) for r in ratios])
        resid = statistics.median([abs(r / factor - 1.0) for r in ratios])
        by_config: Dict[str, Any] = {}
        groups: Dict[str, List[float]] = {}
        for r in rows:
            groups.setdefault(str(r.get("config")), []).append(r["ratio"])
        for config, rs in sorted(groups.items()):
            by_config[config] = {
                "n_pairs": len(rs),
                "correction_factor": round(statistics.median(rs), 6),
            }
        out[metric] = {
            "n_pairs": len(rows),
            "correction_factor": round(factor, 6),
            "raw_error": round(raw, 4),
            "residual_error": round(resid, 4),
            "by_config": by_config,
            "pairs": rows[-max_pairs_kept:],
        }
    return out
