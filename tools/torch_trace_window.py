#!/usr/bin/env python3
"""Whether a torch.profiler trace keeps every kernel of a replayed
training step, and how far the card's times in it lie from the host's,
on one CUDA card.

    python3 tools/torch_trace_window.py [--minutes M] [--gap S]

Builds the kernels and ``chip_smoke.py``'s seq-2048 training step
(``_LONG``: gpt2s, batch 8, bf16), captures it, and then, for M minutes
(default 5), traces one replayed step in each of three ways a pass:

- ``warm``: after one traced warm-up step, the counted step straight
  after the window opens and the window closed straight after it;
- ``cold``: one trace around the step, nothing before or after it;
- ``marked``: ``chip_smoke._profiled`` (the warm-up step, the counted
  step ``_TRACE_MARGIN_S`` inside the window, a marker kernel on each
  side; it raises where a marker's record is lost).

Between passes the step replays untraced for S seconds (default 10).
One JSON line a trace: the seconds since the start, its kernel records,
``skew_ms`` (its first kernel's start less the host's start of the graph
launch that ran it: negative where the card's times lie early, since no
kernel starts before its launch) and, at the end, ``lost``: the records
it lacks against the trace that kept the most, and where they lay in
the step (from which kernel, how many). The last line sums each way up:
traces, traces that lost records, the most lost, the least and the most
skew.
"""
import argparse
import difflib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--minutes", type=float, default=5.0)
    ap.add_argument("--gap", type=float, default=10.0,
                    help="seconds of untraced replayed steps between passes")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import torch

    card = cs._environment(torch)
    import paddle_tpu_torch
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.framework.executor import OP_RANGE
    from paddle_tpu_torch.ops import _build
    from torch.profiler import ProfilerActivity, profile, schedule

    paddle_tpu_torch.enable_static()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    config = cs._LONG
    main_prog, startup, io = cs._train_program(config, cs._LONG_B,
                                               cs._LONG_T)
    scope, exe = Scope(), cs._executor("cuda")
    exe.run(startup, scope=scope)
    feed = cs._fixed_batch(torch, config["vocab_size"], cs._LONG_B,
                           cs._LONG_T)
    fetch = [io["loss"], io["optimizer"]._lr_var]

    def step():
        return exe.run(main_prog, feed=feed, fetch_list=fetch, scope=scope)

    for _ in range(3):  # warm-up, capture, a replay
        step()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def warm():
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            step()
            torch.cuda.synchronize()
            prof.step()
            step()
            torch.cuda.synchronize()
            prof.step()
        return list(prof.events())

    def cold():
        with profile(activities=activities) as prof:
            step()
            torch.cuda.synchronize()
        return list(prof.events())

    def marked():
        return cs._profiled(torch, step)[2]

    def kernels(events):
        """(kernel names by start, skew ms)."""
        ks, launches = [], []
        for e in events:
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if not (e.name.startswith(OP_RANGE)
                        or getattr(e, "is_user_annotation", False)):
                    ks.append((e.time_range.start, e.name))
            elif e.name == "cudaGraphLaunch":
                launches.append(e.time_range.start)
        ks.sort()
        skew = ((ks[0][0] - min(launches)) / 1e3
                if ks and launches else None)
        return [n for _, n in ks], skew

    ways = {"warm": warm, "cold": cold, "marked": marked}
    rows, t_start = [], time.perf_counter()
    while time.perf_counter() - t_start < args.minutes * 60:
        for way, trace in ways.items():
            at = time.perf_counter() - t_start
            try:
                names, skew = kernels(trace())
                error = None
            except AssertionError as e:  # a marker's record lost
                names, skew, error = [], None, str(e)
            rows.append(dict(way=way, at_s=at, records=len(names),
                             skew_ms=skew, error=error, names=names))
            print(json.dumps({k: v for k, v in rows[-1].items()
                              if k != "names"}), flush=True)
        t_gap = time.perf_counter()
        while time.perf_counter() - t_gap < args.gap:
            step()
        torch.cuda.synchronize()
    ref = max((r["names"] for r in rows), key=len)
    summary = {}
    for r in rows:
        lost = []
        if r["names"] and len(r["names"]) < len(ref):
            sm = difflib.SequenceMatcher(a=ref, b=r["names"],
                                         autojunk=False)
            lost = [{"from": i1, "count": i2 - i1, "first": ref[i1][:60]}
                    for tag, i1, i2, _, _ in sm.get_opcodes()
                    if tag != "equal"]
        if lost:
            print(json.dumps(dict(way=r["way"], at_s=r["at_s"],
                                  records=r["records"], lost=lost)))
        s = summary.setdefault(r["way"], dict(traces=0, lossy=0,
                                              most_lost=0, errors=0,
                                              skews=[]))
        s["traces"] += 1
        s["errors"] += r["error"] is not None
        n_lost = len(ref) - r["records"] if r["names"] else 0
        s["lossy"] += n_lost > 0
        s["most_lost"] = max(s["most_lost"], n_lost)
        if r["skew_ms"] is not None:
            s["skews"].append(r["skew_ms"])
    for s in summary.values():
        skews = s.pop("skews")
        s["skew_ms"] = [min(skews), max(skews)] if skews else None
    print(json.dumps(dict(phase="trace_window", card=card,
                          step_kernels=len(ref),
                          margin_s=cs._TRACE_MARGIN_S, ways=summary)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
