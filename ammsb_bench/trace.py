"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` over
a few whole timed calls, with the program's stage ranges switched on,
reduced in memory to the record that the per-layer metrics read.

The record holds the stretch's host seconds, the device's busy seconds
(the union of the intervals in which a kernel, copy or fill ran), the
host's launch calls, the device seconds of each stage range (each
device operation belongs to the innermost range open on the host when
the call that launched it started), and the breakdown: the device
operations that took most time and the longest idle gaps by what the
host was doing when the device fell idle.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Dict, List, Tuple

import torch

#: the host's launch calls: a CUDA graph's replay is one call
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch",
                   "cuGraphLaunch")


def _innermost(ranges, points) -> Dict[str, float]:
    """Seconds per innermost range: ``ranges`` are nested ``(start, end,
    name)`` intervals, ``points`` ``(time, seconds)``; a point outside
    every range is ``host``."""
    out = collections.defaultdict(float)
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    stack, i = [], 0
    for t, s in sorted(points):
        while i < len(ranges) and ranges[i][0] <= t:
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[stack[-1][2] if stack else "host"] += s
    return out


def _union(intervals: List[Tuple[float, float]]):
    """(busy length, merged intervals) of ``intervals``."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def _top(d: Dict[str, float], k: int = 10):
    return [[name, s] for name, s in sorted(d.items(),
                                             key=lambda kv: -kv[1])[:k]]


def reduce(events, stages) -> dict:
    """The record of a trace's events (times in seconds)."""
    cpu = torch.autograd.DeviceType.CPU
    stages = frozenset(stages)
    device = [e for e in events if e.device_type != cpu
              and not getattr(e, "is_user_annotation", False)
              and e.name not in stages]
    host = [e for e in events if e.device_type == cpu]
    launches = [e for e in host if e.name.startswith(LAUNCH_PREFIXES)]
    threads = collections.Counter(e.thread for e in launches)
    main = threads.most_common(1)[0][0] if threads else None
    launch_at = {e.id: e.time_range.start for e in host
                 if e.name.startswith("cu")}
    stage_ranges = [(e.time_range.start, e.time_range.end, e.name)
                    for e in host if e.name in stages]
    timed, per_op = [], collections.defaultdict(float)
    for e in device:
        s = e.time_range.elapsed_us() * 1e-6
        per_op[e.name[:120]] += s
        timed.append((launch_at.get(e.id, e.time_range.start), s))
    per_stage = _innermost(stage_ranges, timed)
    busy_us, merged = _union([(e.time_range.start, e.time_range.end)
                              for e in device])
    gaps = [(merged[i][1], (merged[i + 1][0] - merged[i][1]) * 1e-6)
            for i in range(len(merged) - 1)]
    main_ranges = [(e.time_range.start, e.time_range.end,
                    e.name[:120]) for e in host if e.thread == main]
    return {"busy_s": busy_us * 1e-6,
            "launch_calls": len(launches),
            "stage_device_s": dict(per_stage),
            "device_ops": _top(per_op),
            "idle_gaps": _top(_innermost(main_ranges, gaps))}


def traced(fn: Callable[[], object], sync: Callable[[], None],
           cuda: bool) -> Tuple[object, dict]:
    """Run ``fn()`` under the profiler with the program's stage ranges
    on; returns (its result, the record with ``wall_s`` added)."""
    from mcmc_ammsb_tpu_torch.utils import profiling

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync()
    profiling._active += 1
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            out = fn()
            sync()
            wall = time.perf_counter() - t0
    finally:
        profiling._active -= 1
    rec = reduce(prof.events(), profiling.STAGE_NAMES)
    rec["wall_s"] = wall
    return out, rec
