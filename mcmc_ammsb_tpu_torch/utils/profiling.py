"""Per-stage attribution of the training loop (counterpart of
``mcmc_ammsb_tpu/utils/profiling.py``).

The reference times every kernel launch with device events and prints a
stage table (learner.cc:252-299). The port's loop is a sequence of
torch launches and hand-written kernels, so ``profile_trace`` runs it
under ``torch.profiler`` and adds up, for each stage, the time of the
work issued inside the stage's range: the device time of its kernels on
a card, the CPU time of its operations on the CPU. The ranges are the
JAX package's ``jax.named_scope`` stage names (``STAGE_NAMES``), opened
by ``stage(name)`` in the step functions; work inside a nested stage is
the inner stage's, work outside every stage is ``other``.

``stage`` costs nothing while no ``profile_trace`` runs: it returns a
shared null context, because every path of the port is bound by the
host's 11-19 us per launch.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Callable, Iterable

import torch

# the production stage names (the JAX package's list, then two more)
STAGE_NAMES = (
    "device_sampling",
    "neighbor_draws",
    "membership",
    "noise",
    "edge_lanes",
    "pi_gather",
    "phi_update",
    "pi_scatter",
    "beta_grads",
    "theta_update",
    "ppx",
    # device-sampling sub-stages (ops/device_sampling.py)
    "ds_link",
    "ds_nonlink",
    "ds_extract_nodes",
    # windowed-engine stages (ops/window.py, chains_flat.py)
    "window_gather",
    "window_correct",
    "window_prep",
    "window_lanes",
    "window_dirty",
    "window_kernel",
    "window_body",
    "window_scatter",
    # the device BF sub-stages (ops/device_sampling.py), which the JAX
    # package's device sampler opens too but its list lacks
    "ds_bf_link",
    "ds_bf_nonlink",
)

_NULL = contextlib.nullcontext()
_active = 0


def stage(name: str):
    """The range of stage ``name`` while ``profile_trace`` runs, else a
    null context."""
    if _active:
        return torch.profiler.record_function(name)
    return _NULL


def _nested_stages(event, stages):
    """The nearest stage ranges below ``event``."""
    out, todo = [], list(event.cpu_children)
    while todo:
        e = todo.pop()
        if e.name in stages:
            out.append(e)
        else:
            todo.extend(e.cpu_children)
    return out


def attribute_launches(ranges, launches) -> dict:
    """Seconds per innermost range: ``ranges`` are properly nested
    ``(start, end, name)`` intervals, ``launches`` ``(time, seconds)``
    pairs; a launch outside every range is ``other``."""
    out = collections.defaultdict(float)
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    stack, i = [], 0
    for t, s in sorted(launches):
        while i < len(ranges) and ranges[i][0] <= t:
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[stack[-1][2] if stack else "other"] += s
    return out


def _device_stages(events, stages):
    """Device seconds per stage: each kernel, copy or fill is the stage
    open on the host when the runtime call that launched it started (the
    two share a correlation id). This holds for the ctypes-launched
    kernels too, which no torch operation encloses. The device-side
    copies of the stage ranges (spans over their kernels) are not work.
    Returns (per-stage seconds, total, seconds of device work with no
    launch call found)."""
    cpu = torch.autograd.DeviceType.CPU
    device = [e for e in events if e.device_type != cpu
              and not getattr(e, "is_user_annotation", False)
              and e.name not in stages]
    launch_at = {e.id: e.time_range.start for e in events
                 if e.device_type == cpu and e.name.startswith("cu")}
    ranges = [(e.time_range.start, e.time_range.end, e.name)
              for e in events if e.device_type == cpu and e.name in stages]
    launches, unlinked = [], 0.0
    for e in device:
        s = e.time_range.elapsed_us() * 1e-6
        if e.id in launch_at:
            launches.append((launch_at[e.id], s))
        else:
            unlinked += s
    per_stage = attribute_launches(ranges, launches)
    if unlinked:
        per_stage["other"] += unlinked
    return per_stage, sum(per_stage.values()), unlinked


def _cpu_stages(events, stages):
    """CPU-op seconds per stage (a run without a card): a stage's own
    time less its nested stages'."""
    events = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CPU]
    per_stage = collections.defaultdict(float)
    for e in events:
        if e.name in stages:
            per_stage[e.name] += (e.cpu_time_total - sum(
                c.cpu_time_total for c in _nested_stages(e, stages))) * 1e-6
    total = sum(e.self_cpu_time_total for e in events) * 1e-6
    other = total - sum(per_stage.values())
    if other > 0:
        per_stage["other"] += other
    return per_stage, total


def profile_trace(run: Callable[[], None],
                  stages: Iterable[str] = STAGE_NAMES) -> dict:
    """Trace ``run()`` (it must wait for its device work) and return

      {"stages": {stage: seconds}, "total_op_seconds": s,
       "module_seconds": None, "source": "cuda" | "cpu" | "none",
       "unlinked_seconds": s}

    "cuda": device time of the kernels, copies and fills (the card's,
    when one was traced), each in the innermost stage open at its
    launch; "cpu": CPU time of the operations (a CPU run), nested stages
    once, in the innermost. ``other`` holds the time outside every
    stage, and the device work whose launch call the trace lacks
    (``unlinked_seconds``). "none": nothing was captured."""
    global _active
    stages = frozenset(stages)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    _active += 1
    try:
        with torch.profiler.profile(activities=acts) as prof:
            run()
    finally:
        _active -= 1
    events = prof.events()
    per_stage, total, unlinked = _device_stages(events, stages)
    source = "cuda"
    if total <= 0:
        (per_stage, total), unlinked = _cpu_stages(events, stages), 0.0
        source = "cpu" if total > 0 else "none"
    return {"stages": dict(per_stage), "total_op_seconds": total,
            "module_seconds": None, "source": source,
            "unlinked_seconds": unlinked}


def format_stage_table(prof: dict, steps: int, log=print) -> None:
    """PrintStats-style table (learner.cc:252-299) from a trace profile:
    per-step microseconds and share of the traced time per stage."""
    total = prof["total_op_seconds"]
    if total <= 0:
        log("stage profile: no device ops captured")
        return
    what = "device-kernel" if prof["source"] == "cuda" else "CPU-op"
    log(f"fused per-step stage profile over {steps} steps ({what} time; "
        f"attribution=record_function)")
    for name, s in sorted(prof["stages"].items(), key=lambda kv: -kv[1]):
        log(f"{name.upper():16s}: {s / steps * 1e6:9.2f} us/step "
            f"(%{100 * s / total:5.1f})")
    log(f"{'TOTAL OPS':16s}: {total / steps * 1e6:9.2f} us/step")
    if prof.get("unlinked_seconds"):
        log(f"(of OTHER, {prof['unlinked_seconds'] / steps * 1e6:.2f} us/step "
            f"of device work had no launch call in the trace)")

