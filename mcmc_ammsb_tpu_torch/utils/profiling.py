"""Per-stage attribution of the training loop (counterpart of
``mcmc_ammsb_tpu/utils/profiling.py``), and the port's span recorder.

The reference times every kernel launch with device events and prints a
stage table (learner.cc:252-299). The port's loop is a sequence of
torch launches and hand-written kernels, so ``profile_trace`` runs it
under ``torch.profiler`` and adds up, for each stage, the time of the
work issued inside the stage's range: the device time of its kernels on
a card, the CPU time of its operations on the CPU. The ranges are the
JAX package's ``jax.named_scope`` stage names (``STAGE_NAMES``), opened
by ``stage(name)`` in the step functions; work inside a nested stage is
the inner stage's, work outside every stage is ``other``. The port adds
spans at its own boundaries: ``call`` (each public entry of the
learner), ``chunk`` (a chunk of steps, with its step count),
``window_tail`` (the steps after a chunk's last window, with their
count), ``readback`` (an evaluation's device-to-host copy) and
``device_wait`` (where the host waits for the card: the learner's fence,
and an unwindowed step's copies from pageable memory). None of them opens
inside a stage whose device time is read, so each only takes the device
work that fell under no stage before.

While ``tracing()`` (or ``profile_trace``) is open, ``stage`` opens the
profiler range and keeps one span in memory: its name, the index of the
span it opened in, its host start and end (``time.perf_counter_ns``),
its count and its tag; ``recorded()`` returns them. ``tag(label)``
labels the innermost open span (the window engine: the kernel layout
that ran a window, ``torch`` for the plain version); it opens no range.
``tracing()`` opens a few zero-length ranges (``ANCHOR``) and reads the
clock inside each, which maps the spans onto the profiler's clock
(``profiler_offset_us``).
While no trace runs ``stage`` returns a shared null context and records
nothing, and ``tag`` does nothing, each at the cost of one integer test:
every path of the port is bound by the host's 11-19 us per launch.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable, Iterable, List, NamedTuple, Optional

import torch

# the production stage names (the JAX package's list, then the port's)
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
    # the port's spans (learner.py, ops/window.py)
    "call",
    "chunk",
    "window_tail",
    "readback",
    "device_wait",
)

#: the zero-length range inside which ``tracing()`` reads its clock,
#: ``ANCHORS`` times: the least delayed read maps the clocks, so a host
#: thread descheduled during one read does not shift the mapping
ANCHOR = "profiling_anchor"
ANCHORS = 8


class Span(NamedTuple):
    """One recorded ``stage()`` call."""

    name: str
    parent: int               # index of the enclosing span; -1 at the top
    start_ns: int             # time.perf_counter_ns()
    end_ns: Optional[int]     # None while the span is open
    count: Optional[int]      # steps of a ``chunk`` or ``window_tail``
    tag: Optional[str] = None  # ``tag()``'s label, e.g. a window's layout


_NULL = contextlib.nullcontext()
_active = 0
_spans: List[list] = []       # [name, parent, start_ns, end_ns, count, tag]
_open: List[int] = []         # indices of the open spans, innermost last
_anchors: List[int] = []      # perf_counter_ns read in each ANCHOR range


class _Span(torch.profiler.record_function):
    """A stage's profiler range and its span in the recorder. The clock
    is read inside the range, so the span lies within it."""

    def __init__(self, name: str, count: Optional[int]):
        super().__init__(name)
        self.count = count
        self.row = None

    def __enter__(self):
        super().__enter__()
        self.row = [self.name, _open[-1] if _open else -1,
                    time.perf_counter_ns(), None, self.count, None]
        _open.append(len(_spans))
        _spans.append(self.row)
        return self

    def __exit__(self, *exc):
        self.row[3] = time.perf_counter_ns()
        if _open:
            _open.pop()
        return super().__exit__(*exc)


def stage(name: str, steps: Optional[int] = None):
    """Stage ``name``'s range and span while a trace runs (``steps``: the
    count of a ``chunk`` or ``window_tail``), else a null context."""
    if _active:
        return _Span(name, steps)
    return _NULL


def tag(label: str) -> None:
    """Label the innermost open span while a trace runs; else, or with
    no span open, nothing."""
    if _active and _open:
        _spans[_open[-1]][5] = label


def reset() -> None:
    """Empty the recorder."""
    _spans.clear()
    _open.clear()
    _anchors.clear()


def recorded() -> List[Span]:
    """The spans recorded since the last ``reset``, in the order they
    opened (a parent before its children)."""
    return [Span(*row) for row in _spans]


@contextlib.contextmanager
def tracing():
    """Open the stage ranges and record their spans inside; the recorder
    is emptied on entry. Open it inside ``torch.profiler.profile`` to map
    the spans onto the profiler's clock (``profiler_offset_us``)."""
    global _active
    reset()
    _active += 1
    try:
        for _ in range(ANCHORS):
            with torch.profiler.record_function(ANCHOR):
                _anchors.append(time.perf_counter_ns())
        yield
    finally:
        _active -= 1


def profiler_offset_us(events) -> Optional[float]:
    """Microseconds to add to a span's ``*_ns / 1e3`` to put it on the
    clock of the profiler ``events`` (their ``time_range``), from the
    last ``tracing()``'s ``ANCHOR`` ranges: each clock read comes after
    its range's start, so the largest difference is the least delayed.
    None where the trace lacks them."""
    cpu = torch.autograd.DeviceType.CPU
    starts = sorted(e.time_range.start for e in events
                    if e.name == ANCHOR and e.device_type == cpu)
    if not _anchors or len(starts) < len(_anchors):
        return None
    return max(s - a / 1e3 for s, a in zip(starts[-len(_anchors):],
                                           _anchors))


def host_self_seconds(spans: List[Span]) -> dict:
    """Host seconds per span name, less the time of the spans opened
    inside (a span's self time)."""
    out = collections.defaultdict(float)
    for s in spans:
        if s.end_ns is None:
            continue
        d = (s.end_ns - s.start_ns) * 1e-9
        out[s.name] += d
        if s.parent >= 0:
            out[spans[s.parent].name] -= d
    return dict(out)


def tags_by_name(spans: List[Span]) -> dict:
    """How many spans of each name carry each tag: {name: {tag: n}}."""
    out = collections.defaultdict(collections.Counter)
    for s in spans:
        if s.tag is not None:
            out[s.name][s.tag] += 1
    return {name: dict(tags) for name, tags in out.items()}


def innermost_pieces(intervals):
    """Nested ``(start, end, name)`` intervals cut into disjoint
    ``(start, end, name)`` pieces, each named by the innermost interval
    open over it; time outside every interval is left out."""
    pieces, stack, t = [], [], None
    for a, b, name in sorted(intervals, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][0] <= a:
            end, inner = stack.pop()
            if t < end:
                pieces.append((t, end, inner))
                t = end
        if stack and t < a:
            pieces.append((t, a, stack[-1][1]))
        t = a
        stack.append((b, name))
    while stack:
        end, inner = stack.pop()
        if t < end:
            pieces.append((t, end, inner))
            t = end
    return pieces


def overlap_by_name(pieces, gaps) -> dict:
    """Length of ``gaps`` (sorted, disjoint ``(start, end)``) inside each
    name's ``pieces`` (sorted, disjoint, from ``innermost_pieces``)."""
    out = collections.defaultdict(float)
    i = 0
    for a, b, name in pieces:
        while i < len(gaps) and gaps[i][1] <= a:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < b:
            out[name] += min(b, gaps[j][1]) - max(a, gaps[j][0])
            j += 1
    return dict(out)


def idle_by_span(events, spans: List[Span], stages) -> dict:
    """Device idle seconds while each span was the innermost one open,
    over the recorded stretch: the time in which no kernel, copy or fill
    of the trace ran, on the profiler's clock. Empty without a card's
    events or a clock anchor."""
    offset = profiler_offset_us(events)
    cpu = torch.autograd.DeviceType.CPU
    busy = sorted((e.time_range.start, e.time_range.end) for e in events
                  if e.device_type != cpu
                  and not getattr(e, "is_user_annotation", False)
                  and e.name not in stages)
    closed = [s for s in spans if s.end_ns is not None]
    if offset is None or not busy:
        return {}
    pieces = innermost_pieces([(s.start_ns / 1e3 + offset,
                                s.end_ns / 1e3 + offset, s.name)
                               for s in closed])
    if not pieces:
        return {}
    gaps, t = [], pieces[0][0]
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if pieces[-1][1] > t:
        gaps.append((t, pieces[-1][1]))
    return {k: v * 1e-6 for k, v in overlap_by_name(pieces, gaps).items()}


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
    """Trace ``run()`` (it must wait for its device work) under
    ``tracing()`` and return

      {"stages": {stage: seconds}, "total_op_seconds": s,
       "source": "cuda" | "cpu" | "none", "unlinked_seconds": s,
       "host_self_s": {span: seconds}, "idle_s": {span: seconds},
       "tags": {span: {tag: count}}}

    "cuda": device time of the kernels, copies and fills (the card's,
    when one was traced), each in the innermost stage open at its
    launch; "cpu": CPU time of the operations (a CPU run), nested stages
    once, in the innermost. ``other`` holds the time outside every
    stage, and the device work whose launch call the trace lacks
    (``unlinked_seconds``). "none": nothing was captured.
    ``host_self_s`` is each span's host self time from the recorder
    (``host_self_seconds``), ``idle_s`` the device's idle time while it
    was the innermost span open (``idle_by_span``; empty without a
    card), ``tags`` the recorded spans' tags by name
    (``tags_by_name``: the window layouts that ran)."""
    stages = frozenset(stages)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with tracing():
            run()
    events = prof.events()
    spans = recorded()
    per_stage, total, unlinked = _device_stages(events, stages)
    source = "cuda"
    if total <= 0:
        (per_stage, total), unlinked = _cpu_stages(events, stages), 0.0
        source = "cpu" if total > 0 else "none"
    return {"stages": dict(per_stage), "total_op_seconds": total,
            "source": source, "unlinked_seconds": unlinked,
            "host_self_s": host_self_seconds(spans),
            "idle_s": (idle_by_span(events, spans, stages)
                       if source == "cuda" else {}),
            "tags": tags_by_name(spans)}


def format_stage_table(prof: dict, steps: int, log=print) -> None:
    """PrintStats-style table (learner.cc:252-299) from a trace profile:
    per stage or span, per-step microseconds and share of the traced
    time of its work, its host self time, and the device's idle time
    while it was the innermost span open ("-" without a card); then, per
    span name, the tags its spans carried (the window layouts)."""
    total = prof["total_op_seconds"]
    if total <= 0:
        log("stage profile: no device ops captured")
        return
    what = "device-kernel" if prof["source"] == "cuda" else "CPU-op"
    log(f"fused per-step stage profile over {steps} steps ({what} time; "
        f"attribution=record_function; host self and device idle us/step "
        f"by span)")
    work, host = prof["stages"], prof.get("host_self_s", {})
    idle = prof.get("idle_s", {})
    names = sorted(set(work) | set(host) | set(idle),
                   key=lambda k: (-work.get(k, 0.0), -host.get(k, 0.0), k))
    per = steps / 1e6
    for name in names:
        s = work.get(name, 0.0)
        gap = f"{idle.get(name, 0.0) / per:9.2f}" if idle else f"{'-':>9s}"
        log(f"{name.upper():16s}: {s / per:9.2f} us/step "
            f"(%{100 * s / total:5.1f})  host {host.get(name, 0.0) / per:9.2f}"
            f"  idle {gap}")
    log(f"{'TOTAL OPS':16s}: {total / per:9.2f} us/step  host "
        f"{sum(host.values()) / per:9.2f}  idle "
        + (f"{sum(idle.values()) / per:9.2f}" if idle else f"{'-':>9s}"))
    if prof.get("unlinked_seconds"):
        log(f"(of OTHER, {prof['unlinked_seconds'] / per:.2f} us/step "
            f"of device work had no launch call in the trace)")
    for name, tags in sorted(prof.get("tags", {}).items()):
        log(f"{name} layouts: " + ", ".join(
            f"{t} x{n}" for t, n in sorted(tags.items())))
