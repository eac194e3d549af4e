"""The port's span recorder (utils/profiling.py: ``tracing``, ``stage``,
``recorded``), the spans the learner and the window engine open, the
benchmark's readers of them, and the stage table's host and idle
columns, on the CPU; on a card (``-m cuda``), where the host waits for
the card and what the stage timers read. This file imports no JAX, so
its ``cuda`` tests run on the card with ``python -m pytest --noconftest
-m cuda tests/test_torch_tracing.py``."""

import json
import os
import subprocess
import sys
import time
import traceback
import warnings

import pytest
import torch

from mcmc_ammsb_tpu_torch import config, learner
from mcmc_ammsb_tpu_torch.data import Graph, generate_sets, synthetic_edges
from mcmc_ammsb_tpu_torch.ops import window
from mcmc_ammsb_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the spans that wait for the card
WAITS = ("readback", "device_wait")


def tiny(n_nodes=300, **kw):
    base = dict(K=8, mini_batch_size=8, num_node_sample=4, steps_per_call=10,
                device_sampling=True, shared_neighbors=True, window=4)
    base.update(kw)
    n, u, v = synthetic_edges(n_nodes, 8, seed=1)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=2)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = config.Config(**base).finalize(n, split.total_edges,
                                         graph.max_fan_out)
    return cfg, graph, split


def children(spans, parent):
    return [s for s in spans if s.parent == parent]


def names(spans):
    return [s.name for s in spans]


@pytest.mark.parametrize("steps", [10, 12])
def test_windowed_learner_span_tree(steps):
    """call > chunk > {sampling and hoisting, window_kernel x (S // T),
    window_tail (count S % T) > the short window's window_correct,
    window_prep and the plain window's copies}, then device_wait;
    run_with_ppx, per group of chunks between readbacks (one chunk
    here), the chunk and its evaluation (after the copy of its count, a
    device_wait), then readback and device_wait; each span closes inside
    its parent."""
    cfg, graph, split = tiny(steps_per_call=steps)
    lrn = learner.Learner(cfg, graph, split, "cpu")
    lrn.run(steps)
    with profiling.tracing():
        lrn.run(steps)
    spans = profiling.recorded()
    assert names(children(spans, -1)) == ["call"]
    assert names(children(spans, 0)) == ["chunk", "device_wait"]
    assert spans[1].count == steps
    inner = children(spans, 1)
    assert names(inner)[:1] == ["device_sampling"]
    assert names(inner).count("window_kernel") == steps // cfg.window
    tails = [s for s in inner if s.name == "window_tail"]
    assert [s.count for s in tails] == ([steps % cfg.window]
                                        if steps % cfg.window else [])
    if tails:
        i = spans.index(tails[0])
        # the plain window (the CPU's) copies each step's two step sizes
        # and eta from the host: three device_wait spans a step, which
        # the kernel, taking them as launch parameters, does not open
        assert names(children(spans, i)) == (
            ["window_correct", "window_prep"]
            + ["device_wait"] * 3 * (steps % cfg.window))
    for i, s in enumerate(spans):
        assert s.parent < i and s.end_ns >= s.start_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns

    with profiling.tracing():
        lrn.run_with_ppx(2 * steps, steps)
    spans = profiling.recorded()
    assert names(children(spans, -1)) == ["call"]
    assert names(children(spans, 0)) == ["chunk", "device_wait", "ppx",
                                         "readback", "device_wait"] * 2
    assert [s.count for s in spans if s.name == "chunk"] == [steps, steps]

    with profiling.tracing():
        lrn.heldout_perplexity()
    assert [(s.name, s.parent) for s in profiling.recorded()] == [
        ("call", -1), ("device_wait", 0), ("ppx", 0), ("readback", 0)]


@pytest.mark.parametrize("steps", [10, 12])
def test_window_spans_carry_their_layout(steps):
    """Traced, every window_kernel span (S // T of them) and the
    window_tail span (count S % T) of a tiny windowed learner on the CPU
    carries the tag ``torch`` (the plain window ran it), and no other
    span a tag; ``profile_trace`` counts them and the stage table names
    the layouts. Untraced, neither the learner nor ``tag`` records
    anything."""
    cfg, graph, split = tiny(steps_per_call=steps)
    lrn = learner.Learner(cfg, graph, split, "cpu")
    lrn.run(steps)
    with profiling.tracing():
        lrn.run(steps)
    spans = profiling.recorded()
    windows = [s for s in spans if s.name == "window_kernel"]
    tails = [s for s in spans if s.name == "window_tail"]
    tail = steps % cfg.window
    assert len(windows) == steps // cfg.window
    assert [s.count for s in tails] == ([tail] if tail else [])
    assert [s.tag for s in windows + tails] == ["torch"] * (
        len(windows) + len(tails))
    assert all(s.tag is None for s in spans
               if s.name not in ("window_kernel", "window_tail"))
    want = {"window_kernel": {"torch": steps // cfg.window}}
    if tail:
        want["window_tail"] = {"torch": 1}
    assert profiling.tags_by_name(spans) == want
    prof = profiling.profile_trace(lambda: lrn.run(steps))
    assert prof["tags"] == want
    lines = []
    profiling.format_stage_table(prof, steps, lines.append)
    assert f"window_kernel layouts: torch x{steps // cfg.window}" in lines

    profiling.reset()
    lrn.run(steps)
    profiling.tag("resident")
    assert profiling.recorded() == []


def test_stage_records_nothing_without_tracing():
    """Outside ``tracing()`` every stage is the one shared null context
    and the recorder stays empty; ``tracing()`` empties it on entry and
    leaves the switch as it found it."""
    cfg, graph, split = tiny()
    lrn = learner.Learner(cfg, graph, split, "cpu")
    with profiling.tracing():
        lrn.run(10)
    assert profiling.recorded()
    profiling.reset()
    lrn.run(10)
    lrn.heldout_perplexity()
    assert profiling.recorded() == []
    assert profiling._active == 0
    assert profiling.stage("chunk", 10) is profiling.stage("call")
    assert profiling.stage("call") is profiling._NULL
    with profiling.tracing():
        pass
    assert profiling.recorded() == [] and profiling._active == 0


def test_spans_share_the_profilers_clock(monkeypatch):
    """Under ``profile_trace`` each span, moved onto the profiler's clock
    by the anchors, lies within its own profiler range give or take
    50 us, and the spans start a median of at most 50 us after their
    ranges. (A span's clock is read inside its range, so a thread
    descheduled between the range's start and that read delays the one
    span's start, never its place inside the range.)"""
    made = []

    class Keep(torch.profiler.profile):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    cfg, graph, split = tiny()
    lrn = learner.Learner(cfg, graph, split, "cpu")
    lrn.run(10)
    monkeypatch.setattr(torch.profiler, "profile", Keep)
    prof = profiling.profile_trace(lambda: lrn.run(20))
    events = made[0].events()
    offset = profiling.profiler_offset_us(events)
    assert offset is not None
    cpu = torch.autograd.DeviceType.CPU
    spans = profiling.recorded()
    assert {"call", "chunk", "window_tail", "device_wait"} <= set(
        names(spans))
    gaps = []
    for name in set(names(spans)):
        ranges = sorted((e.time_range.start, e.time_range.end)
                        for e in events
                        if e.name == name and e.device_type == cpu)
        mine = [s for s in spans if s.name == name]
        assert len(ranges) == len(mine), name
        for (r0, r1), s in zip(ranges, mine):
            s0, s1 = s.start_ns / 1e3 + offset, s.end_ns / 1e3 + offset
            assert r0 - 50.0 <= s0 <= s1 <= r1 + 50.0, (name, s0 - r0,
                                                        r1 - s1)
            gaps.append(abs(s0 - r0))
    assert sorted(gaps)[len(gaps) // 2] <= 50.0
    assert prof["host_self_s"]["chunk"] > 0 and prof["idle_s"] == {}


def test_host_self_and_idle_by_span():
    """A span's self time leaves out its children; device idle time goes
    to the innermost span open over it, pieces of one gap to several
    spans, time outside every span to none."""
    spans = [profiling.Span("call", -1, 0, 100_000, None),
             profiling.Span("chunk", 0, 10_000, 60_000, 5),
             profiling.Span("window_tail", 1, 40_000, 50_000, 1),
             profiling.Span("device_wait", 0, 70_000, 100_000, None)]
    self_s = profiling.host_self_seconds(spans)
    assert self_s == pytest.approx({"call": 20e-6, "chunk": 40e-6,
                                    "window_tail": 10e-6,
                                    "device_wait": 30e-6})
    pieces = profiling.innermost_pieces(
        [(s.start_ns / 1e3, s.end_ns / 1e3, s.name) for s in spans])
    assert pieces == [(0, 10, "call"), (10, 40, "chunk"),
                      (40, 50, "window_tail"), (50, 60, "chunk"),
                      (60, 70, "call"), (70, 100, "device_wait")]
    gaps = [(5, 15), (45, 65), (90, 120)]
    assert profiling.overlap_by_name(pieces, gaps) == pytest.approx(
        {"call": 10, "chunk": 15, "window_tail": 5, "device_wait": 10})


def _window_host_reader():
    from ammsb_bench import run

    return run.reader(run.HERE, "window_kernel.host_us_per_step")


def test_window_kernel_host_reader(monkeypatch):
    """``window_kernel.host_us_per_step`` on hand-made spans: the
    window_kernel spans' host time less the device_wait and readback
    spans inside them (a wait inside a wait once), over the chunk's
    steps; None where a window_kernel span has no tag, where the tags
    name two layouts, or where the steps are not the stretch's."""
    span = profiling.Span
    spans = [span("call", -1, 0, 1_000_000, None),
             span("chunk", 0, 0, 900_000, 24),
             span("window_kernel", 1, 100_000, 200_000, None, "resident"),
             span("device_wait", 2, 150_000, 170_000, None),
             span("readback", 3, 160_000, 165_000, None),
             span("window_kernel", 1, 300_000, 360_000, None, "resident"),
             span("readback", 5, 310_000, 315_000, None),
             span("window_tail", 1, 400_000, 420_000, 4, "resident"),
             span("device_wait", 0, 900_000, 1_000_000, None)]
    read = _window_host_reader()
    rec = {"trace": {"steps": 24}}
    monkeypatch.setattr(profiling, "recorded", lambda: list(spans))
    assert read(rec) == pytest.approx((100 - 20 + 60 - 5) / 24)
    assert read({"trace": {"steps": 12}}) is None
    good = list(spans)
    spans[5] = spans[5]._replace(tag=None)
    assert read(rec) is None
    spans[:] = good
    spans[7] = spans[7]._replace(tag="nodes")
    assert read(rec) is None
    spans[:] = good[:2] + good[8:]
    assert read(rec) is None


def test_stage_table_columns():
    """Each row: device us/step and share, then host self and device
    idle us/step; '-' where no card was traced."""
    prof = {"stages": {"window_kernel": 0.9, "other": 0.1},
            "total_op_seconds": 1.0, "source": "cuda",
            "unlinked_seconds": 0.0,
            "host_self_s": {"chunk": 0.2, "window_tail": 0.05},
            "idle_s": {"window_tail": 0.04, "chunk": 0.01}}
    lines = []
    profiling.format_stage_table(prof, 1000, lines.append)
    rows = {x.split(":")[0].strip(): x for x in lines[1:]}
    assert set(rows) == {"WINDOW_KERNEL", "OTHER", "CHUNK", "WINDOW_TAIL",
                         "TOTAL OPS"}
    assert rows["WINDOW_TAIL"].split()[-4:] == ["host", "50.00", "idle",
                                                "40.00"]
    assert rows["WINDOW_KERNEL"].split()[2:5] == ["900.00", "us/step", "(%"]
    prof.update(source="cpu", idle_s={})
    lines = []
    profiling.format_stage_table(prof, 1000, lines.append)
    assert all(x.endswith("idle         -") for x in lines[1:])


def test_tiny_cell_reports_the_host_metrics():
    """A traced run of the benchmark's tiny cell reports the learner's,
    the chunk tail's and the whole windows' host microseconds per step,
    read from the spans of the traced stretch alone. In a process of its
    own: the command refuses its result where JAX is loaded, as it is in
    this one."""
    code = ("import json; from ammsb_bench.tests.conftest import run_tiny; "
            "rc, line, err = run_tiny('tiny.ppx200', 2 ** 31 + 61, trace=1); "
            "print(json.dumps([rc, line, err[-2000:]]))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    rc, line, err = json.loads(out.stdout.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True, err
    got = {k: v["value"] for k, v in line["metrics"].items()}
    for name in ("learner.host_us_per_step", "learner.host_us_per_step"
                 ".ppx100", "window_tail.host_us_per_step",
                 "window_tail.host_us_per_step.ppx100",
                 "window_kernel.host_us_per_step"):
        assert got[name] > 0, name
        assert line["metrics"][name]["unit"] == "us/step"
    assert got["window_tail.host_us_per_step"] \
        < got["learner.host_us_per_step"]
    assert got["window_kernel.host_us_per_step"] \
        < got["learner.host_us_per_step"]


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at
    import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_host_waits_only_in_readback_and_device_wait(cuda_device):
    """At K = 16384 (the grid layout of the window kernel), one 100-step chunk
    and one evaluation under the sync debug mode: every call that makes
    the host wait for the card lies inside a readback or device_wait
    span, which ``learner.host_us_per_step`` leaves out."""
    cfg, graph, split = tiny(n_nodes=2000, K=16384, mini_batch_size=32,
                             num_node_sample=32, steps_per_call=100,
                             window=12, ds_link_cap=32)
    lrn = learner.Learner(cfg, graph, split, cuda_device)
    lrn.run(100)
    lrn.heldout_perplexity()
    lrn.run_with_ppx(100, 100)
    syncs = []

    def seen(message, *args, **kw):
        if "called a synchronizing" in str(message):
            site = [f"{f.filename.rsplit('/', 2)[-1]}:{f.lineno}"
                    for f in traceback.extract_stack()
                    if "mcmc_ammsb_tpu_torch" in f.filename][-2:]
            syncs.append((time.perf_counter_ns(), site))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with profiling.tracing():
                lrn.run(100)
                lrn.heldout_perplexity()
                lrn.run_with_ppx(100, 100)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    spans = profiling.recorded()
    assert syncs, "the readbacks should warn"
    outside = [site for t, site in syncs
               if not any(s.name in WAITS and s.start_ns <= t <= s.end_ns
                          for s in spans)]
    assert not outside, (len(outside), outside[:5])


@pytest.mark.cuda
def test_k1024_windows_are_tagged_resident(cuda_device):
    """At youtube-k1024's K = 1024, T = 12, one traced 1000-step chunk on
    a card: 83 window_kernel spans and one window_tail span (count 4),
    each tagged ``resident``, and 84 resident launches counted."""
    cfg, graph, split = tiny(n_nodes=2000, K=1024, mini_batch_size=32,
                             num_node_sample=32, steps_per_call=1000,
                             window=12, ds_link_cap=32)
    lrn = learner.Learner(cfg, graph, split, cuda_device)
    lrn.run(1000)
    window.window_apply_cuda.layouts.clear()
    with profiling.tracing():
        lrn.run(1000)
    spans = profiling.recorded()
    assert [s.count for s in spans if s.name == "window_tail"] == [4]
    assert profiling.tags_by_name(spans) == {
        "window_kernel": {"resident": 83}, "window_tail": {"resident": 1}}
    assert window.window_apply_cuda.layouts == {"resident": 84}


@pytest.mark.cuda
def test_k16384_windows_are_tagged_grid(cuda_device):
    """At the benchmark cells' K = 16384, T = 12, one traced 1000-step
    chunk on a card: 83 window_kernel spans and one window_tail span
    (count 4), each tagged ``grid``, and 84 grid launches counted: the
    main path runs all its windows and its tail in the grid layout."""
    cfg, graph, split = tiny(n_nodes=2000, K=16384, mini_batch_size=32,
                             num_node_sample=32, steps_per_call=1000,
                             window=12, ds_link_cap=32)
    lrn = learner.Learner(cfg, graph, split, cuda_device)
    lrn.run(1000)
    window.window_apply_cuda.layouts.clear()
    with profiling.tracing():
        lrn.run(1000)
    spans = profiling.recorded()
    assert [s.count for s in spans if s.name == "window_tail"] == [4]
    assert profiling.tags_by_name(spans) == {
        "window_kernel": {"grid": 83}, "window_tail": {"grid": 1}}
    assert window.window_apply_cuda.layouts == {"grid": 84}


@pytest.mark.cuda
def test_stage_timers_read_device_seconds(cuda_device):
    """On a card ``device_step`` and ``total`` are the card's seconds
    from the chunk's first work to its last: within 10% of the fenced
    wall time, the host's enqueue notwithstanding; ``sampling`` stays
    on the host clock."""
    cfg, graph, split = tiny(n_nodes=2000, K=16384, mini_batch_size=32,
                             num_node_sample=32, steps_per_call=100,
                             window=12, ds_link_cap=32)
    lrn = learner.Learner(cfg, graph, split, cuda_device)
    lrn.run(100)
    before = dict(lrn.timers.seconds)
    calls = dict(lrn.timers.calls)
    t0 = time.perf_counter()
    lrn.run(100)
    wall = time.perf_counter() - t0
    got = {k: v - before.get(k, 0.0) for k, v in lrn.timers.seconds.items()}
    assert 0.9 * wall <= got["device_step"] <= got["total"] <= wall
    assert lrn.timers.calls["device_step"] == calls["device_step"] + 1
