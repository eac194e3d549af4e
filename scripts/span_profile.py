"""The learner's spans on a benchmark cell, on one NVIDIA GPU.

Run from the root of a checkout:

    PYTHONPATH=. python3 scripts/span_profile.py --workload <cell>
        [--seed N] [--rounds 5] [--out FILE] [--device cuda|cpu]

Sets up the cell as ``python3 -m ammsb_bench.run`` does (graph, split,
``Learner``, one warm-up call) and then, on its timed call (the
traffic's ``trace_calls`` calls at a time, the device fenced before and
after):

  table   the ``--profile`` table over those calls (``profile_trace``):
          per stage or span the device us/step, the host self us/step
          and the device idle us/step while it was the innermost span;
  cost    the seconds per call, in turns over ``--rounds`` rounds, with
          tracing off; under ``profiling.tracing()`` (ranges and
          recorder); under ``torch.profiler`` with no range; under the
          profiler with the stage ranges alone (a trace without the
          recorder); under the profiler and ``tracing()``;
  timers  one call's ``learner.timers`` against its fenced wall time
          and against the host time of its ``chunk`` spans (what the
          host clock read before the timers were timed on the device).

Prints the table and one JSON line; ``--out`` writes the JSON too.
Exits 2 without a card, unless ``--device cpu`` (a rehearsal of the
script's paths, whose times say nothing of a card).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from ammsb_bench import run as bench_run
from mcmc_ammsb_tpu_torch.utils import profiling


def fenced(fn, sync):
    """Host seconds of ``fn()`` between two fences."""
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    return time.perf_counter() - t0


def traced(fn, sync):
    """Seconds of ``fn()`` between two fences under ``tracing()``."""
    with profiling.tracing():
        return fenced(fn, sync)


def under_profiler(fn, sync, cuda, ranges_only=False, record=False):
    """Seconds of ``fn()`` inside a profiler run (its start and stop
    left out), with no stage range, the ranges alone, or ``tracing()``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    real = profiling._Span
    with torch.profiler.profile(activities=acts):
        if record:
            with profiling.tracing():
                return fenced(fn, sync)
        if not ranges_only:
            return fenced(fn, sync)
        profiling._Span = (lambda name, count:
                           torch.profiler.record_function(name))
        profiling._active += 1
        try:
            return fenced(fn, sync)
        finally:
            profiling._active -= 1
            profiling._Span = real


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    spec = bench_run.cell_spec(args.workload,
                               bench_run.load_json(bench_run.REPO
                                                   / "BENCHMARK.json"))
    cell = bench_run.Cell(spec, args.seed, args.device)
    k = int(spec["traffic"].get("trace_calls", 1))
    steps = []

    def calls():
        steps.append(sum(cell.call()[0] for _ in range(k)))

    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(0) if cuda else "cpu",
           "calls": k}

    prof = profiling.profile_trace(lambda: (calls(), cell.sync()))
    n = steps[-1]
    profiling.format_stage_table(prof, n)
    out["table"] = {"steps": n, "device_s": prof["stages"],
                    "host_self_s": prof["host_self_s"],
                    "idle_s": prof["idle_s"]}

    modes = {
        "off": lambda: fenced(calls, cell.sync),
        "tracing": lambda: traced(calls, cell.sync),
        "profiler": lambda: under_profiler(calls, cell.sync, cuda),
        "profiler_ranges": lambda: under_profiler(calls, cell.sync, cuda,
                                                  ranges_only=True),
        "profiler_tracing": lambda: under_profiler(calls, cell.sync, cuda,
                                                   record=True),
    }
    seconds = {m: [] for m in modes}
    order = list(modes)
    for r in range(args.rounds):
        for m in (order if r % 2 == 0 else order[::-1]):
            seconds[m].append(modes[m]() / k)
    out["cost_s_per_call"] = {m: statistics.median(v)
                              for m, v in seconds.items()}
    out["cost_runs"] = seconds

    # the timers of one timed call and of one run() of a whole chunk:
    # device seconds against the fenced wall time and against the host
    # time of the chunks (the enqueue)
    lrn = cell.learner
    for key, fn in (("timers_call", calls),
                    ("timers_run", lambda: lrn.run(lrn.cfg.steps_per_call))):
        before = dict(lrn.timers.seconds)
        with profiling.tracing():
            wall = fenced(fn, cell.sync)
        spans = profiling.recorded()
        after = lrn.timers.seconds
        out[key] = {
            "wall_s": wall,
            "stages_s": {name: after[name] - before.get(name, 0.0)
                         for name in after},
            "chunk_host_s": sum(s.end_ns - s.start_ns for s in spans
                                if s.name == "chunk") * 1e-9,
            "steps": sum(s.count for s in spans if s.name == "chunk")}
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
