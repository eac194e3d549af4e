"""Run one cell of ``BENCHMARK.json`` once.

    python3 -m ammsb_bench.run --workload <name> --seed <n>
        --seconds <s> --trace <0|1>

Set-up: the configuration's graph (generated, or read from the cache in
``ammsb_bench/.cache/``), its edges in the order the seed draws, then
the program: ``generate_sets``, ``Graph.from_edges``, the ``Learner``
(edge sets, pi drawn on the card, the kernels loaded from the checkout's
build directory) and one warm-up call of the cell's own shape. The
window repeats the timed call of the traffic mix, as the program's CLI
runs its training loop, until ``--seconds`` have passed, and ends in a
device fence. With ``--trace 1`` a stretch of whole calls in the middle
of the window runs under the profiler (``trace.py``).

After the window the peak memory is read, the timed call runs once more
under ``check.Capture`` and the reference judges it (``check.py``); then
the run prints the compared numbers beside their limits as its last
lines on standard error, and one JSON line on standard output: the
cell's end-to-end metrics (``--trace 0``) or per-layer metrics
(``--trace 1``), each computed by its reader ``metrics/<name>.py``.

The run exits 2 without a result when no CUDA card (or fewer than the
cell's chips) is present, and 3 when JAX, the JAX package or flax is
loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

from ammsb_bench import check, graphs  # noqa: E402
from ammsb_bench import trace as tracing  # noqa: E402
from ammsb_bench.counts import Shape, edge_lanes  # noqa: E402
from mcmc_ammsb_tpu_torch import learner as learner_mod  # noqa: E402
from mcmc_ammsb_tpu_torch.config import (  # noqa: E402
    Config, EdgeSetBackend, SampleStrategy)
from mcmc_ammsb_tpu_torch.data import Graph, generate_sets  # noqa: E402
from mcmc_ammsb_tpu_torch.ops import window as window_mod  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent

#: top-level module names that may not be loaded when the result is
#: printed, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "mcmc_ammsb_tpu")


def forbidden_modules() -> list:
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(workload: str, bench: dict, root: Path = HERE) -> dict:
    """Everything one cell needs, found by the names ``bench`` (the
    contents of ``BENCHMARK.json``) gives: its configuration, traffic
    mix, limits and the metrics it reports in each mode."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells are "
                         f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(REPO / configs[w["config"]]["file"])
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [workload])
             and m["moves"] in e2e_names]
    return {"name": workload, "chips": int(w["chips"]), "config": config,
            "traffic": load_json(root / "traffic" / f"{w['traffic']}.json"),
            "limits": load_json(root / "limits" / f"{workload}.json"),
            "end_to_end": e2e, "per_layer": layer, "root": root}


def reader(root: Path, name: str):
    """The ``read(record)`` function of ``metrics/<name>.py``. A metric
    ``<base>.<variant>`` without a reader of its own is read by the
    reader of ``<base>`` (the same quantity, named apart for the cells
    that report it against another end-to-end metric)."""
    candidates = [name]
    while "." in candidates[-1]:
        candidates.append(candidates[-1].rsplit(".", 1)[0])
    for base in candidates:
        path = next((d / "metrics" / f"{base}.py" for d in (root, HERE)
                     if (d / "metrics" / f"{base}.py").exists()), None)
        if path is not None:
            break
    else:
        raise FileNotFoundError(f"no reader for metric {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"ammsb_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def program_config(config: dict, seeds: dict, interval: int, n: int,
                   total_edges: int, max_fan_out: int):
    """The program's ``Config`` for the cell, finalized on the graph."""
    m = config["model"]
    cfg = Config(
        K=int(m["K"]), alpha=float(m["alpha"]), epsilon=float(m["epsilon"]),
        eta0=float(m["eta0"]), eta1=float(m["eta1"]), a=float(m["a"]),
        b=float(m["b"]), c=float(m["c"]),
        mini_batch_size=int(m["mini_batch_size"]),
        num_node_sample=int(m["num_node_sample"]),
        strategy=SampleStrategy.parse(m["strategy"]),
        heldout_ratio=float(m["heldout_ratio"]), ppx_interval=interval,
        phi_seed=seeds["phi"], beta_seed=seeds["beta"],
        neighbor_seed=seeds["neighbor"], sample_seed=seeds["sample"],
        init_seed=seeds["init"], steps_per_call=int(m["steps_per_call"]),
        device_sampling=bool(m["device_sampling"]),
        shared_neighbors=bool(m["shared_neighbors"]),
        ds_link_cap=int(m["ds_link_cap"]), window=int(m["window"]),
        edgeset_backend=EdgeSetBackend(m["edgeset_backend"]),
        node_coin=m["node_coin"], pi_dtype=m["pi_dtype"])
    return cfg.finalize(n, total_edges, max_fan_out)


def timed_call(learner, steps_per_call: int, interval: int):
    """The CLI training loop's call for one stretch of steps
    (``cli._train``): ``run_with_ppx`` over whole evaluation intervals
    when a call holds several, else ``run`` and ``heldout_perplexity``.
    Returns a function that makes one call and gives (steps,
    evaluations, the last perplexity)."""
    if steps_per_call > interval:
        take = steps_per_call - steps_per_call % interval

        def call():
            series = learner.run_with_ppx(take, interval)
            return take, len(series), series[-1]["ppx"]
    else:
        def call():
            learner.run(interval)
            return interval, 1, learner.heldout_perplexity()
    return call


def shape_of(config: dict, n: int, total_edges: int, fan_out: int,
             interval: int):
    """The counts' shape, from the configuration and the graph, with
    the lanes at capacity until the run has counted the lanes filled."""
    m = config["model"]
    e_cap = edge_lanes(int(m["mini_batch_size"]), fan_out,
                       int(m["ds_link_cap"]))
    held = total_edges - math.ceil((1.0 - float(m["heldout_ratio"]) / 2.0)
                                   * total_edges)
    return Shape(T=int(m["window"]), B=e_cap + 1, E=e_cap,
                 n=int(m["num_node_sample"]), K=int(m["K"]),
                 pi_bytes=2 if m["pi_dtype"] == "bfloat16" else 4,
                 H=2 * held, interval=interval)


class Cell:
    """One run's set-up: the graph in the run's order, the program's
    learner after its warm-up call, and the timed call."""

    def __init__(self, spec: dict, seed: int, device: str):
        self.spec, self.device = spec, device
        self.cuda = device == "cuda"
        config, traffic = spec["config"], spec["traffic"]
        self.interval = int(traffic["ppx_interval"])
        self.seeds = graphs.run_seeds(seed)
        t0 = time.perf_counter()
        self.n, u0, v0, cache_hit = graphs.load_graph(config["graph"])
        self.u, self.v = graphs.ordered_edges(u0, v0, self.seeds["order"])
        del u0, v0
        t1 = time.perf_counter()
        split = generate_sets(self.n, self.u, self.v,
                              float(config["model"]["heldout_ratio"]),
                              seed=self.seeds["split"])
        graph = Graph.from_edges(self.n, split.training_u, split.training_v)
        t2 = time.perf_counter()
        self.cfg = program_config(config, self.seeds, self.interval, self.n,
                                  split.total_edges, graph.max_fan_out)
        self.shape = shape_of(config, self.n, split.total_edges,
                              graph.max_fan_out, self.interval)
        self.learner = learner_mod.Learner(self.cfg, graph, split, device)
        self.call = timed_call(self.learner, self.cfg.steps_per_call,
                               self.interval)
        self.call()
        self.sync()
        t3 = time.perf_counter()
        self.setup = {"setup_s": t3 - T_START, "data_s": t2 - t1,
                      "graph_s": t1 - t0, "warm_s": t3 - t2,
                      "cache_hit": cache_hit}
        cfg = self.cfg
        print(f"[{spec['name']}] set-up {t3 - T_START:.3f} s (start and "
              f"imports {t0 - T_START:.3f} s, graph "
              f"{t1 - t0:.3f} s, cache {'hit' if cache_hit else 'miss'}; "
              f"data {t2 - t1:.3f} s; learner and warm-up {t3 - t2:.3f} s):"
              f" N={cfg.N} E={cfg.E} K={cfg.K} pi {cfg.pi_dtype} "
              f"T={cfg.window} B={cfg.max_batch_nodes}", file=sys.stderr)

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def checked_call(self):
        """The timed call once more under ``check.Capture``; the learner
        is closed and freed after it. Returns (judge, chunks, the last
        evaluation, steps of the call)."""
        judge = check.Judge(self.spec["config"], self.n, self.u, self.v,
                            self.seeds["split"], self.device)
        with check.Capture(learner_mod, window_mod, self.n) as cap:
            steps, _, ppx = self.call()
        self.sync()
        ev = judge.evaluation(ppx, self.learner.state)
        self.learner.close()
        del self.learner, self.call
        if self.cuda:
            torch.cuda.empty_cache()
        return judge, cap.chunks, ev, steps


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device: str) -> dict:
    """Set-up, window and check of one run; returns its record."""
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cell = Cell(spec, seed, device)
    call = cell.call
    rec = None
    trace_calls = int(spec["traffic"].get("trace_calls", 1))

    def stretch():
        out = [call() for _ in range(trace_calls)]
        return sum(o[0] for o in out), sum(o[1] for o in out)

    steps = evals = calls = 0
    cell.sync()
    w0 = time.perf_counter()
    while True:
        elapsed = time.perf_counter() - w0
        if elapsed >= seconds and (rec is not None or not trace):
            break
        if trace and rec is None and elapsed >= seconds / 2:
            r0 = time.perf_counter()
            (s, e), rec = tracing.traced(stretch, cell.sync, cell.cuda)
            # the stretch with the profiler's own work after it
            rec.update(steps=s, evals=e, total_s=time.perf_counter() - r0)
        else:
            s, e, _ = call()
        steps += s
        evals += e
        calls += 1
    cell.sync()
    window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated() if cell.cuda else 0
    print(f"[{spec['name']}] window {window_s:.3f} s: {steps} steps, "
          f"{evals} evaluations, {calls} calls", file=sys.stderr)
    del call
    c0 = time.perf_counter()
    judge, chunks, ev, s_call = cell.checked_call()
    values = check.readings(judge, chunks, ev, s_call)
    print(f"[{spec['name']}] check {time.perf_counter() - c0:.3f} s: "
          f"{s_call} steps in {len(chunks)} chunks followed",
          file=sys.stderr)
    limits = spec["limits"]
    # the counts take the lanes that the steps fill, not the buffers'
    # capacity: the mean of the checked call's masks
    shape = dataclasses.replace(cell.shape, **{
        lanes: float(torch.cat([getattr(c.draws, mask) for c in chunks])
                     .sum(-1, dtype=torch.float64).mean())
        for lanes, mask in (("B", "node_mask"), ("E", "edge_mask"))
    }) if chunks else cell.shape
    return {"setup": cell.setup, "steps": steps, "evals": evals,
            "window_s": window_s, "peak_bytes": peak, "trace": rec,
            "shape": shape,
            "checks": {k: [_plain(values[k]), _plain(limits.get(k))]
                       for k in values},
            "correct": check.verdict(values, limits)}


def _plain(x):
    """A number as JSON holds it: a non-finite one as its name."""
    if x is None:
        return "none"
    return x if math.isfinite(x) else str(x)


def result(spec: dict, record: dict, trace: bool, device_info: dict) -> dict:
    """The JSON line of the run."""
    metrics = {}
    chosen = spec["per_layer"] if trace else spec["end_to_end"]
    for m in chosen:
        value = reader(spec["root"], m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": bool(record["correct"]), "attempted": record["steps"],
            "failed": 0, "metrics": metrics, "device": device_info}
    if trace and record["trace"] is not None:
        line["breakdown"] = {"device_ops": record["trace"]["device_ops"],
                             "idle_gaps": record["trace"]["idle_gaps"]}
    line["checks"] = record["checks"]
    return line


def main(argv=None, *, require_cuda: bool = True, bench: dict = None,
         root: Path = HERE, device: str = "cuda") -> int:
    """The command. The keywords serve the tests: ``bench`` in place of
    ``BENCHMARK.json``, ``root`` in place of this folder for the traffic
    mixes and limits, and the device with the look for a card skipped."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if bench is None:
        bench = load_json(REPO / "BENCHMARK.json")
    spec = cell_spec(args.workload, bench, root)
    if require_cuda:
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark runs on an NVIDIA card",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < spec["chips"]:
            print(f"the cell needs {spec['chips']} cards, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2
    record = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                      device)
    found = forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3
    cuda = device == "cuda"
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": spec["chips"], "memory_peak_bytes": record["peak_bytes"]}
    if args.trace and record["trace"] is not None:
        info["busy_s"] = record["trace"]["busy_s"]
        info["window_s"] = record["trace"]["wall_s"]
    line = result(spec, record, bool(args.trace), info)
    print(f"[{spec['name']}] correct: {line['correct']}", file=sys.stderr)
    for name, (value, limit) in record["checks"].items():
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
