"""The BASELINE.md config ladder on the port (counterpart of
``scripts/run_ladder.py``): one ppx[i] time series per rung, written to
``<out>/ppx_<rung>.json`` with the JAX script's fields, plus the device
(the card's name and power limit), each stage's seconds, the updates/s,
the peak device memory and what the K rule read.

With a SNAP file in ``--data`` a rung runs it; without one it runs the
power-law surrogate the JAX script runs (``data.synthetic_powerlaw_edges``
with ``seed=1``, split with ``heldout_ratio=0.01, seed=2``), so its N, E
and max fan-out are the JAX artifacts'.

    python -m mcmc_ammsb_tpu_torch.ladder [--rungs ca-HepPh com-dblp ...]
        [--iters 10000] [--interval 1000] [--data data]
        [--out bench_results/torch] [--device cuda]

The K rule. The JAX script runs com-lj at ``K_single_chip`` because its
reference K does not fit one 16 GB chip. The port applies the rule to the
device it runs on (``choose_k``): the reference K when pi at the rung's
dtype plus the working set (the graph structures the learner measured
on the device, the blocked init's, evaluation's and training chunk's
transients at that K, and a tenth of the device's memory for the rest)
fits the device's memory, else ``K_single_chip``.
An 80 GB H100 takes com-lj at K = 4096 in bf16 (pi 32.75 GB).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

from mcmc_ammsb_tpu_torch.config import Config, EdgeSetBackend
from mcmc_ammsb_tpu_torch.data import (DataSplit, Graph, generate_sets,
                                       load_snap_edges,
                                       synthetic_powerlaw_edges)
from mcmc_ammsb_tpu_torch.learner import (Learner, pi_block_rows,
                                          pi_storage_dtype)
from mcmc_ammsb_tpu_torch.ops.perplexity import EVAL_BLOCK_BYTES

# rung -> (dataset file stem, K,
#          degree-realistic fallback (nodes, avg_deg, max_deg),
#          extra Config overrides): scripts/run_ladder.py's table. The
# heavy-tailed rungs run with ds_link_cap=32 (Horvitz-Thompson hub
# subsampling) and window 12; com-lj's K_single_chip is the K of a device
# whose memory does not hold pi at the reference K (``choose_k``).
RUNGS = {
    "ca-HepPh": ("ca-HepPh.txt", 64, (12_008, 19.7, 491), {}),
    "com-dblp": ("com-dblp.ungraph.txt", 256, (317_080, 6.6, 343),
                 {"ds_link_cap": 32, "window": 12}),
    "com-youtube": ("com-youtube.ungraph.txt", 1024,
                    (1_134_890, 5.3, 28_754),
                    {"ds_link_cap": 32, "window": 12}),
    "com-lj": ("com-lj.ungraph.txt", 4096, (3_997_962, 17.3, 14_815),
               {"ds_link_cap": 32, "window": 12,
                "pi_dtype": "bfloat16", "K_single_chip": 1024}),
}

#: where the JAX script writes its artifacts: never written here
JAX_OUT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bench_results")


@dataclasses.dataclass
class RungData:
    """One rung's graph on the host, with the seconds of each stage."""

    source: str
    synthetic: bool
    num_nodes: int
    split: DataSplit
    graph: Graph
    seconds: dict        # data, split, graph


def rung_data(name: str, data_dir: str) -> RungData:
    """The rung's SNAP file from ``data_dir`` when it is there, else its
    power-law surrogate; the held-out split and the training CSR."""
    stem, k, (syn_n, syn_deg, syn_max), extra = RUNGS[name]
    k_used = extra.get("K_single_chip", k)
    path = os.path.join(data_dir, stem)
    t0 = time.perf_counter()
    if os.path.exists(path):
        n, u, v = load_snap_edges(path)
        source = path
    else:
        # the JAX script's community count: min of ITS K (K_single_chip
        # at com-lj) and 256 — 256 at every K >= 256, so the same graph
        n, u, v = synthetic_powerlaw_edges(
            syn_n, syn_deg, exponent=2.7, max_degree=syn_max,
            num_communities=min(k_used, 256), intra_fraction=0.85, seed=1)
        source = f"powerlaw({syn_n},{syn_deg},max={syn_max})"
    t1 = time.perf_counter()
    split = generate_sets(n, u, v, heldout_ratio=0.01, seed=2)
    t2 = time.perf_counter()
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    t3 = time.perf_counter()
    return RungData(source, source != path, n, split, graph,
                    {"data": t1 - t0, "split": t2 - t1, "graph": t3 - t2})


def rung_config(name: str, k: int, n: int, e: int,
                max_fan_out: int) -> Config:
    """The JAX script's Config for the rung at ``k``: m = n = 32,
    1000-step calls, device sampling, shared neighbor draws, the AUTO edge
    set and the rung's extras; finalized on the graph."""
    extra = {f: x for f, x in RUNGS[name][3].items() if f != "K_single_chip"}
    cfg = Config(K=k, mini_batch_size=32, num_node_sample=32,
                 steps_per_call=1000, device_sampling=True,
                 shared_neighbors=True,
                 edgeset_backend=EdgeSetBackend.AUTO, **extra)
    return cfg.finalize(n, e, max_fan_out)


def pi_bytes(cfg: Config) -> int:
    """pi [N, K] at its storage dtype."""
    return cfg.N * cfg.K * pi_storage_dtype(cfg).itemsize


def transient_bytes(cfg: Config) -> int:
    """The learner's largest transients at ``cfg``'s K: the blocked
    evaluation (six blocks of ``EVAL_BLOCK_BYTES``: the two gathers, their
    upcasts, the product and one term), the blocked init (four float32
    blocks of ``pi_block_rows``) or a training chunk (its phi noise [S, B,
    K] float32 and one copy), whichever is largest."""
    init = 4 * pi_block_rows(cfg.K) * cfg.K * 4
    chunk = 2 * cfg.steps_per_call * cfg.max_batch_nodes * cfg.K * 4
    return max(6 * EVAL_BLOCK_BYTES, init, chunk)


#: the working set's allowance for what ``transient_bytes`` does not
#: count (the device sampler's chunk, the caching allocator's slack): a
#: tenth of the device's memory
SLACK_DIVISOR = 10


def choose_k(name: str, pi_ref_bytes: int, total_bytes: int,
             working_bytes: int) -> int:
    """The rung's K on a device of ``total_bytes``: the reference K when
    pi at the reference K (``pi_ref_bytes``) plus ``working_bytes`` (the
    graph structures, ``transient_bytes`` and the slack) fits, else the
    rung's ``K_single_chip`` (the reference K where it has none)."""
    _, k, _, extra = RUNGS[name]
    if pi_ref_bytes + working_bytes <= total_bytes:
        return k
    return extra.get("K_single_chip", k)


def device_memory_bytes(device: torch.device) -> int:
    """The memory of the device: the card's total, or the host's."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[1]
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def device_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    return subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


class RungLearner(Learner):
    """The ``Learner`` of one rung. It picks the rung's K once its graph
    structures are on the device (``choose_k`` on the bytes of their
    tensors, the transients at the reference K and a tenth of the
    device's memory, ``SLACK_DIVISOR``), and keeps the seconds
    of its stages: ``edge_sets`` (the membership sets, the held-out
    population and the CSR on the device), ``init`` and ``evaluations``
    (each held-out evaluation, waited for)."""

    def __init__(self, name: str, cfg: Config, graph: Graph,
                 split: DataSplit, device):
        self.rung = name
        self.seconds = {"evaluations": 0.0}
        super().__init__(cfg, graph, split, device)

    def _build_graph_structures(self, graph, split) -> None:
        t0 = time.perf_counter()
        super()._build_graph_structures(graph, split)
        self._sync()
        self.seconds["edge_sets"] = time.perf_counter() - t0

    def structure_bytes(self) -> int:
        """Bytes of the graph structures' tensors on the device."""
        tensors = [*self.training_set.arrays, *self.heldout_set.arrays,
                   self.heldout_u, self.heldout_v, self.adjacency.offsets,
                   self.adjacency.cols]
        return sum(t.numel() * t.element_size() for t in tensors)

    def _init_state(self, heldout_size: int):
        cfg = self.cfg
        ref = rung_config(self.rung, RUNGS[self.rung][1], cfg.N, cfg.E,
                          cfg.max_fan_out)
        total = device_memory_bytes(self.device)
        self.k_rule = {"device_memory_bytes": total,
                       "structure_bytes": self.structure_bytes(),
                       "transient_bytes": transient_bytes(ref),
                       "slack_bytes": total // SLACK_DIVISOR,
                       "pi_reference_bytes": pi_bytes(ref)}
        self.k_rule["working_bytes"] = (self.k_rule["structure_bytes"]
                                        + self.k_rule["transient_bytes"]
                                        + self.k_rule["slack_bytes"])
        k = choose_k(self.rung, pi_bytes(ref), total,
                     self.k_rule["working_bytes"])
        self.cfg = rung_config(self.rung, k, cfg.N, cfg.E, cfg.max_fan_out)
        t0 = time.perf_counter()
        state = super()._init_state(heldout_size)
        self._sync()
        self.seconds["init"] = time.perf_counter() - t0
        return state

    def _evaluate(self, state):
        self._sync()
        t0 = time.perf_counter()
        out = super()._evaluate(state)
        self._sync()
        self.seconds["evaluations"] += time.perf_counter() - t0
        return out


def run_rung(name: str, data_dir: str, out_dir: str, iters: int,
             interval: int, device="cuda", data: RungData = None) -> dict:
    """Run one rung and write ``<out_dir>/ppx_<name>.json``: ppx[0], then
    ``run_with_ppx(iters, interval)`` in one call, as the JAX script does.
    ``data`` is the rung's ``rung_data``, built here when not given.
    Returns the artifact."""
    if os.path.realpath(out_dir) == os.path.realpath(JAX_OUT):
        raise ValueError(f"{out_dir} holds the JAX package's artifacts; "
                         "write the port's elsewhere")
    device = torch.device(device)
    data = data or rung_data(name, data_dir)
    graph, split = data.graph, data.split
    k_ref = RUNGS[name][1]
    cfg = rung_config(name, k_ref, data.num_nodes, split.total_edges,
                      graph.max_fan_out)
    base = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    learner = RungLearner(name, cfg, graph, split, device)
    cfg = learner.cfg
    print(f"[{name}] {data.source}: N={cfg.N} E={cfg.E} K={cfg.K} "
          f"pi {cfg.pi_dtype}", file=sys.stderr)
    t0 = time.time()
    start = int(learner.state.step_count)
    series = [{"iter": 0, "ppx": learner.heldout_perplexity(),
               "seconds": time.time() - t0}]
    print(f"[{name}] ppx[0] = {series[0]['ppx']:.4f}", file=sys.stderr)
    base_t = time.perf_counter()
    wall0 = time.time() - t0
    evals0 = learner.seconds["evaluations"]
    for ev in learner.run_with_ppx(iters, min(interval, iters)):
        series.append({"iter": ev["step"] - start, "ppx": ev["ppx"],
                       "seconds": wall0 + ev["t"] - base_t})
        print(f"[{name}] ppx[{series[-1]['iter']}] = "
              f"{series[-1]['ppx']:.4f} ({series[-1]['seconds']:.1f}s)",
              file=sys.stderr)
    run_s = time.perf_counter() - base_t
    learner.close()
    training = run_s - (learner.seconds["evaluations"] - evals0)
    seconds = {**data.seconds, "edge_sets": learner.seconds["edge_sets"],
               "init": learner.seconds["init"], "training": training,
               "evaluations": learner.seconds["evaluations"]}
    artifact = {
        "rung": name, "source": data.source, "synthetic": data.synthetic,
        "N": cfg.N, "E": cfg.E, "K": cfg.K,
        "m": cfg.mini_batch_size, "n": cfg.num_node_sample,
        "max_fan_out": cfg.max_fan_out,
        "ds_link_cap": cfg.ds_link_cap, "window": cfg.window,
        "pi_dtype": cfg.pi_dtype,
        "iters": iters, "ppx_interval": interval,
        "series": series,
        "device": device_name(device),
        "seconds": seconds,
        "updates_per_s": iters / training,
        "pi_bytes": pi_bytes(cfg),
        # the rung's own peak: above what the process held before it
        "base_memory_bytes": base,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device) - base
                              if device.type == "cuda" else None),
        "k_rule": learner.k_rule,
    }
    if "K_single_chip" in RUNGS[name][3]:
        rule = learner.k_rule
        gb = {f: rule[f] / 1e9 for f in rule}
        pi_ref = (f"pi [{cfg.N},{k_ref}] {cfg.pi_dtype} = "
                  f"{gb['pi_reference_bytes']:.2f} GB")
        artifact["K_reference"] = k_ref
        artifact["K_note"] = (
            f"the reference K fits this device: {pi_ref} beside a working "
            f"set of {gb['working_bytes']:.2f} GB, of "
            f"{gb['device_memory_bytes']:.2f} GB"
            if cfg.K == k_ref else
            f"the reference K does not fit this device ({pi_ref}); the "
            f"rung runs K_single_chip")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"ppx_{name}.json")
    with open(out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(f"[{name}] wrote {out}", file=sys.stderr)
    return artifact


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", default="data")
    ap.add_argument("--out", default=os.path.join("bench_results", "torch"))
    ap.add_argument("--rungs", nargs="*", choices=list(RUNGS),
                    default=list(RUNGS))
    ap.add_argument("--iters", type=int, default=10_000)
    ap.add_argument("--interval", type=int, default=1_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for name in args.rungs:
        run_rung(name, args.data, args.out, args.iters, args.interval,
                 args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
