"""The port's bench (mcmc_ammsb_tpu_torch/bench.py) against the JAX
package's root bench.py, on the CPU:

  * its JSON line has bench.py's keys (read from bench.py's AST), but the
    roofline's two TPU constants, which are measured now, and the device;
  * each phase's finalized Config is the JAX bench's, field by field (the
    JAX bench run with its learners stubbed to record what they are given);
  * its three graphs are the JAX bench's at full size: N, E, max fan-out
    and digests of the split and CSR arrays;
  * a whole run at a tiny size runs every phase and prints one line with
    every rate positive; a phase that raises makes ``main`` raise, prints
    no line and leaves no process group behind; asking for the card where
    there is none fails.
"""

import ast
import contextlib
import dataclasses
import enum
import hashlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mcmc_ammsb_tpu_torch import bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BENCH = os.path.join(ROOT, "bench.py")

#: a whole run in ~15 s on a CPU: N of a few thousand, K = 16, a few
#: hundred steps, 2 trials (the SBM graph at its size: it must learn)
TINY = bench.Sizes(
    bench_nodes=3000, powerlaw_nodes=3000, sbm_nodes=20_000, K=16,
    sbm_K=32, steps_per_call=100, alternate_steps_per_call=96,
    bitexact_steps_per_call=50, chain_steps_per_call=48,
    sbm_steps_per_call=50, iters=200, trials=2, bitexact_iters=100,
    short_trials=2, chain_iters=96, series_iters=600, eval_interval=50,
    probe_steps=100, probe_warm_steps=50, sbm_steps=600,
    copy_bytes=1 << 22, row_reps=20)

PHASES = ["windowed-shared-neighbors", "reference-semantics",
          "bit-exact-rng", "device-bflink", "stratified-coin", "chains-c16",
          "sharded-1x1", "power-law", "autotune", "sbm", "roofline"]

#: the keys the port renames or adds, by the dict that holds them
RENAMED = {"roofline": ({"hbm_bw_gbps_assumed", "random_row_floor_ns_per_row"},
                        {"hbm_bw_gbps_measured",
                         "random_row_gather_ns_per_row_measured",
                         "random_row_scatter_ns_per_row_measured"}),
           "extra": (set(), {"device"})}


# ---------------------------------------------------------------------------
# The JAX bench's keys, read from its source
# ---------------------------------------------------------------------------

def jax_bench_keys() -> dict:
    """The key tree of the line bench.py's ``main`` prints: {key: None for
    a leaf, or the key tree of a dict literal (also one assigned to a
    name in ``main``, and ``**name`` entries expanded)}."""
    with open(JAX_BENCH) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    named = {}
    for node in sorted((n for n in ast.walk(main)
                        if isinstance(n, ast.Assign)
                        and isinstance(n.value, ast.Dict)),
                       key=lambda n: n.lineno):
        for t in node.targets:
            if isinstance(t, ast.Name):
                named[t.id] = node.value          # the last assignment
    dumps = next(n for n in ast.walk(main) if isinstance(n, ast.Call)
                 and isinstance(n.func, ast.Attribute)
                 and n.func.attr == "dumps")

    def keys(d: ast.Dict) -> dict:
        out = {}
        for k, v in zip(d.keys, d.values):
            if k is None:                         # **name
                out.update(keys(named[v.id]))
                continue
            if isinstance(v, ast.Name) and v.id in named:
                v = named[v.id]
            out[k.value] = keys(v) if isinstance(v, ast.Dict) else None
        return out

    return keys(dumps.args[0])


def _key_tree(d) -> dict:
    return {k: _key_tree(v) if isinstance(v, dict) else None
            for k, v in d.items()}


def _compare_keys(mine: dict, theirs: dict, renamed: dict,
                  where: str = "") -> None:
    """``mine``'s key tree is ``theirs`` down to its leaves, with the
    ``renamed`` keys of each dict (by its key) taken out and put in."""
    gone, new = renamed.get(where, (set(), set()))
    assert set(mine) == (set(theirs) - gone) | new, where
    for k, sub in theirs.items():
        if sub is not None:
            _compare_keys(mine[k], sub, renamed, k)


# ---------------------------------------------------------------------------
# The JAX bench's configs and graphs, its learners stubbed
# ---------------------------------------------------------------------------

class _Stub:
    """What the JAX bench calls on a learner, recording what it was
    given; its perplexity falls so every phase completes."""

    made = []

    def __init__(self, cfg, graph, split, *args, **kw):
        self.made.append((type(self).__name__, cfg, graph, split))
        self.cfg = cfg
        self.state = types.SimpleNamespace(step_count=1)
        self.ppx = 10.0

    def run(self, n):
        self.state.step_count += n

    def heldout_perplexity(self):
        self.ppx -= 1.0
        return self.ppx

    def run_with_ppx(self, n, interval):
        out = []
        for i in range(n // interval):
            self.state.step_count += interval
            out.append({"t": time.perf_counter(), "ppx": 5.0 - 0.01 * i,
                        "step": self.state.step_count})
        return out

    def close(self):
        pass


class Learner(_Stub):
    pass


class FlatChainLearner(_Stub):
    pass


class ShardedLearner(_Stub):
    pass


@pytest.fixture(scope="module")
def jax_bench():
    """({phase label: (Config, graph, split)}, the line it printed) of
    the JAX bench's main, run with its learners, the autotuner and
    ``init_state`` stubbed."""
    from mcmc_ammsb_tpu import autotune as jautotune
    from mcmc_ammsb_tpu import chains_flat as jchains
    from mcmc_ammsb_tpu import learner as jlearner
    from mcmc_ammsb_tpu import parallel as jparallel

    spec = importlib.util.spec_from_file_location("jax_bench", JAX_BENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _Stub.made = []
    tuned = []

    def tune_window(cfg, make, **kw):
        tuned.append(cfg)
        return cfg, {w: 1.0 for w in (0, 6, 8, 12, 16)}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlearner, "Learner", Learner)
        mp.setattr(jlearner, "init_state", lambda cfg, size:
                   types.SimpleNamespace(step_count=1))
        mp.setattr(jchains, "FlatChainLearner", FlatChainLearner)
        mp.setattr(jparallel, "ShardedLearner", ShardedLearner)
        mp.setattr(jparallel, "make_mesh", lambda *a: None)
        mp.setattr(jautotune, "tune_window", tune_window)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            mod.main()
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    made = {}
    labels = ["windowed-shared-neighbors", "reference-semantics",
              "bit-exact-rng", "device-bflink", "stratified-coin",
              "chains-c16", "sharded-1x1", "powerlaw-exact",
              "powerlaw-capped", "sbm"]
    assert len(_Stub.made) == len(labels)
    for label, (kind, cfg, graph, split) in zip(labels, _Stub.made):
        made[label] = (cfg, graph, split)
    assert [k for k, *_ in _Stub.made][5:7] == ["FlatChainLearner",
                                                "ShardedLearner"]
    made["autotune"] = (tuned[0],) + made["windowed-shared-neighbors"][1:]
    return made, line


@pytest.fixture(scope="module")
def port_configs():
    """{phase label: (Config, split, graph)} of the port's bench at its
    default sizes (the JAX bench's)."""
    s = bench.Sizes()
    graphs = {"bench": bench.bench_graph(s),
              "powerlaw": bench.powerlaw_graph(s),
              "sbm": bench.sbm_graph(s)}

    def fin(cfg, key):
        n, split, graph = graphs[key]
        return cfg.finalize(n, split.total_edges, graph.max_fan_out), key

    head, _ = fin(bench.headline_config(s), "bench")
    exact, _ = fin(bench.powerlaw_config(s), "powerlaw")
    configs = {
        "windowed-shared-neighbors": (head, "bench"),
        "reference-semantics": (bench.reference_config(head), "bench"),
        "bit-exact-rng": (bench.bitexact_config(head, s), "bench"),
        "device-bflink": (bench.bflink_config(head), "bench"),
        "stratified-coin": (bench.alternate_config(head, s), "bench"),
        "chains-c16": (bench.chains_config(head, s), "bench"),
        "sharded-1x1": (head, "bench"),
        "powerlaw-exact": (exact, "powerlaw"),
        "powerlaw-capped": (bench.capped_config(exact), "powerlaw"),
        "autotune": (head.replace(steps_per_call=s.steps_per_call), "bench"),
        "sbm": fin(bench.sbm_config(s), "sbm"),
    }
    return {label: (cfg, *graphs[key][1:])
            for label, (cfg, key) in configs.items()}


def _plain(x):
    return x.value if isinstance(x, enum.Enum) else x


CONFIG_LABELS = ["windowed-shared-neighbors", "reference-semantics",
                 "bit-exact-rng", "device-bflink", "stratified-coin",
                 "chains-c16", "sharded-1x1", "powerlaw-exact",
                 "powerlaw-capped", "autotune", "sbm"]


@pytest.mark.parametrize("label", CONFIG_LABELS)
def test_phase_config_is_the_jax_benchs(label, jax_bench, port_configs):
    """Every field both Configs have, equal (enums by value)."""
    theirs = jax_bench[0][label][0]
    mine = port_configs[label][0]
    shared = ({f.name for f in dataclasses.fields(mine)}
              & {f.name for f in dataclasses.fields(theirs)})
    assert len(shared) > 40
    for f in sorted(shared):
        assert _plain(getattr(mine, f)) == _plain(getattr(theirs, f)), f


def _digest(a) -> str:
    a = np.ascontiguousarray(np.asarray(a, dtype=np.int64))
    return hashlib.sha256(a.tobytes()).hexdigest()


#: N, E (total edges) and max fan-out of the bench's three graphs
GRAPHS = {"windowed-shared-neighbors": (317_079, 1_109_780, 23),
          "powerlaw-exact": (310_310, 1_021_641, 330),
          "sbm": (19_999, 101_514, 25)}


@pytest.mark.parametrize("label", list(GRAPHS))
def test_graph_is_the_jax_benchs(label, jax_bench, port_configs):
    """N, E, max fan-out as listed; the split's arrays and the CSR's
    digests equal the JAX package's."""
    cfg_j, graph_j, split_j = jax_bench[0][label]
    cfg, split, graph = port_configs[label]
    assert (cfg.N, cfg.E, cfg.max_fan_out) == GRAPHS[label]
    assert (cfg_j.N, cfg_j.E, cfg_j.max_fan_out) == GRAPHS[label]
    for f in ("training_u", "training_v", "heldout_u", "heldout_v",
              "heldout_edges_u", "heldout_edges_v"):
        assert _digest(getattr(split, f)) == _digest(getattr(split_j, f)), f
    assert split.total_edges == split_j.total_edges
    for f in ("edges_u", "edges_v", "offsets", "cols"):
        assert _digest(getattr(graph, f)) == _digest(getattr(graph_j, f)), f


# ---------------------------------------------------------------------------
# A whole run at a tiny size
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_run():
    """main(device="cpu", sizes=TINY): (what it printed on standard
    output, what it returned, the phases entered in order)."""
    entered = []

    @contextlib.contextmanager
    def phase(label):
        entered.append(label)
        yield

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        line = bench.main(device="cpu", sizes=TINY, phase=phase)
    return out.getvalue(), line, entered


def test_whole_run_prints_one_line(tiny_run):
    """Every phase, in the JAX bench's order; one JSON line, the one
    returned; every rate positive; the trials counted (the best one
    rounded twice: to 0.01 in ``value``, to 0.1 in the spread); the
    graphs' sizes those of the tiny graphs; the SBM perplexity fell."""
    printed, line, entered = tiny_run
    assert entered == PHASES
    lines = printed.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == line
    x = line["extra"]
    rates = [line["value"]] + [x[k] for k in x if k.endswith("_rate")] + [
        x["powerlaw_updates_per_sec"], x["powerlaw_capped_updates_per_sec"],
        x["powerlaw_capped_eval_inclusive_updates_per_sec"]] + list(
        x["autotune_table"]["rates_by_window"].values())
    assert len(rates) == 15
    assert all(isinstance(r, float) and r > 0 for r in rates), rates
    assert x["headline_trials"]["trials"] == TINY.trials
    assert x["headline_trials"]["max"] == pytest.approx(line["value"],
                                                        abs=0.06)
    assert x["sharded_overhead_ratio"] > 0
    assert x["N"] == 3000 and x["K"] == 16 and x["window"] == 12
    assert x["sbm_ppx_end"] < x["sbm_ppx_start"]
    assert 0 < x["steps_to_ppx_target"] <= TINY.series_iters
    assert x["device"] == {"name": "cpu", "power_limit": None}
    assert "on the CPU" in line["metric"] and line["vs_baseline"] is None


def test_keys_are_the_jax_benchs(tiny_run, jax_bench):
    """The key tree of the port's line is bench.py's (from its AST), with
    the roofline's measured keys for its two constants and the device;
    the stubbed JAX bench's own line has the AST's keys."""
    theirs = jax_bench_keys()
    assert {"metric", "value", "extra"} <= set(theirs)
    assert {"roofline", "powerlaw_N", "sbm_ppx_end"} <= set(theirs["extra"])
    _compare_keys(_key_tree(tiny_run[1]), theirs, RENAMED)
    _compare_keys(_key_tree(jax_bench[1]), theirs, {})


def test_roofline_is_measured(tiny_run):
    """The roofline's ratios follow from its measured numbers and the
    headline's rate, and no TPU constant is left in the module."""
    line = tiny_run[1]
    r = line["extra"]["roofline"]
    assert r["rows_touched_per_update"] == 2 * 33 + 32
    assert r["hbm_bw_gbps_measured"] > 0
    assert r["random_row_gather_ns_per_row_measured"] > 0
    assert r["random_row_scatter_ns_per_row_measured"] > 0
    ns = 1e9 / (line["value"] * r["rows_touched_per_update"])
    assert r["achieved_ns_per_row"] == pytest.approx(ns, rel=1e-4, abs=0.06)
    with open(bench.__file__) as f:
        src = f.read()
    assert "819" not in src and "20 ns" not in src and "20.0" not in src


@pytest.mark.parametrize("where", ["chains", "sharded"])
def test_failing_phase_raises(where, monkeypatch):
    """A learner whose run raises ends main with the error: no line is
    printed, and the sharded phase's process group is gone."""
    from mcmc_ammsb_tpu_torch.parallel import sharded

    cls = (bench.FlatChainLearner if where == "chains"
           else sharded.ShardedLearner)

    def run(self, n):
        raise RuntimeError(f"{where} failed")

    monkeypatch.setattr(cls, "run", run)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(
            RuntimeError, match=f"{where} failed"):
        bench.main(device="cpu", sizes=TINY)
    assert out.getvalue() == ""
    assert not dist.is_initialized()


def test_no_card_fails_without_a_line():
    """The command line asks for the card by default; without one it
    exits non-zero before any phase and prints nothing on standard
    output."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run the bench")
    proc = subprocess.run([sys.executable, "-m", "mcmc_ammsb_tpu_torch.bench"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr
