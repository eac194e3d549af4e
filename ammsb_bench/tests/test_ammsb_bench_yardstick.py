"""The yardstick's parts: the frozen generator, the seeds, the reference
split, and the byte and operation counts."""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

from ammsb_bench import counts, graphs, reference

HERE = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("seed", [1, 7])
def test_frozen_generator_is_the_programs(seed):
    from mcmc_ammsb_tpu_torch.data import synthetic_powerlaw_edges

    want = synthetic_powerlaw_edges(4000, 6.6, exponent=2.7, max_degree=90,
                                    num_communities=16, intra_fraction=0.85,
                                    seed=seed)
    got = graphs.powerlaw_edges(4000, 6.6, 2.7, 90, 16, 0.85, seed)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_graph_cache(tmp_path):
    graph = {"nodes": 500, "avg_degree": 5.0, "exponent": 2.7,
             "max_degree": 40, "communities": 4, "intra_fraction": 0.85,
             "seed": 3}
    n, u, v, hit = graphs.load_graph(graph, tmp_path)
    assert not hit
    n2, u2, v2, hit2 = graphs.load_graph(graph, tmp_path)
    assert hit2 and n2 == n
    np.testing.assert_array_equal(u, u2)
    np.testing.assert_array_equal(v, v2)


def test_run_seeds_use_every_bit():
    a, b = graphs.run_seeds(5), graphs.run_seeds(5 + (1 << 31))
    assert a != b and a == graphs.run_seeds(5)
    big = graphs.run_seeds(2 ** 31 + 12345)
    assert all(0 <= x < 2 ** 31 for x in big["phi"] + big["beta"])
    assert 0 <= big["split"] < 2 ** 32 and big["init"] < 2 ** 63


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 3])
def test_reference_split_is_the_programs(seed):
    from mcmc_ammsb_tpu_torch.data import generate_sets

    n, u, v = graphs.powerlaw_edges(3000, 6.0, 2.7, 60, 8, 0.85, 2)
    u, v = graphs.ordered_edges(u, v, graphs.run_seeds(seed)["order"])
    split_seed = graphs.run_seeds(seed)["split"]
    want = generate_sets(n, u, v, 0.01, seed=split_seed)
    got = reference.split(n, u, v, 0.01, split_seed)
    for a, b in ((got.train_u, want.training_u), (got.held_u, want.heldout_u),
                 (got.pop_u, want.heldout_edges_u),
                 (got.pop_v, want.heldout_edges_v)):
        np.testing.assert_array_equal(a, b)
    assert got.total_edges == want.total_edges


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "graphs.py", "counts.py"):
        tree = ast.parse((HERE / name).read_text())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module] if isinstance(node, ast.ImportFrom) else [])
            for mod in mods:
                assert mod.split(".")[0] not in (
                    "mcmc_ammsb_tpu", "mcmc_ammsb_tpu_torch", "jax"), (name,
                                                                     mod)


SMALL = counts.Shape(T=2, B=3, E=2, n=2, K=4, pi_bytes=2, H=10, interval=5)
CELL = counts.Shape(T=12, B=33, E=32, n=32, K=16384, pi_bytes=4, H=10484,
                    interval=1000)


def test_counts_by_hand():
    # SMALL: rows 16 x 4 x 2 B, sums 12 x 4 B, y_phi 12, ids and masks 30,
    # neighbors 16, phi noise 96, theta noise 64, edge operands 40,
    # correction codes 40, keep 6, weights 8, theta and beta 96
    assert counts.window_bytes(SMALL) == 584
    # per step 4 B n K + 15 B K + 8 B n + 14 E K + 20 K = 96 + 180 + 48
    # + 112 + 80
    assert counts.step_flops(SMALL) == 516
    assert counts.eval_bytes(SMALL) == 320
    assert counts.step_bytes(SMALL) == 112 + 320 / 5
    assert counts.window_bytes(CELL) == 105_015_432
    assert counts.step_flops(CELL) == 84_992_256
    # lanes filled on average, B = 1.5 and E = 1: rows 56 + 12 read and
    # 24 + 12 written, operands 6 + 15 + 16 + 48 + 64 + 20 + 28 + 3 + 8,
    # theta and beta 96; operations 48 + 90 + 24 + 56 + 80
    filled = dataclasses.replace(SMALL, B=1.5, E=1)
    assert counts.window_bytes(filled) == 408
    assert counts.step_flops(filled) == 298


def test_least_time_takes_the_larger_bound():
    assert counts.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert counts.least_seconds(0, 67e12) == pytest.approx(1.0)
    t = counts.window_least_seconds(CELL)
    assert t == pytest.approx(105_015_432 / 3.35e12)


def test_tf32_rounding():
    import torch

    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.5 - 2 ** -12,
                      3.0e-5])
    y = reference.to_tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0          # a tie goes to even
    assert y[2] == 1.0 + 2 * 2 ** -10           # ties to even, upward
    assert y[3] == -1.5                         # under half a step
    assert abs(float(y[4]) - 3.0e-5) <= 3.0e-5 * 2 ** -11
