"""The port's ``data.py`` against the JAX package's: the same arrays,
exactly, from the same seeds (both are numpy ``RandomState`` code)."""

import dataclasses

import numpy as np
import pytest

from mcmc_ammsb_tpu import data as jax_data
from mcmc_ammsb_tpu_torch import data

from torch_parity import require_native


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("args", [(300, 8, 9), (5000, 7, 1), (50, 3, 0)])
def test_synthetic_edges(args):
    _same(data.synthetic_edges(*args), jax_data.synthetic_edges(*args))


@pytest.mark.parametrize("kw", [
    dict(num_nodes=300, num_communities=3, p_in=0.25, p_out=0.004, seed=31),
    dict(num_nodes=1000, num_communities=7, seed=2)])
def test_synthetic_sbm_edges(kw):
    _same(data.synthetic_sbm_edges(**kw), jax_data.synthetic_sbm_edges(**kw))


@pytest.mark.parametrize("kw", [
    dict(num_nodes=3000, avg_degree=6.6, max_degree=60, num_communities=8,
         seed=1),
    dict(num_nodes=2000, avg_degree=5.0, seed=4),
    dict(num_nodes=2000, avg_degree=9.5, max_degree=40, seed=5),
    dict(num_nodes=1500, avg_degree=4.0, num_communities=200, seed=6,
         exponent=2.2, intra_fraction=0.5)])
def test_synthetic_powerlaw_edges(kw):
    """With and without communities and max_degree (200 communities of
    ~7 nodes leave singletons, which keep the global draw)."""
    _same(data.synthetic_powerlaw_edges(**kw),
          jax_data.synthetic_powerlaw_edges(**kw))


@pytest.mark.parametrize("ratio,seed", [(0.1, 10), (0.01, 12345), (0.5, 3)])
def test_generate_sets_and_graph(ratio, seed):
    n, u, v = data.synthetic_edges(400, 10, seed=5)
    got = data.generate_sets(n, u, v, ratio, seed=seed)
    want = jax_data.generate_sets(n, u, v, ratio, seed=seed)
    names = [f.name for f in dataclasses.fields(want)]
    assert names == [f.name for f in dataclasses.fields(got)]
    _same([getattr(got, f) for f in names], [getattr(want, f) for f in names])
    g = data.Graph.from_edges(n, got.training_u, got.training_v)
    j = jax_data.Graph.from_edges(n, want.training_u, want.training_v)
    _same([g.edges_u, g.edges_v, g.offsets, g.cols, g.degrees],
          [j.edges_u, j.edges_v, j.offsets, j.cols, j.degrees])
    assert (g.num_nodes, g.num_edges, g.max_fan_out) == (
        j.num_nodes, j.num_edges, j.max_fan_out)
    assert g.has_edge(int(g.edges_u[0]), int(g.edges_v[0]))


SNAP = ("# Undirected graph: a test\n# Nodes: 7 Edges: 9\n"
        "# FromNodeId\tToNodeId\n# more\n"
        "10\t20\n20\t10\n30\t10\n5\t5\n40\t30\n20 30\n"
        "1000000\t5\n10\t20\n7\t40\n")


@pytest.mark.parametrize("route", ["never", "always", "auto"])
def test_load_snap_edges(route, tmp_path):
    """Comments, duplicates in both orders, a self-loop, tabs and a
    space, ids with gaps; the numpy and the native route."""
    if route == "always":
        require_native()
    path = tmp_path / "graph.txt"
    path.write_text(SNAP)
    got = data.load_snap_edges(str(path), shuffle_seed=3, use_native=route)
    want = jax_data.load_snap_edges(str(path), shuffle_seed=3,
                                    use_native=route)
    _same(got, want)
    assert got[0] == 7 and len(got[1]) == 6


def test_load_snap_edges_gzip(tmp_path):
    import gzip

    path = tmp_path / "graph.txt.gz"
    with gzip.open(path, "wt") as f:
        f.write(SNAP)
    _same(data.load_snap_edges(str(path)), jax_data.load_snap_edges(str(path)))
    with pytest.raises(RuntimeError, match="gzip"):
        data.load_snap_edges(str(path), use_native="always")
