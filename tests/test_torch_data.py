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


# ---------------------------------------------------------------------------
# The dataset cache and the training-perplexity population
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cached_graph():
    return data.synthetic_edges(300, 8, seed=9)


@pytest.mark.parametrize("fmt", ["npz", "ref"])
def test_dump_then_load_round_trips(cached_graph, tmp_path, fmt):
    """dump_dataset then load_dataset: N and the edge arrays come back
    equal with their dtypes, the held-out ratio as the format stores it
    (float64 in the npz cache, float32 in the reference's layout);
    load_dataset detects the format."""
    n, u, v = cached_graph
    path = str(tmp_path / ("g.npz" if fmt == "npz" else "g.gz"))
    data.dump_dataset(path, n, 0.01, u, v, fmt=fmt)
    n2, ratio, u2, v2 = data.load_dataset(path)
    assert n2 == n
    assert ratio == (0.01 if fmt == "npz" else float(np.float32(0.01)))
    _same((u2, v2), (u, v))


@pytest.mark.parametrize("fmt", ["npz", "ref"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cache_of_one_package_loads_in_the_other(cached_graph, tmp_path, fmt,
                                                 writer):
    n, u, v = cached_graph
    path = str(tmp_path / ("g.npz" if fmt == "npz" else "g.gz"))
    dump, load = ((data.dump_dataset, jax_data.load_dataset)
                  if writer == "port" else
                  (jax_data.dump_dataset, data.load_dataset))
    dump(path, n, 0.05, u, v, fmt=fmt)
    n2, ratio, u2, v2 = load(path)
    same = (jax_data if writer == "port" else data).load_dataset(path)
    assert (n2, ratio) == (n, same[1])
    _same((u2, v2), (u, v))
    _same(same[2:], (u, v))


def test_ref_cache_streams_are_byte_equal(cached_graph, tmp_path):
    """The reference's layout, byte for byte: the decompressed streams of
    both packages' dumps are equal (a gzip header carries a time stamp,
    so the files themselves differ in bytes 4-8), and hold uint64 N,
    float32 ratio, uint64 count and the packed edges."""
    import gzip

    n, u, v = cached_graph
    paths = [str(tmp_path / name) for name in ("port.gz", "jax.gz")]
    data.dump_dataset(paths[0], n, 0.01, u, v, fmt="ref")
    jax_data.dump_dataset(paths[1], n, 0.01, u, v, fmt="ref")
    streams = []
    for p in paths:
        with gzip.open(p, "rb") as f:
            streams.append(f.read())
    assert streams[0] == streams[1]
    assert len(streams[0]) == 20 + 8 * len(u)
    assert int(np.frombuffer(streams[0][:8], "<u8")[0]) == n
    assert int(np.frombuffer(streams[0][12:20], "<u8")[0]) == len(u)
    with pytest.raises(ValueError, match="unknown dataset cache format"):
        data.dump_dataset(paths[0], n, 0.01, u, v, fmt="hdf5")
    with open(paths[0], "wb") as f:
        f.write(gzip.compress(streams[0][:-8]))
    with pytest.raises(IOError, match="header says"):
        data.load_dataset(paths[0])


@pytest.mark.parametrize("ratio", [0.01, 0.1])
def test_make_training_ppx_edges(cached_graph, ratio):
    """Array-equal to the JAX package's (np.random.RandomState(777)): the
    first ratio * |training| training edges, then the sampled non-edges."""
    n, u, v = cached_graph
    split = data.generate_sets(n, u, v, heldout_ratio=0.1, seed=10)
    jsplit = jax_data.DataSplit(**dataclasses.asdict(split))
    got = data.make_training_ppx_edges(split, ratio)
    _same(got, jax_data.make_training_ppx_edges(jsplit, ratio))
    links = int(ratio * len(split.training_u))
    assert links > 0 and len(got[0]) > links
    np.testing.assert_array_equal(got[0][:links], split.training_u[:links])
