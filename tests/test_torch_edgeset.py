"""The port's membership backends against the JAX package's: the host
tables byte for byte (built in numpy and natively), ``has_edges`` exactly
on every kind of query the training loop makes, the 32- and 64-bit
wraparound of the hashes against Python integers, and the invariants of
tests/test_edgeset.py for the port's class."""

import numpy as np
import pytest
import torch

from mcmc_ammsb_tpu import native as jax_native
from mcmc_ammsb_tpu.config import EdgeSetBackend as JaxBackend
from mcmc_ammsb_tpu.ops import edgeset as jax_edgeset
from mcmc_ammsb_tpu_torch.config import EdgeSetBackend
from mcmc_ammsb_tpu_torch.data import (synthetic_edges,
                                       synthetic_powerlaw_edges)
from mcmc_ammsb_tpu_torch.interop import edge_set_from_numpy
from mcmc_ammsb_tpu_torch.ops import edgeset
from mcmc_ammsb_tpu_torch.types import pack_edges

from torch_parity import require_native

GRAPHS = {
    "uniform300": lambda: synthetic_edges(300, 8, seed=3),
    "powerlaw300": lambda: synthetic_powerlaw_edges(
        300, 6.0, max_degree=40, num_communities=4, seed=5),
    "uniform5000": lambda: synthetic_edges(5000, 7, seed=1),
    "powerlaw5000": lambda: synthetic_powerlaw_edges(
        5000, 6.6, max_degree=120, num_communities=8, seed=2),
}
ALL = ["adjacency", "perfect", "csr", "sorted", "cuckoo"]


@pytest.fixture(scope="module", params=list(GRAPHS))
def graph(request):
    return (request.param, *GRAPHS[request.param]())


def _jax_tables(backend, n, u, v, use_native, monkeypatch):
    """The JAX package's EdgeSet as numpy, built by its native or its
    numpy route."""
    if not use_native:
        monkeypatch.setattr(jax_native, "available", lambda: False)
    es = jax_edgeset.build_edge_set(JaxBackend(backend), n, u, v)
    return es, tuple(np.asarray(a) for a in es.arrays)


@pytest.mark.parametrize("backend,route", [
    ("csr", "numpy"), ("sorted", "numpy"), ("perfect", "numpy"),
    ("perfect", "native"), ("cuckoo", "numpy"), ("cuckoo", "native")])
def test_host_tables_equal_jax(graph, backend, route, monkeypatch):
    """Byte-equal tables, meta and search depth, route by route."""
    if route == "native":
        require_native()
    _, n, u, v = graph
    jes, jarrays = _jax_tables(backend, n, u, v, route == "native",
                               monkeypatch)
    name, steps, meta, arrays = edgeset.build_host_tables(
        EdgeSetBackend(backend), n, u, v, use_native=route == "native")
    assert (name, steps, tuple(meta)) == (jes.backend, jes.num_search_steps,
                                          tuple(jes.meta))
    assert len(arrays) == len(jarrays)
    for a, b in zip(arrays, jarrays):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_perfect_native_and_numpy_tables_agree(graph):
    require_native()
    _, n, u, v = graph
    a = edgeset.build_host_tables(EdgeSetBackend.PERFECT, n, u, v,
                                  use_native=True)
    b = edgeset.build_host_tables(EdgeSetBackend.PERFECT, n, u, v,
                                  use_native=False)
    assert a[:3] == b[:3]
    for x, y in zip(a[3], b[3]):
        assert x.tobytes() == y.tobytes()


def _queries(n, u, v, seed):
    """(name, u, v) query blocks: canonical and swapped true edges, random
    pairs (mostly non-edges), a [S, B, 1] x [S, 1, n] and a [S, B, 1] x
    [S, B, n] broadcast with padded lanes of both kinds (the sentinel N,
    and id 0), the sentinel on either side, and self pairs."""
    r = np.random.RandomState(seed)
    i32 = np.int32
    pick = r.randint(0, len(u), 400)
    nodes = r.randint(0, n, (5, 9)).astype(i32)
    nodes[:, 6:] = n                              # device-style padding
    nodes[1::2, 6:] = 0                           # host-style padding
    nodes[:, 0] = u[r.randint(0, len(u), 5)]      # a node with edges
    shared = r.randint(0, n, (5, 1, 7)).astype(i32)
    private = r.randint(0, n, (5, 9, 7)).astype(i32)
    private[:, 0, :3] = v[r.randint(0, len(u), (5, 3))]
    rand_u = r.randint(0, n, 600).astype(i32)
    rand_v = r.randint(0, n, 600).astype(i32)
    return [
        ("canonical", u[pick].astype(i32), v[pick].astype(i32)),
        ("swapped", v[pick].astype(i32), u[pick].astype(i32)),
        ("random", rand_u, rand_v),
        ("shared-broadcast", nodes[:, :, None], shared),
        ("private-broadcast", nodes[:, :, None], private),
        ("sentinel-u", np.full(50, n, i32), rand_v[:50]),
        ("sentinel-v", rand_u[:50], np.full(50, n, i32)),
        ("zeros", np.zeros(20, i32), np.zeros(20, i32)),
    ]


@pytest.mark.parametrize("backend", ALL)
def test_has_edges_equals_jax(graph, backend):
    """Both packages query the very same tables (the JAX package's, moved
    over by interop.edge_set_from_numpy) and the port's own build: exactly
    equal answers on every query block, true edges found."""
    _, n, u, v = graph
    jes = jax_edgeset.build_edge_set(JaxBackend(backend), n, u, v)
    moved = edge_set_from_numpy(jes.backend, jes.meta,
                                [np.asarray(a) for a in jes.arrays], n,
                                jes.num_search_steps)
    own = edgeset.build_edge_set(EdgeSetBackend(backend), n, u, v, "cpu")
    assert own.backend == backend and own.device.type == "cpu"
    for name, qu, qv in _queries(n, u, v, seed=11):
        want = np.asarray(jes.has_edges(qu, qv))
        for es in (moved, own):
            got = es.has_edges(torch.from_numpy(qu), torch.from_numpy(qv))
            assert got.dtype == torch.bool
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        if name in ("canonical", "swapped"):
            assert want.all()
        if name.startswith("sentinel") and backend != "adjacency":
            assert not want.any()


# ---------------------------------------------------------------------------
# Wraparound: the hashes against Python integers
# ---------------------------------------------------------------------------

M32, M64 = (1 << 32) - 1, (1 << 64) - 1
BIG_IDS = [0, 1, 2, 12345, (1 << 16) - 1, 1 << 16, (1 << 24) + 7,
           (1 << 30) + 12345, (1 << 31) - 2, (1 << 31) - 1]


def _py_fmix32(x):
    x ^= x >> 16
    x = (x * 0x7FEB352D) & M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & M32
    return x ^ (x >> 16)


@pytest.mark.parametrize("c", [0x7FEB352D, 0x846CA68B, 0x9E3779B1, M32, 1, 0])
def test_mul_u32_wraps_like_python(c):
    xs = BIG_IDS + [M32, M32 - 1, 0x80000000, 0xDEADBEEF]
    got = edgeset._mul_u32(torch.tensor(xs, dtype=torch.int64), c)
    assert got.tolist() == [(x * c) & M32 for x in xs]


@pytest.mark.parametrize("seed", [1, 0x9E3779BA, 0xFFFFFFFF])
def test_perfect_hashes_wrap_like_python_and_numpy(seed):
    """u*C1 + v*C2 + seed overflows 32 bits for ids near 2^31: the int64
    lanes of the lookup, the numpy uint32 lanes of the host build and Python
    integers give the same bucket and slot hash."""
    pairs = [(a, b) for a in BIG_IDS for b in BIG_IDS if a < b]
    cu = torch.tensor([p[0] for p in pairs], dtype=torch.int64)
    cv = torch.tensor([p[1] for p in pairs], dtype=torch.int64)
    bmask, smask = (1 << 18) - 1, (1 << 21) - 1
    b, h2 = edgeset._perfect_hashes(cu, cv, seed, bmask, smask)
    want_b = [_py_fmix32((u * 0x9E3779B1 + v * 0x85EBCA77 + seed) & M32)
              & bmask for u, v in pairs]
    want_h = [_py_fmix32((u * 0xC2B2AE35 + v * 0x27D4EB2F
                          + (seed ^ 0x2545F491)) & M32) & smask
              for u, v in pairs]
    assert b.tolist() == want_b and h2.tolist() == want_h
    assert max(u * 0x9E3779B1 + v * 0x85EBCA77 for u, v in pairs) > 1 << 62
    with np.errstate(over="ignore"):
        nu = cu.numpy().astype(np.uint32)
        nv = cv.numpy().astype(np.uint32)
        nb = edgeset._fmix32_numpy(nu * np.uint32(0x9E3779B1)
                                   + nv * np.uint32(0x85EBCA77)
                                   + np.uint32(seed)) & np.uint32(bmask)
    assert nb.tolist() == want_b


@pytest.mark.parametrize("bins", [7, 160_001, (1 << 20) + 3, (1 << 30) - 35])
def test_cuckoo_hashes_wrap_like_python(bins):
    """hash1 = ((P1 * key) mod 2^64) % bins and hash2 = (key ^ P2) % bins
    on the packed key u * 2^32 + v, whose product overflows 64 bits."""
    pairs = [(a, b) for a in BIG_IDS for b in BIG_IDS if a < b]
    cu = torch.tensor([p[0] for p in pairs], dtype=torch.int64)
    cv = torch.tensor([p[1] for p in pairs], dtype=torch.int64)
    h1, h2 = edgeset._cuckoo_hashes(cu, cv, bins)
    keys = [(u << 32) | v for u, v in pairs]
    assert max(15485807 * k for k in keys) > 1 << 64
    assert h1.tolist() == [((15485807 * k) & M64) % bins for k in keys]
    assert h2.tolist() == [(k ^ 920429591) % bins for k in keys]


@pytest.mark.parametrize("backend", ["perfect", "cuckoo", "sorted", "csr"])
def test_large_ids_are_found(backend):
    """A table whose ids reach 2^31 - 1 (built from a handful of edges:
    N only bounds the CSR offsets, so the CSR case keeps small ids):
    every edge is found in both orders, near misses are not."""
    top = (1 << 31) - 1
    if backend == "csr":
        u = np.array([0, 3, 5], np.int64)
        v = np.array([9, 4, 9], np.int64)
        n = 10
    else:
        u = np.array([0, 7, (1 << 30) + 5, top - 3, 1 << 16], np.int64)
        v = np.array([top, 1 << 30, top - 1, top, (1 << 16) + 1], np.int64)
        n = top
    es = edgeset.build_edge_set(EdgeSetBackend(backend), n, u, v, "cpu")
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    assert es.has_edges(tu, tv).all() and es.has_edges(tv, tu).all()
    assert not es.has_edges(tu, tv - 1).any()


# ---------------------------------------------------------------------------
# The invariants of tests/test_edgeset.py, for the port's class
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def edge_data():
    n, u, v = synthetic_edges(num_nodes=500, avg_degree=12, seed=11)
    oracle = set(pack_edges(u, v).tolist())
    rng = np.random.RandomState(5)
    qu = rng.randint(0, n, 4000).astype(np.int32)
    qv = rng.randint(0, n, 4000).astype(np.int32)
    # guaranteed positives, half of them in reversed order
    qu = np.concatenate([qu, u[:500], v[500:1000]]).astype(np.int32)
    qv = np.concatenate([qv, v[:500], u[500:1000]]).astype(np.int32)
    keep = qu != qv
    qu, qv = qu[keep], qv[keep]
    expected = np.array([
        int(pack_edges(min(a, b), max(a, b))) in oracle
        for a, b in zip(qu.tolist(), qv.tolist())])
    return n, u, v, qu, qv, expected


@pytest.mark.parametrize("backend", ALL)
def test_membership_matches_oracle(edge_data, backend):
    n, u, v, qu, qv, expected = edge_data
    es = edgeset.build_edge_set(EdgeSetBackend(backend), n, u, v, "cpu")
    got = es.has_edges(torch.from_numpy(qu), torch.from_numpy(qv))
    np.testing.assert_array_equal(got.numpy(), expected)
    m = (len(qu) // 8) * 8
    got = es.has_edges(torch.from_numpy(qu[:m].reshape(8, -1)),
                       torch.from_numpy(qv[:m].reshape(8, -1)))
    np.testing.assert_array_equal(got.numpy().ravel(), expected[:m])


def test_empty_rows_negative():
    es = edgeset.build_edge_set(EdgeSetBackend.CSR, 10,
                                np.array([0, 1], np.int32),
                                np.array([1, 2], np.int32), "cpu")
    got = es.has_edges(torch.tensor([5, 0, 9], dtype=torch.int32),
                       torch.tensor([6, 1, 0], dtype=torch.int32))
    assert got.tolist() == [False, True, False]


def test_adjacency_broadcast_query_shapes(edge_data):
    n, u, v, *_ = edge_data
    adj = edgeset.build_edge_set(EdgeSetBackend.ADJACENCY, n, u, v, "cpu")
    ph = edgeset.build_edge_set(EdgeSetBackend.PERFECT, n, u, v, "cpu")
    rng = np.random.RandomState(7)
    nodes = torch.from_numpy(rng.randint(0, n, (6, 8)).astype(np.int32))
    nbrs = torch.from_numpy(rng.randint(0, n, (6, 8, 5)).astype(np.int32))
    a = adj.has_edges(nodes[:, :, None], nbrs)
    assert a.shape == (6, 8, 5)
    assert torch.equal(a, ph.has_edges(nodes[:, :, None], nbrs))


def test_auto_backend_resolution(monkeypatch):
    """AUTO picks the matrix under the budget and the perfect hash when
    the budget is shrunk, in ``resolve_backend`` and in the build."""
    n, u, v = synthetic_edges(num_nodes=300, avg_degree=8, seed=3)
    auto = EdgeSetBackend.AUTO
    assert edgeset.build_edge_set(auto, n, u, v, "cpu").backend == \
        "adjacency"
    monkeypatch.setattr(edgeset, "ADJACENCY_AUTO_BUDGET_BYTES", 16)
    assert edgeset.resolve_backend(auto, n, u, v) == EdgeSetBackend.PERFECT
    assert edgeset.build_edge_set(auto, n, u, v, "cpu").backend == "perfect"


def test_perfect_empty_and_singleton():
    none = np.array([], np.int32)
    es = edgeset.build_edge_set(EdgeSetBackend.PERFECT, 10, none, none, "cpu")
    assert not es.has_edges(torch.tensor([1, 2]), torch.tensor([3, 4])).any()
    es = edgeset.build_edge_set(EdgeSetBackend.PERFECT, 10,
                                np.array([2], np.int32),
                                np.array([7], np.int32), "cpu")
    assert es.has_edges(torch.tensor([7, 2, 0]),
                        torch.tensor([2, 7, 1])).tolist() == [True, True,
                                                              False]
