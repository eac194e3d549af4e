"""The port's membership and device samplers. Membership must equal the
JAX package's exactly; the samplers draw from torch generators (other
numbers than JAX's threefry), so they are held to the invariants of
tests/test_device_sampling.py and to a Python-set membership oracle."""

import numpy as np
import pytest
import torch

from mcmc_ammsb_tpu import config as jax_config_mod
from mcmc_ammsb_tpu.ops.edgeset import build_edge_set as jax_build_edge_set
from mcmc_ammsb_tpu_torch import rng
from mcmc_ammsb_tpu_torch.config import (Config, EdgeSetBackend,
                                         SampleStrategy)
from mcmc_ammsb_tpu_torch.data import Graph, generate_sets, synthetic_edges
from mcmc_ammsb_tpu_torch.ops import edgeset
from mcmc_ammsb_tpu_torch.ops.device_sampling import (
    Adjacency, sample_minibatches_device)
from mcmc_ammsb_tpu_torch.ops.neighbor import sample_neighbors
from mcmc_ammsb_tpu_torch.types import pack_edges


@pytest.fixture(scope="module")
def setup():
    n, u, v = synthetic_edges(400, 10, seed=9)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=10)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    tr = edgeset.build_edge_set(EdgeSetBackend.AUTO, n, graph.edges_u,
                                graph.edges_v, "cpu")
    ho = edgeset.build_edge_set(EdgeSetBackend.AUTO, n, split.heldout_u,
                                split.heldout_v, "cpu")
    adj = Adjacency(torch.as_tensor(graph.offsets),
                    torch.as_tensor(graph.cols, dtype=torch.int32))
    training = set(pack_edges(graph.edges_u, graph.edges_v).tolist())
    heldout = set(pack_edges(split.heldout_u, split.heldout_v).tolist())
    return n, split, graph, tr, ho, adj, training, heldout


def _cfg(setup, strategy, **kw):
    n, split, graph = setup[:3]
    return Config(K=8, mini_batch_size=16, num_node_sample=8,
                  strategy=strategy, device_sampling=True, **kw).finalize(
        n, split.total_edges, graph.max_fan_out)


def _draw(setup, cfg, s_len, seed=0):
    _, _, _, tr, ho, adj, _, _ = setup
    gen = rng.generator((seed, 1), "cpu")
    return sample_minibatches_device(cfg, tr, ho, gen, s_len, adj)


def test_has_edges_equals_jax(setup):
    """Adjacency membership equals the JAX package's on real edges,
    random pairs, the padded-lane sentinel N and the broadcast
    [S, B, 1] x [S, 1, n] shape of the hoisted neighbor labels."""
    n, split, graph, tr = setup[:4]
    jtr = jax_build_edge_set(jax_config_mod.EdgeSetBackend.ADJACENCY, n,
                             graph.edges_u, graph.edges_v)
    r = np.random.default_rng(5)
    u = np.concatenate([graph.edges_u[:50], r.integers(0, n + 1, 200)])
    v = np.concatenate([graph.edges_v[:50], r.integers(0, n + 1, 200)])
    u, v = u.astype(np.int32), v.astype(np.int32)
    got = tr.has_edges(torch.from_numpy(u), torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jtr.has_edges(u, v)))
    assert got[:50].all()
    nodes = r.integers(0, n + 1, (3, 9, 1)).astype(np.int32)
    nbrs = r.integers(0, n, (3, 1, 8)).astype(np.int32)
    got = tr.has_edges(torch.from_numpy(nodes), torch.from_numpy(nbrs))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jtr.has_edges(nodes, nbrs)))


def test_auto_backend_budget(setup, monkeypatch):
    """AUTO picks the adjacency matrix within the 1 GiB budget; past it
    the perfect hash, as the JAX package does, with the same answers."""
    n, split, graph, tr = setup[:4]
    assert tr.backend == "adjacency"
    monkeypatch.setattr(edgeset, "ADJACENCY_AUTO_BUDGET_BYTES", 0)
    ph = edgeset.build_edge_set(EdgeSetBackend.AUTO, n, graph.edges_u,
                                graph.edges_v, "cpu")
    assert ph.backend == "perfect"
    u = torch.from_numpy(np.concatenate([graph.edges_u[:50],
                                         graph.edges_v[:50]]))
    v = torch.from_numpy(np.concatenate([graph.edges_v[:50],
                                         graph.edges_u[:50] + 1]))
    assert torch.equal(ph.has_edges(u, v), tr.has_edges(u, v))
    assert ph.has_edges(u, v)[:50].all()


def test_sample_neighbors_distinct(setup):
    n = setup[0]
    gen = rng.generator((3, 4), "cpu")
    nodes = torch.randint(0, n, (50, 9), generator=gen, dtype=torch.int32)
    nbrs = sample_neighbors(gen, nodes, n, 32).numpy()
    assert nbrs.shape == (50, 9, 32)
    assert (nbrs >= 0).all() and (nbrs < n).all()
    flat = nbrs.reshape(-1, 32)
    assert all(len(set(row.tolist())) == 32 for row in flat)
    assert not (nbrs == nodes.numpy()[..., None]).any()


def test_node_link_batches(setup):
    n, split, graph, _, _, _, training, _ = setup
    cfg = _cfg(setup, SampleStrategy.NODE_LINK)
    ds = _draw(setup, cfg, 20)
    for s in range(20):
        mask = ds.edge_mask[s].numpy()
        eu, ev = ds.edges_u[s].numpy()[mask], ds.edges_v[s].numpy()[mask]
        assert len(eu) > 0
        assert all(int(k) in training for k in pack_edges(eu, ev))
        pivot = int(ds.nodes[s, 0])
        assert ((eu == pivot) | (ev == pivot)).all()
        assert len(eu) == len(graph.neighbors_of(pivot))
        assert float(ds.weight[s]) == cfg.N
        _check_nodes(cfg, ds, s, eu, ev)


def test_node_non_link_batches(setup):
    n, split, graph, _, _, _, training, heldout = setup
    cfg = _cfg(setup, SampleStrategy.NODE_NON_LINK)
    ds = _draw(setup, cfg, 20, seed=1)
    for s in range(20):
        mask = ds.edge_mask[s].numpy()
        eu, ev = ds.edges_u[s].numpy()[mask], ds.edges_v[s].numpy()[mask]
        keys = pack_edges(eu, ev)
        assert len(eu) >= cfg.mini_batch_size - 1
        assert len(set(keys.tolist())) == len(eu)
        assert not any(int(k) in training or int(k) in heldout
                       for k in keys)
        assert (eu < ev).all()
        # weight * m_eff == 2E: the unbiased reweight of masked lanes
        assert np.isclose(float(ds.weight[s]) * len(eu), 2.0 * cfg.E)
        _check_nodes(cfg, ds, s, eu, ev)


@pytest.mark.parametrize("coin", ["random", "alternate"])
def test_node_coin(setup, coin):
    """Node strategy: every step is a NodeLink or a NodeNonLink draw;
    the random coin gives both kinds, the alternate coin strictly
    alternates them (odd step count: a trailing link step)."""
    training = setup[6]
    cfg = _cfg(setup, SampleStrategy.NODE, node_coin=coin)
    ds = _draw(setup, cfg, 33, seed=2)
    kinds = []
    for s in range(33):
        mask = ds.edge_mask[s].numpy()
        keys = pack_edges(ds.edges_u[s].numpy()[mask],
                          ds.edges_v[s].numpy()[mask])
        link = float(ds.weight[s]) == cfg.N
        assert all((int(k) in training) == link for k in keys)
        kinds.append(link)
    if coin == "alternate":
        assert kinds == [s % 2 == 0 for s in range(33)]
    else:
        assert any(kinds) and not all(kinds)


def test_link_cap_hub_reweight():
    """ds_link_cap: hub pivots get capped, deduped draws through the
    pivot with the Horvitz-Thompson weight N/p; small pivots keep the
    exact batch and weight N."""
    d, cap = 50, 8
    u = np.concatenate([np.zeros(d, np.int32), np.arange(1, d + 1)])
    v = np.concatenate([np.arange(1, d + 1), np.arange(1, d + 1) % d + 1])
    graph = Graph.from_edges(d + 1, u, v)
    tr = edgeset.build_edge_set(EdgeSetBackend.ADJACENCY, d + 1,
                                graph.edges_u, graph.edges_v, "cpu")
    cfg = Config(K=4, mini_batch_size=cap, num_node_sample=4,
                 strategy=SampleStrategy.NODE_LINK, device_sampling=True,
                 ds_link_cap=cap).finalize(d + 1, len(graph.edges_u),
                                           graph.max_fan_out)
    adj = Adjacency(torch.as_tensor(graph.offsets),
                    torch.as_tensor(graph.cols, dtype=torch.int32))
    ds = sample_minibatches_device(cfg, tr, tr, rng.generator((5, 6), "cpu"),
                                   512, adj)
    piv = ds.nodes[:, 0].numpy()
    w = ds.weight.numpy()
    hub = piv == 0
    assert hub.any() and (~hub).any()
    p_inc = 1.0 - (1.0 - 1.0 / d) ** cap
    np.testing.assert_allclose(w[hub], cfg.N / p_inc, rtol=1e-6)
    assert (w[~hub] == cfg.N).all()
    assert (ds.edge_mask.numpy()[~hub].sum(-1) == 3).all()
    for i in np.flatnonzero(hub)[:50]:
        m = ds.edge_mask[i].numpy()
        pairs = list(zip(ds.edges_u[i].numpy()[m], ds.edges_v[i].numpy()[m]))
        assert len(set(pairs)) == len(pairs)
        assert all(0 in p for p in pairs)


def _check_nodes(cfg, ds, s, eu, ev):
    """Node lanes: pivot then partners, distinct, exactly the edge
    endpoints; masked lanes hold the sentinel N."""
    nmask = ds.node_mask[s].numpy()
    nodes = ds.nodes[s].numpy()
    valid = nodes[nmask]
    assert len(set(valid.tolist())) == len(valid)
    assert set(valid.tolist()) == set(eu.tolist()) | set(ev.tolist())
    assert (nodes[~nmask] == cfg.N).all()
