"""The port's device breadth-first samplers against the JAX package's.

BFLink and BFNonLink edges, masks and weights are bit-equal to JAX's
``_sample_bf_link_batch`` / ``_sample_bf_non_link_batch`` when the port's
expansion is handed JAX's own ``fold_in`` draws through a ``BFDraws``
(the pattern of tests/test_device_bf.py:162-216); the node lists equal
JAX's sort dedup; on a power-law hub graph device BFLink equals the
port's own unbounded host walk from the same pivot; the alternate coin
strictly alternates; and the learners train on device-sampled BF
batches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_ammsb_tpu.ops import device_sampling as jax_ds
from mcmc_ammsb_tpu.ops.edgeset import build_edge_set as jax_build_edge_set
from mcmc_ammsb_tpu_torch import config, sampling
from mcmc_ammsb_tpu_torch.chains_flat import FlatChainLearner
from mcmc_ammsb_tpu_torch.data import (Graph, generate_sets, synthetic_edges,
                                       synthetic_powerlaw_edges)
from mcmc_ammsb_tpu_torch.learner import Learner
from mcmc_ammsb_tpu_torch.ops import device_sampling as ds
from mcmc_ammsb_tpu_torch.ops.edgeset import build_edge_set

from torch_parity import jax_config

S_LEN = 6


def _dataset(n=300, deg=8, seed=21):
    n, u, v = synthetic_edges(n, deg, seed=seed)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=seed + 1)
    return n, split, Graph.from_edges(n, split.training_u, split.training_v)


@pytest.fixture(scope="module")
def dataset():
    return _dataset()


def _cfg(dataset, strategy, **kw):
    n, split, graph = dataset
    kw = dict(dict(K=8, mini_batch_size=16, num_node_sample=8), **kw)
    return config.Config(strategy=config.SampleStrategy.parse(strategy),
                         device_sampling=True, **kw).finalize(
        n, split.total_edges, graph.max_fan_out)


def _adjacency(graph):
    return ds.Adjacency(torch.as_tensor(graph.offsets),
                        torch.as_tensor(graph.cols, dtype=torch.int32))


def jax_bf_draws(cfg, key, s_len, non_link):
    """JAX's _bf_expand draws as a BFDraws: round key kr = fold_in(key, r);
    pivot draw t from fold_in(kr, t); BFNonLink candidate draw t from
    fold_in(fold_in(kr, 9), t)."""
    def randint(k, shape):
        return np.asarray(jax.random.randint(k, shape, 0, cfg.N, jnp.int32))

    pivot, cand = [], []
    for r in range(cfg.ds_bf_rounds):
        kr = jax.random.fold_in(key, r)
        pivot.append([randint(jax.random.fold_in(kr, t), (s_len,))
                      for t in range(3)])
        kc = jax.random.fold_in(kr, 9)
        cand.append([randint(jax.random.fold_in(kc, t),
                             (s_len, cfg.ds_bf_pops, ds.BF_NONLINK_DRAWS))
                     for t in range(cfg.ds_nonlink_rounds + 1)])
    return ds.BFDraws(torch.as_tensor(np.asarray(pivot)),
                      torch.as_tensor(np.asarray(cand)) if non_link
                      else None)


def _assert_equal(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [7, 3])
def test_bf_link_bitwise_equals_jax(dataset, seed):
    n, split, graph = dataset
    cfg = _cfg(dataset, "BFLink")
    key = jax.random.PRNGKey(seed)
    jadj = jax_ds._TupleAdj(jnp.asarray(graph.offsets, jnp.int32),
                            jnp.asarray(graph.cols, jnp.int32))
    want = jax_ds._sample_bf_link_batch(jax_config(cfg), jadj, key, S_LEN)
    got = ds._sample_bf_link_batch(cfg, _adjacency(graph),
                                   jax_bf_draws(cfg, key, S_LEN, False),
                                   S_LEN)
    _assert_equal(got, want)
    assert got[2].sum() > 0


@pytest.mark.parametrize("seed", [11, 5])
def test_bf_non_link_bitwise_equals_jax(dataset, seed):
    n, split, graph = dataset
    cfg = _cfg(dataset, "BFNonLink")
    key = jax.random.PRNGKey(seed)
    jtr = jax_build_edge_set(jax_config(cfg).edgeset_backend, n,
                             graph.edges_u, graph.edges_v)
    want = jax_ds._sample_bf_non_link_batch(jax_config(cfg), jtr, key, S_LEN)
    tr = build_edge_set(cfg.edgeset_backend, n, graph.edges_u, graph.edges_v,
                        "cpu")
    got = ds._sample_bf_non_link_batch(cfg, tr,
                                       jax_bf_draws(cfg, key, S_LEN, True),
                                       S_LEN)
    _assert_equal(got, want)
    assert (got[2].sum(1) == cfg.mini_batch_size).all()


def test_extract_nodes_equals_jax(dataset):
    """The sort dedup of BF batches (nodes and mask, sentinel N padding)
    on the same edges, masked lanes included."""
    cfg = _cfg(dataset, "BF")
    g = np.random.default_rng(0)
    eu = g.integers(0, 40, (5, cfg.max_batch_edges)).astype(np.int32)
    ev = g.integers(0, 40, (5, cfg.max_batch_edges)).astype(np.int32)
    mask = g.random((5, cfg.max_batch_edges)) < 0.7
    want = jax_ds._extract_nodes(jax_config(cfg), jnp.asarray(eu),
                                 jnp.asarray(ev), jnp.asarray(mask))
    got = ds._extract_nodes(cfg, torch.as_tensor(eu), torch.as_tensor(ev),
                            torch.as_tensor(mask))
    _assert_equal(got, want)


def test_keep_first_dups_past_int32():
    """The dedup key a*(N+1)+b needs int64 at N = 317,080: two distinct
    pairs whose keys agree modulo 2^32 stay distinct; a repeat is
    marked at its later lane only."""
    n = 317_080
    d = next(d for d in range(1, n) if d * (n + 1) % 2 ** 32 < n)
    r = d * (n + 1) % 2 ** 32
    a = torch.tensor([[d, 0, d, 5]], dtype=torch.int32)
    b = torch.tensor([[0, r, 0, 7]], dtype=torch.int32)
    dup = ds._keep_first_dups(n, a, b, torch.ones_like(a, dtype=torch.bool))
    assert dup.tolist() == [[False, False, True, False]]


def test_compose_rows_drops_past_the_width():
    buf = torch.zeros(2, 4, dtype=torch.int32)
    vals = torch.tensor([[7, 8, 9], [1, 2, 3]], dtype=torch.int32)
    dst = torch.tensor([[4, 0, 9], [3, 4, 1]], dtype=torch.int32)
    out = ds._compose_rows(buf, vals, dst)
    assert out.tolist() == [[8, 0, 0, 0], [0, 3, 0, 1]]


def test_device_bf_link_equals_the_host_walk_on_a_hub_graph():
    """Power-law graph with max fan-out far past the 2m row cap: each
    device batch whose host walk fills m edges from the same pivot in one
    component equals the port's own host walk (sampling._bf_link),
    truncated hub rows included."""
    n, u, v = synthetic_powerlaw_edges(600, 6.0, max_degree=200, seed=31)
    split = generate_sets(n, u, v, heldout_ratio=0.05, seed=32)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = _cfg((n, split, graph), "BFLink", mini_batch_size=8,
               num_node_sample=4)
    assert graph.max_fan_out > 2 * cfg.mini_batch_size
    s_len = 8
    gen = torch.Generator().manual_seed(11)
    draws = ds.draw_bf(cfg, gen, s_len, "cpu", False)
    eu, ev, mask, _ = ds._sample_bf_link_batch(cfg, _adjacency(graph), draws,
                                               s_len)
    host = sampling.MiniBatchSampler(cfg, graph, split)
    checked, hub_hit = 0, False
    for s in range(s_len):
        pivot = int(draws.pivot[0, 0, s])
        host._fresh_pivot = lambda seen, p=pivot: p
        try:
            hu, hv, _ = host._bf_link()
        except RuntimeError:     # the pivot's component holds < m edges
            continue
        want = list(zip(hu.tolist(), hv.tolist()))
        got = list(zip(eu[s][mask[s]].tolist(), ev[s][mask[s]].tolist()))
        if len(want) == cfg.mini_batch_size:
            assert got == want
            checked += 1
            deg = [len(graph.neighbors_of(x)) for e in want for x in e]
            hub_hit |= max(deg) > 2 * cfg.mini_batch_size
    assert checked >= 4 and hub_hit


def _kinds(dataset, samples):
    n, split, graph = dataset
    training = set(zip(graph.edges_u.tolist(), graph.edges_v.tolist()))
    out = []
    for s in range(samples.edges_u.shape[0]):
        m = samples.edge_mask[s]
        pairs = set(zip(samples.edges_u[s][m].tolist(),
                        samples.edges_v[s][m].tolist()))
        assert pairs and (pairs <= training or not pairs & training)
        out.append(pairs <= training)
    return out


@pytest.mark.parametrize("coin", ["alternate", "random"])
def test_bf_coin(dataset, coin):
    """-s BF: every batch is all links or all non-links; the alternate
    coin strictly alternates by step (link first), also with two draws
    per step (alt_period 2, the chain engine's), the random coin takes
    both; the node lists cover exactly the endpoints."""
    n, split, graph = dataset
    cfg = _cfg(dataset, "BF", node_coin=coin)
    tr = build_edge_set(cfg.edgeset_backend, n, graph.edges_u, graph.edges_v,
                        "cpu")
    ho = build_edge_set(cfg.edgeset_backend, n, split.heldout_u,
                        split.heldout_v, "cpu")
    gen = torch.Generator().manual_seed(6)
    out = ds.sample_minibatches_device(cfg, tr, ho, gen, 16,
                                       _adjacency(graph))
    kinds = _kinds(dataset, out)
    if coin == "alternate":
        assert kinds == [s % 2 == 0 for s in range(16)]
        two = ds.sample_minibatches_device(cfg, tr, ho, gen, 8,
                                           _adjacency(graph), alt_period=2)
        assert _kinds(dataset, two) == [s % 4 < 2 for s in range(8)]
    else:
        assert any(kinds) and not all(kinds)
    for s in range(16):
        m = out.edge_mask[s]
        ends = set(out.edges_u[s][m].tolist()) | set(out.edges_v[s][m].tolist())
        assert set(out.nodes[s][out.node_mask[s]].tolist()) == ends
    np.testing.assert_array_equal(
        (out.weight * out.edge_mask.sum(1)).numpy(),
        np.where(kinds, np.float32(cfg.E),
                 np.float32(n * (n - 1) / 2.0 - cfg.E)))


@pytest.mark.parametrize("engine", ["single", "chains"])
def test_learners_train_on_device_bf(dataset, engine):
    """20 device-sampled BFLink steps lower the held-out perplexity of
    the single-chain Learner and of every chain of FlatChainLearner
    (C=2)."""
    n, split, graph = dataset
    cfg = _cfg(dataset, "BFLink", K=8, mini_batch_size=32, a=0.2,
               steps_per_call=10, window=0, shared_neighbors=False)
    if engine == "single":
        lrn = Learner(cfg, graph, split, "cpu")
    else:
        lrn = FlatChainLearner(cfg, graph, split, 2, "cpu")
    p0 = np.asarray(lrn.heldout_perplexity())
    lrn.run(20)
    p1 = np.asarray(lrn.heldout_perplexity())
    assert lrn.step_count == 21
    assert np.isfinite(p1).all() and (p1 < p0).all()
    lrn.close()
