"""The port's host minibatch sampler against the JAX package's: the same
batches, array for array, from the same seeds, on the numpy route and on
the native route; the retry budget; the prefetch thread."""

import dataclasses
import threading

import numpy as np
import pytest

from mcmc_ammsb_tpu import config as jax_config_mod
from mcmc_ammsb_tpu import sampling as jax_sampling
from mcmc_ammsb_tpu_torch import config, sampling
from mcmc_ammsb_tpu_torch.data import (DataSplit, Graph, generate_sets,
                                       synthetic_edges)

from torch_parity import jax_config, require_native

STRATEGIES = ["Node", "NodeLink", "NodeNonLink", "BF", "BFLink", "BFNonLink"]
FIELDS = [f.name for f in dataclasses.fields(sampling.StackedBatches)]


@pytest.fixture(scope="module")
def dataset():
    n, u, v = synthetic_edges(400, 10, seed=7)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=3)
    return n, split, Graph.from_edges(n, split.training_u, split.training_v)


def _cfg(dataset, strategy, **kw):
    n, split, graph = dataset
    return config.Config(
        K=8, mini_batch_size=8, num_node_sample=8,
        strategy=config.SampleStrategy.parse(strategy), **kw).finalize(
        n, split.total_edges, graph.max_fan_out)


def _same(got, want):
    for f in FIELDS:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_numpy_sampler_equals_jax(dataset, strategy, seed):
    """20 single batches, then a stacked chunk of 5, from one stream."""
    n, split, graph = dataset
    cfg = _cfg(dataset, strategy, host_sampler="numpy")
    mine = sampling.MiniBatchSampler(cfg, graph, split, seed=seed)
    theirs = jax_sampling.MiniBatchSampler(jax_config(cfg), graph, split,
                                           seed=seed)
    for _ in range(20):
        a, b = mine.sample(), theirs.sample()
        for f in ("edges_u", "edges_v", "edge_mask", "nodes", "node_mask"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.weight == b.weight and a.weight.dtype == np.float32
        # padded lanes: id 0, mask false
        assert not a.nodes[~a.node_mask].any()
        assert not a.edges_u[~a.edge_mask].any()
    _same(mine.sample_many(5), theirs.sample_many(5))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_native_route_equals_jax(dataset, strategy):
    """sample_many(50) twice: the seed rule seed0 * 0x9E3779B9 + call
    count gives the JAX package's chunks, and a second call differs from
    the first."""
    require_native()
    n, split, graph = dataset
    cfg = _cfg(dataset, strategy, host_sampler="native")
    mine = sampling.MiniBatchSampler(cfg, graph, split, seed=5)
    theirs = jax_sampling.MiniBatchSampler(jax_config(cfg), graph, split,
                                           seed=5)
    assert mine.use_native and theirs.use_native
    first = mine.sample_many(50)
    _same(first, theirs.sample_many(50))
    second = mine.sample_many(50)
    _same(second, theirs.sample_many(50))
    assert mine._native_call_count == 2
    assert not np.array_equal(first.edges_u, second.edges_u)
    assert first.nodes.shape == (50, cfg.max_batch_nodes)


def test_weights(dataset):
    """The importance weight of each strategy."""
    n, split, graph = dataset
    e, m = split.total_edges, 8
    want = {"NodeLink": float(n), "NodeNonLink": 2.0 * e / m,
            "BFLink": float(e) / m,
            "BFNonLink": (n * (n - 1) / 2.0 - e) / m}
    for strategy, w in want.items():
        s = sampling.MiniBatchSampler(
            _cfg(dataset, strategy, host_sampler="numpy"), graph, split)
        assert s.sample().weight == np.float32(w)


@pytest.mark.parametrize("strategy", ["NodeNonLink", "BFNonLink"])
def test_sampler_exhausted_on_a_near_complete_graph(strategy):
    """Every pair but one is an edge: the non-link strategies run out of
    their retry budget and raise, as the JAX package's do."""
    n = 12
    iu, iv = np.triu_indices(n, 1)
    u, v = iu[1:].astype(np.int32), iv[1:].astype(np.int32)
    none = np.zeros(0, np.int32)
    split = DataSplit(n, u, v, none, none, none, none, len(u))
    graph = Graph.from_edges(n, u, v)
    cfg = config.Config(K=4, mini_batch_size=4, num_node_sample=4,
                        strategy=config.SampleStrategy.parse(strategy),
                        host_sampler="numpy").finalize(n, len(u),
                                                       graph.max_fan_out)
    with pytest.raises(sampling.SamplerExhausted, match="retry budget"):
        for _ in range(50):
            sampling.MiniBatchSampler(cfg, graph, split).sample()
    jcfg = jax_config(cfg)
    assert isinstance(jcfg, jax_config_mod.Config)
    with pytest.raises(jax_sampling.SamplerExhausted):
        for _ in range(50):
            jax_sampling.MiniBatchSampler(jcfg, graph, split).sample()


def test_pad_batch(dataset):
    cfg = _cfg(dataset, "Node")
    b = sampling.pad_batch(cfg, np.array([5, 2], np.int32),
                           np.array([9, 5], np.int32), 3.5)
    assert b.nodes[:3].tolist() == [2, 5, 9] and b.node_mask.sum() == 3
    assert b.edge_mask.sum() == 2 and b.weight == np.float32(3.5)
    assert b.nodes.shape == (cfg.max_batch_nodes,)
    too_many = np.arange(cfg.max_batch_edges + 1, dtype=np.int32)
    with pytest.raises(ValueError, match="exceeds capacity"):
        sampling.pad_batch(cfg, too_many, too_many + 1, 1.0)


class _Counting:
    """A sampler that hands out 0, 1, 2, ... and can be told to fail."""

    def __init__(self, fail_at=None):
        self.n, self.fail_at = 0, fail_at
        self.threads = set()

    def sample(self):
        self.threads.add(threading.current_thread())
        if self.n == self.fail_at:
            raise ValueError("boom")
        self.n += 1
        return self.n - 1

    def sample_many(self, count):
        return [self.sample() for _ in range(count)]


@pytest.mark.parametrize("chunk", [1, 3])
def test_prefetcher_order_and_drain(chunk):
    """get() hands items out in production order; drain() returns the
    produced-but-unconsumed ones, in order, and stops the thread."""
    src = _Counting()
    pre = sampling.PrefetchingSampler(src, depth=2, chunk=chunk)
    flat = lambda x: x if chunk > 1 else [x]
    got = flat(pre.get()) + flat(pre.get())
    pending = [i for item in pre.drain() for i in flat(item)]
    assert got + pending == list(range(len(got) + len(pending)))
    assert not pre._thread.is_alive()
    assert threading.current_thread() not in src.threads
    assert src.n == len(got) + len(pending)      # nothing drawn was lost


def test_prefetcher_reraises_producer_error():
    pre = sampling.PrefetchingSampler(_Counting(fail_at=1), depth=2)
    assert pre.get() == 0
    with pytest.raises(RuntimeError, match="producer failed") as err:
        pre.get()
    assert isinstance(err.value.__cause__, ValueError)
    pre.close()
    assert not pre._thread.is_alive()
