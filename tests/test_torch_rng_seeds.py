"""The seeds of the port's torch streams (rng.stream_seed): a CPU
generator (mt19937, which keeps 32 bits of its seed) takes a fold of all
62 bits of the seed pair, so no two chains share a stream; a CUDA
generator (Philox) takes ``seed_from_pair`` whole, as before; a restore
that cannot set the generators' states seeds them anew with its step
folded in."""

import itertools

import numpy as np
import pytest
import torch

from mcmc_ammsb_tpu_torch import chains, config, data, learner, rng

LOW = 0xFFFFFFFF


@pytest.fixture(scope="module")
def dataset():
    n, u, v = data.synthetic_edges(300, 8, seed=5)
    split = data.generate_sets(n, u, v, heldout_ratio=0.1, seed=6)
    return n, split, data.Graph.from_edges(n, split.training_u,
                                           split.training_v)


def _cfg(dataset, **kw):
    n, split, graph = dataset
    return config.Config(K=8, mini_batch_size=8, num_node_sample=4,
                         **kw).finalize(n, split.total_edges,
                                        graph.max_fan_out)


def test_cpu_seeds_of_16_chains_are_distinct_in_32_bits():
    """The four streams of chain_config c = 0..15: 64 CPU seeds pairwise
    distinct in their low 32 bits (what mt19937 keeps), and the CPU
    generators' first draws pairwise distinct too."""
    cfg = config.Config(K=8)
    pairs = [p for c in range(16)
             for p in rng.stream_pairs(chains.chain_config(cfg, c))]
    seeds = [rng.stream_seed(p, "cpu") for p in pairs]
    assert all(0 <= s <= LOW for s in seeds)
    assert len({s & LOW for s in seeds}) == 64
    streams = [rng.make_streams(chains.chain_config(cfg, c), "cpu")
               for c in range(16)]
    draws = [tuple(torch.randint(0, 1 << 30, (4,), generator=g).tolist())
             for s in streams for g in s]
    assert len(set(draws)) == 64
    assert [g.initial_seed() for s in streams for g in s] == seeds


def test_four_vmap_chains_draw_four_distinct_first_minibatches(
        dataset, monkeypatch):
    """--chain-engine vmap on the CPU: each chain's device sampler draws
    its own first minibatch (chains c and c + 2 used to draw one)."""
    n, split, graph = dataset
    cfg = _cfg(dataset, device_sampling=True, shared_neighbors=True,
               steps_per_call=1)
    first = []
    real = learner.sample_minibatches_device

    def keep(*args, **kwargs):
        out = real(*args, **kwargs)
        first.append(out.nodes[0].clone())
        return out

    monkeypatch.setattr(learner, "sample_minibatches_device", keep)
    engine = chains.MultiChainLearner(cfg, graph, split, 4, "cpu")
    engine.run(1)
    assert len(first) == 4
    for a, b in itertools.combinations(first, 2):
        assert not torch.equal(a, b)


@pytest.mark.parametrize("pair", [(1, 2), (0x7FFFFFFF, 0x7FFFFFFF),
                                  (123456789, 0x5A), (0, 0)])
def test_cuda_seed_is_the_pair_whole(pair):
    """The CUDA rule is the parent's: ``seed_from_pair`` (every card
    trajectory stays as it was); a step past 0 folds in on both kinds."""
    want = rng.seed_from_pair(pair)
    assert rng.stream_seed(pair, "cuda") == want
    assert rng.stream_seed(pair, torch.device("cuda", 0)) == want
    assert rng.stream_seed(pair, "cpu") == rng.block_seed(want, -1) & LOW
    later = {rng.stream_seed(pair, "cuda", step) for step in (1, 2, 1001)}
    assert want not in later and len(later) == 3
    assert rng.stream_seed(pair, "cpu", 7) == rng.block_seed(
        rng.block_seed(want, 7), -1) & LOW


def test_reseed_streams_folds_the_step_in(dataset):
    """``Learner.reseed_streams(S)`` seeds every stream from the config
    with S folded in: two learners re-seeded at one step draw alike, and
    not what a fresh learner draws."""
    n, split, graph = dataset
    cfg = _cfg(dataset, device_sampling=True)
    a, b, fresh = (learner.Learner(cfg, graph, split, "cpu")
                   for _ in range(3))
    a.reseed_streams(21)
    b.reseed_streams(21)
    for ga, gb, gf in zip(a.streams, b.streams, fresh.streams):
        x, y, z = (torch.rand(8, generator=g) for g in (ga, gb, gf))
        assert torch.equal(x, y) and not torch.equal(x, z)
    np.testing.assert_array_equal(
        [g.initial_seed() for g in a.streams],
        [rng.stream_seed(p, "cpu", 21) for p in rng.stream_pairs(cfg)])
