"""Training perplexity, the noise-free golden mode and the explicit
golden twin of the window (``--window-impl jnp``) against the JAX
package's, on the CPU.

State tolerance: normwise rtol 5e-5, atol 1e-8, the tolerance of
tests/test_torch_slice.py (torch's and XLA's CPU matmuls sum in other
orders and the chain feeds the last-bit differences back); perplexity and
its running averages rtol 1e-5.
"""

from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_ammsb_tpu import data as jax_data
from mcmc_ammsb_tpu import learner as jax_learner
from mcmc_ammsb_tpu.config import EdgeSetBackend as JaxEdgeSetBackend
from mcmc_ammsb_tpu.ops.edgeset import build_edge_set as jax_build_edge_set
from mcmc_ammsb_tpu_torch import config, data, learner
from mcmc_ammsb_tpu_torch.interop import edge_set_from_numpy, state_from_numpy
from mcmc_ammsb_tpu_torch.ops import window
from mcmc_ammsb_tpu_torch.sampling import MiniBatchSampler

from torch_parity import (assert_close, assert_normwise, jax_config,
                          jax_hoist, to_torch)

STATE = ("pi", "phi_sum", "theta", "beta")


def _setup(small_dataset, train_ppx_size=0, **kw):
    """Config, the JAX training set and the port's over the same table,
    and both packages' equal initial states."""
    n, split, graph = small_dataset
    cfg = config.Config(
        **{**dict(K=16, mini_batch_size=8, num_node_sample=8,
                  device_sampling=False, shared_neighbors=False,
                  host_sampler="numpy", steps_per_call=1), **kw}).finalize(
        n, split.total_edges, graph.max_fan_out)
    jcfg = jax_config(cfg)
    jset = jax_build_edge_set(JaxEdgeSetBackend.ADJACENCY, n, graph.edges_u,
                              graph.edges_v)
    tset = edge_set_from_numpy(jset.backend, jset.meta,
                               [np.asarray(a) for a in jset.arrays], n,
                               jset.num_search_steps)
    jstate = jax_learner.init_state(jcfg, len(split.heldout_edges_u),
                                    train_ppx_size)
    tstate = state_from_numpy(
        {f: np.asarray(v) for f, v in jstate._asdict().items()
         if v is not None}, cfg, "cpu")
    return cfg, jcfg, jset, tset, jstate, tstate


def test_training_perplexity_step_matches_jax(small_dataset):
    """Three evaluations over the training-perplexity population (the
    port's make_training_ppx_edges, array-equal to JAX's) on the same
    state, pi perturbed between them so that the running averages move:
    -mean log and the averages at rtol 1e-5, the counter advanced, the
    held-out averages untouched."""
    _, split, _ = small_dataset
    tu, tv = data.make_training_ppx_edges(split, 0.05)
    ju, jv = jax_data.make_training_ppx_edges(split, 0.05)
    np.testing.assert_array_equal(tu, ju)
    np.testing.assert_array_equal(tv, jv)
    cfg, jcfg, jset, tset, jstate, tstate = _setup(
        small_dataset, len(tu), calc_train_ppx=True, training_ppx_ratio=0.05)
    assert tstate.train_ppx_per_edge.shape == (len(tu),)
    r = np.random.default_rng(3)
    for call in range(3):
        jstate, jres = jax_learner.training_perplexity_step(
            jcfg, jset, jnp.asarray(ju), jnp.asarray(jv), jstate)
        tstate, tres = learner.training_perplexity_step(
            cfg, tset, torch.from_numpy(tu), torch.from_numpy(tv), tstate)
        assert tstate.train_ppx_count == call + 1 == int(
            jstate.train_ppx_count)
        assert tstate.ppx_count == 0
        assert_close(tres.neg_avg_log, jres.neg_avg_log, 1e-5, 0.0,
                     f"call {call}: -mean log")
        assert_close(tstate.train_ppx_per_edge, jstate.train_ppx_per_edge,
                     1e-5, 0.0, f"call {call}: running averages")
        pi = r.dirichlet(np.ones(cfg.K), cfg.N).astype(np.float32)
        jstate = jstate._replace(pi=jnp.asarray(pi))
        tstate.pi.copy_(torch.from_numpy(pi))


def test_learner_training_perplexity_and_series(small_dataset):
    """Learner.training_perplexity needs cfg.calc_train_ppx; with it the
    population is built in the constructor, run_with_ppx carries a
    train_ppx entry evaluated after the held-out one (the same running
    averages as the host loop's two calls), finite and above 1. (The
    population is N(N-1)/2E non-links per link, so on this graph the value
    sits near 1.18 and hardly moves in 80 steps.)"""
    n, split, graph = small_dataset
    kw = dict(K=16, mini_batch_size=8, num_node_sample=8,
              device_sampling=True, shared_neighbors=True, window=4,
              steps_per_call=40)
    off = learner.Learner(config.Config(**kw).finalize(
        n, split.total_edges, graph.max_fan_out), graph, split, "cpu")
    with pytest.raises(RuntimeError, match="calc_train_ppx"):
        off.training_perplexity()
    assert off.state.train_ppx_per_edge.shape == (0,)
    cfg = config.Config(**kw, calc_train_ppx=True,
                        training_ppx_ratio=0.05).finalize(
        n, split.total_edges, graph.max_fan_out)
    fused = learner.Learner(cfg, graph, split, "cpu")
    series = fused.run_with_ppx(80, 20)
    host = learner.Learner(cfg, graph, split, "cpu")
    for entry in series:
        host.run(20)
        assert host.heldout_perplexity() == entry["ppx"]
        assert host.training_perplexity() == entry["train_ppx"]
    assert torch.equal(host.state.train_ppx_per_edge,
                       fused.state.train_ppx_per_edge)
    assert host.state.train_ppx_count == 4
    assert all(np.isfinite(e["train_ppx"]) and e["train_ppx"] > 1.0
               for e in series)


def test_noise_free_operand_is_ones_and_leaves_the_stream(small_dataset):
    """With cfg.phi_disable_noise the phi noise operand is ONES (not
    zeros, not randn) in the hoisted tuple and in one step's draws, the
    phi generator is not advanced, and the theta noise is still drawn."""
    cfg, *_ = _setup(small_dataset, phi_disable_noise=True, steps_per_call=4)
    _, split, graph = small_dataset
    lrn = learner.Learner(cfg, graph, split, "cpu", prefetch=False)
    before = lrn.streams.phi.get_state().clone()
    beta_before = lrn.streams.beta.get_state().clone()
    batches = learner.DeviceBatch.from_stacked(lrn.sampler.sample_many(4),
                                               "cpu")
    xs = learner.hoist_operands(cfg, lrn.training_set, batches, lrn.streams)
    assert torch.equal(xs[3], torch.ones(4, batches.nodes.shape[1], cfg.K))
    one = learner.DeviceBatch(*(a[0] for a in batches))
    _, phi_noise, beta_noise = learner.draw_step_operands(cfg, lrn.streams,
                                                          one)
    assert torch.equal(phi_noise, torch.ones_like(phi_noise))
    assert torch.equal(lrn.streams.phi.get_state(), before)
    assert not torch.equal(lrn.streams.beta.get_state(), beta_before)
    assert float(beta_noise.std()) > 0.1 and float(xs[4].std()) > 0.1


def _ones_for(cfg, xs):
    """The JAX-built operand tuple with the port's own noise-free phi
    operand in place of the keyed draws (which jax_hoist recomputes
    whatever the mode)."""
    ones = learner.phi_noise_operand(cfg, None, tuple(xs[3].shape), "cpu")
    return (*xs[:3], ones, *xs[4:])


def test_noise_free_train_step_matches_jax(small_dataset):
    """10 train_steps in the noise-free mode against JAX's train_step
    (which puts ones where the port is handed its own ones); neighbors and
    theta noise are JAX's keyed draws."""
    cfg, jcfg, jset, tset, jstate, tstate = _setup(small_dataset,
                                                   phi_disable_noise=True)
    _, split, graph = small_dataset
    stacked = MiniBatchSampler(cfg, graph, split, seed=0).sample_many(10)
    jbatches = jax_learner.DeviceBatch.from_stacked(stacked)
    tbatches = learner.DeviceBatch.from_stacked(stacked, "cpu")
    xs = _ones_for(cfg, to_torch(jax_hoist(jcfg, jset, jstate, jbatches),
                                 learner.DeviceBatch))
    jstep = jax.jit(partial(jax_learner.train_step, jcfg))
    for i in range(10):
        jstate = jstep(jset, jstate,
                       jax_learner.DeviceBatch(*(a[i] for a in jbatches)))
        tstate = learner.train_step(
            cfg, tset, tstate, learner.DeviceBatch(*(a[i] for a in tbatches)),
            xs[1][i], xs[3][i], xs[4][i])
    assert tstate.step_count == int(jstate.step_count) == 11
    for f in STATE:
        assert_normwise(getattr(tstate, f), getattr(jstate, f), 5e-5, 1e-8, f)


def test_noise_free_windowed_chunk_matches_jax(small_dataset):
    """One chunk of 10 steps, shared draws, windows of 4 and two tail
    steps, in the noise-free mode against JAX's train_steps_scan (its
    window through its plain reference, window_impl='jnp')."""
    cfg, jcfg, jset, tset, jstate, tstate = _setup(
        small_dataset, phi_disable_noise=True, shared_neighbors=True,
        window=4, window_impl="jnp", steps_per_call=10)
    _, split, graph = small_dataset
    stacked = MiniBatchSampler(cfg, graph, split, seed=0).sample_many(10)
    jbatches = jax_learner.DeviceBatch.from_stacked(stacked)
    xs = _ones_for(cfg, to_torch(jax_hoist(jcfg, jset, jstate, jbatches),
                                 learner.DeviceBatch))
    jstate = jax.jit(partial(jax_learner.train_steps_scan, jcfg))(
        jset, jstate, jbatches)
    tstate = learner.run_hoisted(cfg, tstate, xs)
    assert tstate.step_count == int(jstate.step_count) == 11
    for f in STATE:
        assert_normwise(getattr(tstate, f), getattr(jstate, f), 5e-5, 1e-8, f)


def test_window_impl_jnp_is_the_windowed_run_on_the_cpu(small_dataset):
    """--window-impl jnp routes a windowed run through the plain version
    of the window: on the CPU, where the default runs the plain version
    too, both give the same states bit for bit; on a card the default
    picks the kernel and jnp the plain version (plain_or); an unknown
    window_impl raises as the JAX Learner does."""
    n, split, graph = small_dataset
    kw = dict(K=16, mini_batch_size=8, num_node_sample=8,
              device_sampling=True, shared_neighbors=True, window=4,
              steps_per_call=30)
    runs = []
    for impl in ("pallas", "jnp"):
        cfg = config.Config(**kw, window_impl=impl).finalize(
            n, split.total_edges, graph.max_fan_out)
        lrn = learner.Learner(cfg, graph, split, "cpu")
        lrn.run(30)
        runs.append(lrn.state)
    for f in STATE:
        assert torch.equal(getattr(runs[0], f), getattr(runs[1], f)), f
    on_card = SimpleNamespace(pi=SimpleNamespace(is_cuda=True))
    on_cpu = SimpleNamespace(pi=SimpleNamespace(is_cuda=False))
    pallas, jnp_cfg = (config.Config(window_impl=i) for i in ("pallas", "jnp"))
    assert window.plain_or(pallas, on_card, "kernel", "plain") == "kernel"
    assert window.plain_or(jnp_cfg, on_card, "kernel", "plain") == "plain"
    assert window.plain_or(pallas, on_cpu, "kernel", "plain") == "plain"
    bad = config.Config(**kw, window_impl="triton")
    with pytest.raises(ValueError, match="unknown window_impl 'triton'"):
        learner.Learner(bad, graph, split, "cpu")
