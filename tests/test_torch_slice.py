"""The port's main path as a whole against the JAX package's.

The two packages draw different random numbers, so the JAX package
draws everything state-independent — the minibatches and the hoisted
operand tuple, recomputed here with its own functions exactly as
learner.py:488-536 builds it — and both packages run the same steps
from the same initial state: windows + tail steps, then the held-out
perplexity, over eval intervals that are not multiples of the window.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_ammsb_tpu import learner as jax_learner
from mcmc_ammsb_tpu.config import EdgeSetBackend as JaxEdgeSetBackend
from mcmc_ammsb_tpu.ops import phi as jax_phi
from mcmc_ammsb_tpu.ops.device_sampling import sample_minibatches_device
from mcmc_ammsb_tpu.ops.edgeset import build_edge_set as jax_build_edge_set
from mcmc_ammsb_tpu.ops.window import windowed_scan as jax_windowed_scan
from mcmc_ammsb_tpu_torch import config, learner
from mcmc_ammsb_tpu_torch.interop import state_from_numpy
from mcmc_ammsb_tpu_torch.ops.edgeset import build_edge_set

from torch_parity import (assert_close, assert_normwise, jax_config,
                          jax_hoist, to_torch)

INTERVAL, EVALS, WINDOW = 10, 2, 4        # 2 windows + 2 tail steps each


@pytest.fixture(scope="module")
def slice_setup(small_dataset):
    n, split, graph = small_dataset
    cfg = config.Config(
        K=16, mini_batch_size=8, num_node_sample=8, device_sampling=True,
        shared_neighbors=True, window=WINDOW, window_impl="jnp",
        steps_per_call=INTERVAL, ppx_interval=INTERVAL).finalize(
        n, split.total_edges, graph.max_fan_out)
    return n, split, graph, cfg


def test_slice_matches_jax(slice_setup):
    """state_from_numpy -> run_hoisted -> heldout_perplexity_step against
    JAX's windowed_scan (jnp core) with its tail steps and
    heldout_perplexity_step, two 10-step intervals at window 4.

    pi, phi_sum, theta and beta agree at rtol 5e-5, atol 1e-8; ppx at
    rtol 1e-5. The state bound is loosened from rtol 1e-5: torch's and
    XLA's CPU matmuls sum in different orders, and the chain feeds those
    last-bit differences back into every later step. Measured maximum
    elementwise relative error after interval 0 / 1: theta 5.2e-6 /
    2.56e-5, beta 6.6e-7 / 1.8e-6, pi 2.0e-7 / 3.8e-7, ppx 2.0e-7 /
    1.0e-7. (The gap keeps growing with the run, as any reordering of
    float32 sums does: theta 2.4e-4 after four intervals.)"""
    _slice_matches_jax(*slice_setup)


def test_slice_matches_jax_wide_k(slice_setup):
    """test_slice_matches_jax at K = 2048, where the window kernel runs
    its wide mode on the card: the same two intervals, the port's plain
    window on the CPU against JAX's. pi, phi_sum, beta and ppx keep the
    elementwise bounds; theta is held normwise (max |diff| <= 1e-8 +
    1e-5 max |theta|, chip_smoke.py's rule), since with 4096 theta
    elements one of them comes out of the abs() of a cancellation: a
    value of ~1e-3 that differs by 1.0e-7 (1.05e-4 relative) after
    interval 0, where every other element stays inside rtol 5e-5."""
    n, split, graph, cfg = slice_setup
    _slice_matches_jax(n, split, graph, cfg.replace(K=2048),
                       theta_normwise=True)


def _slice_matches_jax(n, split, graph, cfg, theta_normwise=False):
    jcfg = jax_config(cfg)
    jtr = jax_build_edge_set(JaxEdgeSetBackend.ADJACENCY, n, graph.edges_u,
                             graph.edges_v)
    jho = jax_build_edge_set(JaxEdgeSetBackend.ADJACENCY, n,
                             split.heldout_u, split.heldout_v)
    adjacency = (jnp.asarray(graph.offsets, jnp.int32),
                 jnp.asarray(graph.cols, jnp.int32))
    hu, hv = split.heldout_edges_u, split.heldout_edges_v
    body = partial(jax_learner._hoisted_step_body, jcfg,
                   jax_phi.phi_update_core)

    @jax.jit
    def jax_interval(state, key):
        ds = sample_minibatches_device(jcfg, jtr, jho, key, INTERVAL,
                                       adjacency)
        batches = jax_learner.DeviceBatch(*ds)
        xs = jax_hoist(jcfg, jtr, state, batches)
        state = jax_windowed_scan(jcfg, state, xs, body)
        state, res = jax_learner.heldout_perplexity_step(
            jcfg, jho, jnp.asarray(hu), jnp.asarray(hv), state)
        return state, xs, res

    jstate = jax_learner.init_state(jcfg, len(hu))
    tstate = state_from_numpy(
        {f: np.asarray(v) for f, v in jstate._asdict().items()
         if v is not None}, cfg, "cpu")
    tho = build_edge_set(config.EdgeSetBackend.ADJACENCY, n,
                         split.heldout_u, split.heldout_v, "cpu")
    for i in range(EVALS):
        jstate, xs, jres = jax_interval(jstate,
                                        jax.random.PRNGKey(100 + i))
        tstate = learner.run_hoisted(cfg, tstate,
                                      to_torch(xs, learner.DeviceBatch))
        tstate, tres = learner.heldout_perplexity_step(
            cfg, tho, torch.from_numpy(hu), torch.from_numpy(hv), tstate)
        assert tstate.step_count == int(jstate.step_count)
        assert tstate.beta_count == int(jstate.beta_count)
        for f in ("pi", "phi_sum", "theta", "beta"):
            if f == "theta" and theta_normwise:
                assert_normwise(tstate.theta, jstate.theta, 1e-5, 1e-8,
                                f"interval {i}: theta")
            else:
                assert_close(getattr(tstate, f), getattr(jstate, f), 5e-5,
                             1e-8, f"interval {i}: {f}")
        assert_close(torch.exp(tres.neg_avg_log),
                     np.exp(np.asarray(jres.neg_avg_log)), 1e-5, 0.0,
                     f"interval {i}: ppx")


def test_learner_run_with_ppx_trains_on_cpu(slice_setup):
    """The port's own Learner on the CPU: device sampling, hoisting,
    windows of 4 with tail steps; the ppx series is finite and ends
    below ppx[0]."""
    n, split, graph, cfg = slice_setup
    lrn = learner.Learner(cfg.replace(steps_per_call=100), graph, split,
                          "cpu")
    p0 = lrn.heldout_perplexity()
    series = lrn.run_with_ppx(203, 50)
    assert [e["step"] for e in series] == [51, 101, 151, 201]
    assert lrn.state.step_count == 204            # 3 tail steps trained
    ppx = [e["ppx"] for e in series]
    assert np.isfinite([p0, *ppx]).all()
    assert ppx[-1] < p0


def test_train_step_device_sampled_is_one_step(slice_setup):
    """The one-step device-sampled API (the JAX package's
    train_step_device_sampled and sample_minibatch_device) on the port's
    streams: sample_minibatch_device is the S = 1 block of
    sample_minibatches_device, and train_step_device_sampled is that
    minibatch, draw_step_operands and train_step, bit for bit, from
    equal streams; three steps train the state on."""
    from mcmc_ammsb_tpu_torch import rng
    from mcmc_ammsb_tpu_torch.ops.device_sampling import (
        Adjacency, sample_minibatch_device, sample_minibatches_device)

    n, split, graph, cfg = slice_setup
    cfg = cfg.replace(window=0)
    lrn = learner.Learner(cfg, graph, split, "cpu")
    tr, ho, adj = lrn.training_set, lrn.heldout_set, lrn.adjacency
    assert isinstance(adj, Adjacency)
    one = sample_minibatch_device(cfg, tr, ho, rng.make_streams(cfg, "cpu")
                                  .sample, adj)
    block = sample_minibatches_device(cfg, tr, ho, rng.make_streams(
        cfg, "cpu").sample, 1, adj)
    for a, b in zip(one, block):
        assert torch.equal(a, b[0])
    streams_a = rng.make_streams(cfg, "cpu")
    streams_b = rng.make_streams(cfg, "cpu")
    state = lrn.state
    got = learner.train_step_device_sampled(
        cfg, tr, ho, state._replace(pi=state.pi.clone(),
                                    phi_sum=state.phi_sum.clone()), adj,
        streams_a)
    batch = learner.DeviceBatch(*sample_minibatch_device(
        cfg, tr, ho, streams_b.sample, adj))
    ops = learner.draw_step_operands(cfg, streams_b, batch)
    want = learner.train_step(cfg, tr, state._replace(
        pi=state.pi.clone(), phi_sum=state.phi_sum.clone()), batch, *ops)
    for f in ("pi", "phi_sum", "theta", "beta"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.step_count == want.step_count == 2
    for _ in range(3):
        got = learner.train_step_device_sampled(cfg, tr, ho, got, adj,
                                                streams_a)
    assert got.step_count == 5 and torch.isfinite(got.pi).all()
