"""The host-sampled training path against the JAX package's.

Both packages get the same host minibatches (the port's numpy sampler)
and the same membership table, and the port is handed the JAX package's
own per-step neighbor draws and noise (torch_parity.jax_hoist recomputes
them from its keys, which is what its train_step draws: JAX keys every
draw by the step). One ``train_step`` per step against JAX's, a scanned
chunk against ``train_steps_scan``; then what holds between the port's
own step-at-a-time and scanned runs, the row scatter on an all-masked
batch through each of its callers, and the window bookkeeping when
masked lanes hold id 0.

State tolerance: normwise rtol 5e-5, atol 1e-8 (tests/test_torch_slice.py
gives the reason: torch's and XLA's CPU matmuls sum in different orders
and the chain feeds the last-bit differences back); ppx rtol 1e-5.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_ammsb_tpu import learner as jax_learner
from mcmc_ammsb_tpu.config import EdgeSetBackend as JaxEdgeSetBackend
from mcmc_ammsb_tpu.ops import window as jax_window
from mcmc_ammsb_tpu.ops.edgeset import build_edge_set as jax_build_edge_set
from mcmc_ammsb_tpu_torch import chains_flat, config, learner, testing
from mcmc_ammsb_tpu_torch.interop import edge_set_from_numpy, state_from_numpy
from mcmc_ammsb_tpu_torch.models import mmsb
from mcmc_ammsb_tpu_torch.ops import window
from mcmc_ammsb_tpu_torch.sampling import MiniBatchSampler, StackedBatches

from torch_parity import (assert_close, assert_normwise, jax_config,
                          jax_hoist, to_torch)

STATE = ("pi", "phi_sum", "theta", "beta")
STEPS = 10


def _setup(small_dataset, backend="adjacency", **kw):
    """Config, the JAX edge sets, the port's edge sets over the same
    tables, both packages' equal initial states and the held-out arrays."""
    n, split, graph = small_dataset
    cfg = config.Config(
        **{**dict(K=16, mini_batch_size=8, num_node_sample=8,
                  device_sampling=False, shared_neighbors=False,
                  host_sampler="numpy", steps_per_call=1), **kw}).finalize(
        n, split.total_edges, graph.max_fan_out)
    jcfg = jax_config(cfg)
    jsets = [jax_build_edge_set(JaxEdgeSetBackend(backend), n, eu, ev)
             for eu, ev in ((graph.edges_u, graph.edges_v),
                            (split.heldout_u, split.heldout_v))]
    tsets = [edge_set_from_numpy(s.backend, s.meta,
                                 [np.asarray(a) for a in s.arrays], n,
                                 s.num_search_steps) for s in jsets]
    hu, hv = split.heldout_edges_u, split.heldout_edges_v
    jstate = jax_learner.init_state(jcfg, len(hu))
    tstate = state_from_numpy(
        {f: np.asarray(v) for f, v in jstate._asdict().items()
         if v is not None}, cfg, "cpu")
    return cfg, jcfg, jsets, tsets, jstate, tstate, (hu, hv)


def _batches(cfg, small_dataset, count, seed=0):
    _, split, graph = small_dataset
    return MiniBatchSampler(cfg, graph, split, seed=seed).sample_many(count)


def _compare(tstate, jstate, what):
    assert tstate.step_count == int(jstate.step_count)
    assert tstate.beta_count == int(jstate.beta_count)
    for f in STATE:
        assert_normwise(getattr(tstate, f), getattr(jstate, f), 5e-5, 1e-8,
                        f"{what}: {f}")


def _compare_ppx(cfg, jcfg, jsets, tsets, jstate, tstate, held, what):
    hu, hv = held
    jstate, jres = jax_learner.heldout_perplexity_step(
        jcfg, jsets[1], jnp.asarray(hu), jnp.asarray(hv), jstate)
    tstate, tres = learner.heldout_perplexity_step(
        cfg, tsets[1], torch.from_numpy(hu), torch.from_numpy(hv), tstate)
    assert_close(torch.exp(tres.neg_avg_log),
                 np.exp(np.asarray(jres.neg_avg_log)), 1e-5, 0.0,
                 f"{what}: ppx")
    return jstate, tstate


@pytest.mark.parametrize("variant", ["jnp-adjacency", "jnp-perfect",
                                     "pallas", "shared"])
def test_train_step_matches_jax(small_dataset, variant):
    """One train_step per step for 10 steps, host batches whose padded
    lanes hold id 0: private draws with the jnp phi on two membership
    backends; JAX's phi_update_rows_pallas (the Pallas kernel in interpret
    mode, K = 128) against the port's plain pre-gathered version; and one
    shared draw per step."""
    kw = {"pallas": dict(K=128, phi_impl=config.PhiImpl.PALLAS),
          "shared": dict(shared_neighbors=True)}.get(variant, {})
    backend = "perfect" if variant == "jnp-perfect" else "adjacency"
    cfg, jcfg, jsets, tsets, jstate, tstate, held = _setup(
        small_dataset, backend, **kw)
    stacked = _batches(cfg, small_dataset, STEPS)
    assert not stacked.node_mask.all() and not stacked.nodes[
        ~stacked.node_mask].any()
    jbatches = jax_learner.DeviceBatch.from_stacked(stacked)
    tbatches = learner.DeviceBatch.from_stacked(stacked, "cpu")
    xs = to_torch(jax_hoist(jcfg, jsets[0], jstate, jbatches),
                  learner.DeviceBatch)
    jstep = jax.jit(partial(jax_learner.train_step, jcfg))
    for i in range(STEPS):
        jstate = jstep(jsets[0], jstate,
                       jax_learner.DeviceBatch(*(a[i] for a in jbatches)))
        tstate = learner.train_step(
            cfg, tsets[0], tstate,
            learner.DeviceBatch(*(a[i] for a in tbatches)), xs[1][i],
            xs[3][i], xs[4][i])
    _compare(tstate, jstate, variant)
    _compare_ppx(cfg, jcfg, jsets, tsets, jstate, tstate, held, variant)


@pytest.mark.parametrize("variant", ["private", "pallas", "shared-window"])
def test_scanned_chunk_matches_jax(small_dataset, variant):
    """Two scanned chunks of 10 host-sampled steps against JAX's
    train_steps_scan, with an evaluation after each: private draws, the
    by-index plain phi entry against JAX's Pallas core in interpret mode
    (K = 128; two chunks of 5 steps, as tests/test_torch_phi_pallas.py
    runs that kernel: its other order of sums drifts past the bound on
    theta within 12 steps), and shared draws in windows of 4 with tail
    steps. The sampler's seed matters to the Pallas variant only: at seed
    1 a batch hits a cancellation on which the JAX package's own jnp and
    Pallas cores differ by 3.4e-4 on theta after 5 steps (the port then
    sits 3.3e-5 from the jnp core)."""
    steps = 5 if variant == "pallas" else STEPS
    kw = {"pallas": dict(K=128, phi_impl=config.PhiImpl.PALLAS),
          "shared-window": dict(shared_neighbors=True, window=4,
                                window_impl="jnp")}.get(variant, {})
    cfg, jcfg, jsets, tsets, jstate, tstate, held = _setup(
        small_dataset, steps_per_call=steps, **kw)
    jscan = jax.jit(partial(jax_learner.train_steps_scan, jcfg))
    _, split, graph = small_dataset
    sampler = MiniBatchSampler(cfg, graph, split, seed=0)
    for chunk in range(2):
        stacked = sampler.sample_many(steps)
        jbatches = jax_learner.DeviceBatch.from_stacked(stacked)
        xs = to_torch(jax_hoist(jcfg, jsets[0], jstate, jbatches),
                      learner.DeviceBatch)
        jstate = jscan(jsets[0], jstate, jbatches)
        tstate = learner.run_hoisted(cfg, tstate, xs)
        _compare(tstate, jstate, f"{variant} chunk {chunk}")
        jstate, tstate = _compare_ppx(cfg, jcfg, jsets, tsets, jstate,
                                      tstate, held,
                                      f"{variant} chunk {chunk}")


def test_from_stacked_and_from_host_round_trip(small_dataset):
    """One packed copy: every field comes back with its dtype, shape and
    values, as contiguous tensors; from_host is one step of it."""
    cfg = _setup(small_dataset)[0]
    stacked = _batches(cfg, small_dataset, 4)
    dev = learner.DeviceBatch.from_stacked(stacked, "cpu")
    for f in learner.DeviceBatch._fields:
        want = getattr(stacked, f)
        got = getattr(dev, f)
        assert got.is_contiguous() and tuple(got.shape) == want.shape
        assert got.numpy().dtype == want.dtype, f
        np.testing.assert_array_equal(got.numpy(), want)
    _, split, graph = small_dataset
    one = MiniBatchSampler(cfg, graph, split, seed=0).sample()
    got = learner.DeviceBatch.from_host(one, "cpu")
    for f in learner.DeviceBatch._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(stacked, f)[0])


# ---------------------------------------------------------------------------
# What holds between the port's step-at-a-time and scanned runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("phi_impl", ["jnp", "pallas"])
def test_train_step_equals_hoisted_step_on_the_same_operands(phi_impl):
    """Given the same operands, 6 train_steps (gather from pi, membership
    and labels queried per step, endpoint rows re-read from the new pi)
    and one hoisted chunk (labels hoisted, endpoint rows from the staged
    rows, the by-index phi entry) give the same bits on the CPU."""
    case = testing.host_case(5, 6, phi_impl=config.PhiImpl(phi_impl))
    cfg = case["cfg"]
    lrn = learner.Learner(cfg, case["graph"], case["split"], "cpu")
    batches = learner.DeviceBatch.from_stacked(case["stacked"], "cpu")
    xs = learner.hoist_operands(cfg, lrn.training_set, batches, lrn.streams)
    single = lrn.state._replace(pi=lrn.state.pi.clone(),
                                phi_sum=lrn.state.phi_sum.clone())
    for i in range(6):
        single = learner.train_step(
            cfg, lrn.training_set, single,
            learner.DeviceBatch(*(a[i] for a in batches)), xs[1][i],
            xs[3][i], xs[4][i])
    scanned = learner.run_hoisted(cfg, lrn.state, xs)
    for f in STATE:
        assert torch.equal(getattr(single, f), getattr(scanned, f)), f
    assert single.step_count == scanned.step_count == 7


@pytest.mark.parametrize("prefetch", [False, True])
def test_run_single_equals_one_step_chunks(prefetch):
    """The stream position (see learner.py): a step-at-a-time run,
    prefetched or not, equals a scanned run whose chunks are one step
    long, bit for bit. A chunk of 6 steps consumes the same host batches (the numpy
    sampler's stream ends in the same state) but draws its neighbors and
    noise in one block per stream: other bits from the same seeds, and a
    state that is close, not equal."""
    case = testing.host_case(6, 1, steps_per_call=1)
    args = (case["graph"], case["split"], "cpu")

    def run(spc, scanned):
        # a prefetcher of chunk 1 hands out single batches: the one-step
        # chunks sample unprefetched
        lrn = learner.Learner(case["cfg"].replace(steps_per_call=spc), *args,
                              prefetch=prefetch and not (scanned and spc == 1))
        if scanned:
            lrn._run_scanned(6, spc)
        else:
            lrn.run(6)
        lrn.drain_sampling()
        lrn.close()
        return lrn

    single, chunks1, chunk6 = run(1, False), run(1, True), run(6, True)
    for f in STATE:
        assert torch.equal(getattr(single.state, f),
                           getattr(chunks1.state, f)), f
        assert torch.isfinite(getattr(chunk6.state, f)).all()
    assert not torch.equal(single.state.theta, chunk6.state.theta)
    assert single.state.step_count == chunk6.state.step_count == 7
    if not prefetch:
        a, b = (l.sampler.rng.get_state()[1] for l in (single, chunk6))
        np.testing.assert_array_equal(a, b)


def test_host_learner_trains_and_drains():
    """Learner.run on host batches, scanned with a sliced tail chunk and
    step at a time: ppx falls; run_with_ppx raises with JAX's words;
    drain_sampling hands back the prefetched chunks and a later run
    consumes them first."""
    case = testing.host_case(7, 1, num_nodes=400, avg_degree=12,
                             steps_per_call=25)
    lrn = learner.Learner(case["cfg"], case["graph"], case["split"], "cpu")
    p0 = lrn.heldout_perplexity()
    lrn.run(60)                              # 25 + 25 + a tail of 10
    assert lrn.state.step_count == 61
    assert lrn.heldout_perplexity() < p0
    with pytest.raises(RuntimeError, match="requires device_sampling"):
        lrn.run_with_ppx(20, 10)
    pending = lrn.drain_sampling()
    assert pending and all(isinstance(p, StackedBatches) for p in pending)
    first = pending[0].nodes.copy()
    assert lrn._prefetcher is None
    lrn._use_prefetch = False
    seen = []
    real = learner.DeviceBatch.from_stacked
    try:
        learner.DeviceBatch.from_stacked = classmethod(
            lambda cls, s, dev: seen.append(s.nodes) or real(s, dev))
        lrn.run(25)
    finally:
        learner.DeviceBatch.from_stacked = real
    np.testing.assert_array_equal(seen[0], first)
    lrn.close()
    one = learner.Learner(case["cfg"].replace(steps_per_call=1),
                          case["graph"], case["split"], "cpu")
    p0 = one.heldout_perplexity()
    one.run(40)
    assert one.heldout_perplexity() < p0
    one.close()
    assert not one._pending and one._prefetcher is None


# ---------------------------------------------------------------------------
# Repairs: the all-masked scatter, masked lanes that hold id 0
# ---------------------------------------------------------------------------

def _mask_all(batch, pad):
    return batch._replace(node_mask=torch.zeros_like(batch.node_mask),
                          edge_mask=torch.zeros_like(batch.edge_mask),
                          nodes=torch.full_like(batch.nodes, pad))


@pytest.mark.parametrize("pad", ["sentinel", "zero"])
@pytest.mark.parametrize("caller", ["learner", "chains_flat", "mmsb",
                                    "window"])
def test_all_masked_batch_leaves_pi_unchanged(caller, pad):
    """scatter_rows with every lane masked (ids all N, or all 0) writes
    nothing: pi and phi_sum stay bit-unchanged through the sequential
    step, the chain step, the MMSB step and the windowed plain path. (The
    tiny shape of the queue-3 fault, N=10 K=4 B=5, is the first line.)"""
    from mcmc_ammsb_tpu_torch.ops import phi as phi_ops

    pi = torch.rand(10, 4)
    sums = torch.rand(10)
    out = phi_ops.scatter_rows(pi.clone(), sums.clone(),
                               torch.full((5,), 10 if pad == "sentinel"
                                          else 0, dtype=torch.int32),
                               torch.zeros(5, dtype=torch.bool),
                               torch.rand(5, 4), torch.rand(5))
    assert torch.equal(out[0], pi) and torch.equal(out[1], sums)

    if caller == "chains_flat":
        case = testing.chain_window_case(0, 3, 2, 6, 5, 4, 8)
        cfg = testing.chain_window_case_config(case)
        state, xs = testing.chain_window_case_torch(case, "cpu")
        x = [a[0] for a in xs]
        fill = cfg.N if pad == "sentinel" else 0
        x[0] = torch.full_like(x[0], fill)                  # nodes
        x[1] = torch.zeros_like(x[1])                       # node_mask
        x[4] = torch.zeros_like(x[4])                       # edge_mask
        before = state.pi.clone(), state.phi_sum.clone()
        after = chains_flat._chain_step_body(cfg, 3, state, tuple(x))
    else:
        make, to_torch_case = {
            "mmsb": (testing.mmsb_window_case,
                     testing.mmsb_window_case_torch)}.get(
            caller, (testing.window_case, testing.window_case_torch))
        case = make(0, 2, 6, 5, 4, 8)
        cfg = testing.window_case_config(case)
        state, xs = to_torch_case(case, "cpu")
        xs = (_mask_all(xs[0], cfg.N if pad == "sentinel" else 0), *xs[1:])
        before = state.pi.clone(), state.phi_sum.clone()
        if caller == "learner":
            after = learner._hoisted_step_body(
                cfg.replace(window=0), state, window.index_operands(xs, 0))
        elif caller == "mmsb":
            after = mmsb._mmsb_step_body(cfg, state,
                                         window.index_operands(xs, 0))
        else:
            nbrs = xs[1][:, 0, :]
            mcode = window._correction_codes(cfg, xs[0].nodes,
                                             xs[0].node_mask, nbrs)
            keep = window._last_write_wins(xs[0].nodes, xs[0].node_mask, 2)
            assert not keep.any() and not mcode.any()
            after = window.window_apply_torch(cfg, state, xs, mcode, keep)
    assert torch.equal(after.pi, before[0])
    assert torch.equal(after.phi_sum, before[1])
    assert after.step_count > state.step_count or caller == "window"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_window_codes_with_zero_padded_lanes_match_jax(seed):
    """A window of host batches: masked node lanes hold id 0. keep and
    mcode equal the JAX package's exactly, and a masked lane never counts
    as a write of row 0 — while a real write of row 0 by an earlier step
    redirects the later reads of row 0."""
    t_win, b_cap, n_smpl = 5, 7, 6
    case = testing.window_case(seed, t_win, b_cap, n_smpl, 4, 8)
    nodes, mask = case["nodes"].copy(), case["node_mask"]
    nodes[~mask] = 0
    nodes[0, 0] = 0                 # step 0 really writes row 0 ...
    dup = nodes[0, 1:] == 0
    nodes[0, 1:][dup] = case["n_nodes"] - 1
    nbrs = case["neighbors"][:, 0, :].copy()
    nbrs[2, 0] = 0                  # ... and step 2 reads it
    cfg = testing.window_case_config(case)
    jcfg = jax_config(cfg)
    t = torch.from_numpy
    mcode = window._correction_codes(cfg, t(nodes), t(mask), t(nbrs))
    keep = window._last_write_wins(t(nodes), t(mask), t_win)
    jm = jax_window._correction_codes(jcfg, jnp.asarray(nodes),
                                      jnp.asarray(mask), jnp.asarray(nbrs))
    jk = jax_window._last_write_wins(jnp.asarray(nodes), jnp.asarray(mask),
                                     t_win)
    np.testing.assert_array_equal(mcode.numpy(), np.asarray(jm)[..., 0])
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jk))
    assert not keep[t(~mask)].any()
    assert mcode[2, b_cap] == 1     # slot 0 = (step 0, lane 0), plus one
    # had masked lanes counted as writes of row 0, the code would point
    # at the latest masked lane before step 2 instead
    masked_before = [(s, l) for s in range(2) for l in range(b_cap)
                     if not mask[s, l]]
    if masked_before:
        assert max(s * b_cap + l for s, l in masked_before) + 1 != 1
