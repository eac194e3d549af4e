"""The port's own flat chain engine on the CPU: FlatChainLearner trains
C distinct chains (the checks of tests/test_chains_flat.py), the windowed
engine reproduces the sequential chain scan, the batched chain step
equals C single-chain steps, and the R-hat statistic equals the JAX
package's."""

import numpy as np
import pytest
import torch

from mcmc_ammsb_tpu import chains as jax_chains
from mcmc_ammsb_tpu_torch import chains, chains_flat, config, data, learner
from mcmc_ammsb_tpu_torch.interop import chain_state_from_numpy
from mcmc_ammsb_tpu_torch.ops import phi as phi_ops


def _graph(n_nodes=300, seed=21):
    n, u, v = data.synthetic_edges(n_nodes, 8, seed=seed)
    split = data.generate_sets(n, u, v, heldout_ratio=0.1, seed=seed + 1)
    return n, split, data.Graph.from_edges(n, split.training_u,
                                           split.training_v)


def _cfg(n, split, graph, **kw):
    return config.Config(K=8, mini_batch_size=8, num_node_sample=8,
                         device_sampling=True, **kw).finalize(
        n, split.total_edges, graph.max_fan_out)


@pytest.fixture(scope="module")
def trained():
    n, split, graph = _graph()
    cfg = _cfg(n, split, graph, shared_neighbors=True, window=4,
               steps_per_call=100)
    lrn = chains_flat.FlatChainLearner(cfg, graph, split, 3, "cpu")
    p0 = lrn.heldout_perplexity()
    series = lrn.run_with_ppx(203, 50)
    return n, lrn, p0, series


def test_flat_chains_train_on_cpu(trained):
    """Every chain's ppx falls below its own ppx[0]; run_with_ppx reports
    a [C] vector at the steps a single chain reports, and trains the
    tail without an evaluation."""
    _, lrn, p0, series = trained
    assert p0.shape == (3,)
    assert [e["step"] for e in series] == [51, 101, 151, 201]
    assert lrn.state.step_count == 204
    for e in series:
        assert e["ppx"].shape == (3,) and np.isfinite(e["ppx"]).all()
    assert (series[-1]["ppx"] < p0).all()


def test_flat_chains_rows_normalized_and_distinct(trained):
    n, lrn, _, _ = trained
    pi = lrn.state.pi.reshape(3, n, -1)
    torch.testing.assert_close(pi.sum(-1), torch.ones(3, n), atol=1e-5,
                               rtol=0)
    assert not torch.allclose(pi[0], pi[1])
    assert not torch.allclose(pi[1], pi[2])
    assert not torch.allclose(lrn.state.theta[0], lrn.state.theta[1])


@pytest.mark.parametrize("window", [4, 5])
def test_windowed_chains_match_sequential(window):
    """The windowed chain engine (window kernel's plain version, tail
    steps) against the sequential chain scan on the same operands of a
    collision-heavy graph: rtol 2e-5, atol 1e-8 on pi and theta as the
    JAX package's own check (tests/test_chains_flat.py:174-189), ppx
    rtol 1e-5. 24 steps: 6 windows of 4, or 4 of 5 and 4 tail steps."""
    n, split, graph = _graph()
    cfg = _cfg(n, split, graph, shared_neighbors=True, steps_per_call=24)
    lrn = chains_flat.FlatChainLearner(cfg, graph, split, 3, "cpu")
    xs = chains_flat.hoist_chain_operands(cfg, 3, lrn.training_set,
                                          lrn.heldout_set, lrn.adjacency,
                                          lrn.streams, 24)
    copy = lrn.state._replace(pi=lrn.state.pi.clone(),
                              phi_sum=lrn.state.phi_sum.clone())
    seq = chains_flat.run_chain_hoisted(cfg, 3, lrn.state, xs)
    win = chains_flat.run_chain_hoisted(cfg.replace(window=window), 3, copy,
                                        xs)
    assert win.step_count == seq.step_count == 25
    for f in ("pi", "theta"):
        torch.testing.assert_close(getattr(win, f), getattr(seq, f),
                                   rtol=2e-5, atol=1e-8)
    ppx = [np.exp(chains_flat.chain_perplexity(
        cfg, 3, lrn.heldout_set, lrn.heldout_u, lrn.heldout_v, s)[1].numpy())
        for s in (win, seq)]
    np.testing.assert_allclose(ppx[0], ppx[1], rtol=1e-5)


@pytest.mark.parametrize("shared", [True, False])
def test_chain_step_equals_single_chain_steps(shared):
    """One batched chain step equals C single-chain steps
    (learner._hoisted_step_body) on each chain's own slice of the state
    and operands: the flat ids, the sentinel, the per-chain beta rows
    and the lane maps line up chain by chain."""
    n, split, graph = _graph()
    cfg = _cfg(n, split, graph, shared_neighbors=shared)
    lrn = chains_flat.FlatChainLearner(cfg, graph, split, 3, "cpu")
    xs = chains_flat.hoist_chain_operands(cfg, 3, lrn.training_set,
                                          lrn.heldout_set, lrn.adjacency,
                                          lrn.streams, 2)
    st = lrn.state
    singles = [learner.TrainState(
        pi=st.pi[c * n:(c + 1) * n].clone(),
        phi_sum=st.phi_sum[c * n:(c + 1) * n].clone(), theta=st.theta[c],
        beta=st.beta[c], step_count=st.step_count,
        beta_count=st.beta_count, ppx_per_edge=st.ppx_per_edge[c],
        ppx_count=0) for c in range(3)]
    for s in range(2):
        (nodes, nmask, eu, ev, emask, w, nbrs, y_n, n_phi, n_beta, y_e, _nm,
         _lu, _lv) = (a[s] for a in xs)
        b_cap = nodes.shape[-1]
        st = chains_flat._chain_step_body(cfg, 3, st, tuple(a[s] for a in xs))
        for c in range(3):
            rows = slice(c * b_cap, (c + 1) * b_cap)
            batch = learner.DeviceBatch(eu[c], ev[c], emask[c], nodes[c],
                                        nmask[c], w[c])
            x = (batch, nbrs[c][None] if shared else nbrs[rows],
                 y_n[c] if shared else y_n[rows], n_phi[rows], n_beta[c],
                 y_e[c], chains_flat._lanes(eu[c], nodes[c]),
                 chains_flat._lanes(ev[c], nodes[c]))
            singles[c] = learner._hoisted_step_body(cfg, singles[c], x)
    for c in range(3):
        sl = slice(c * n, (c + 1) * n)
        for got, want in ((st.pi[sl], singles[c].pi),
                          (st.phi_sum[sl], singles[c].phi_sum),
                          (st.theta[c], singles[c].theta),
                          (st.beta[c], singles[c].beta)):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-8)


def test_batched_shared_phi_update_equals_per_chain():
    """phi_update_core with a leading chain axis (shared draws) equals
    the per-chain calls at the ops tolerance (rtol 1e-5, atol 1e-7 as
    tests/test_torch_ops.py): the batched and the single matrix products
    sum in other orders (measured 1.4e-6 relative at most)."""
    r = np.random.default_rng(4)
    c, b, n, k = 3, 6, 5, 8
    cfg = config.Config(K=k, num_node_sample=n).finalize(50, 100, 5)
    pi_n = torch.tensor(r.dirichlet(np.ones(k), (c, b)), dtype=torch.float32)
    pi_nb = torch.tensor(r.dirichlet(np.ones(k), (c, n)), dtype=torch.float32)
    phis = torch.tensor(1 + r.random((c, b)), dtype=torch.float32)
    y = torch.tensor(r.random((c, b, n)) < 0.4)
    beta = torch.tensor(r.random((c, k)), dtype=torch.float32)
    noise = torch.tensor(r.standard_normal((c, b, k)), dtype=torch.float32)
    mask = torch.tensor(r.random((c, b, n)) < 0.9)
    rows, sums = phi_ops.phi_update_core(cfg, pi_n, phis, pi_nb[:, None], y,
                                         beta[:, None, :], 7, noise, mask)
    for i in range(c):
        r1, s1 = phi_ops.phi_update_core(cfg, pi_n[i], phis[i],
                                         pi_nb[i][None], y[i], beta[i], 7,
                                         noise[i], mask[i])
        torch.testing.assert_close(rows[i], r1, rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(sums[i], s1, rtol=1e-5, atol=1e-7)


def test_rhat_matches_jax():
    """chains.rhat == the JAX package's on the same numpy samples, and
    beta_rhat gives a finite [K] PSRF."""
    samples = np.random.default_rng(5).standard_normal((4, 6, 7))
    samples[1] += 0.5
    np.testing.assert_array_equal(chains.rhat(samples),
                                  jax_chains.rhat(samples))
    n, split, graph = _graph()
    cfg = _cfg(n, split, graph, shared_neighbors=True, window=4,
               steps_per_call=8)
    lrn = chains_flat.FlatChainLearner(cfg, graph, split, 2, "cpu")
    r = lrn.beta_rhat(2)
    assert r.shape == (8,) and np.isfinite(r).all()


def test_chain_state_from_numpy_checks_the_chain_count():
    n, split, graph = _graph()
    cfg = _cfg(n, split, graph, shared_neighbors=True)
    st = chains_flat.init_chain_state(cfg, 2, 5, "cpu")
    arrays = {f: np.asarray(v) if isinstance(v, int) else v.numpy()
              for f, v in st._asdict().items()}
    back = chain_state_from_numpy(arrays, cfg, 2, "cpu")
    assert torch.equal(back.pi, st.pi) and back.theta.shape == (2, 8, 2)
    with pytest.raises(ValueError, match="3 chain"):
        chain_state_from_numpy(arrays, cfg, 3, "cpu")


@pytest.mark.parametrize("bad", [
    dict(window=4, shared_neighbors=False),
    dict(phi_impl=config.PhiImpl.PALLAS),
    dict(rng_backend=config.RngBackend.REFERENCE),
])
def test_flat_chain_guards_raise(bad):
    """The JAX FlatChainLearner's guards (chains_flat.py:486-501)."""
    n, split, graph = _graph()
    cfg = _cfg(n, split, graph, **{"shared_neighbors": False, **bad})
    with pytest.raises(ValueError):
        chains_flat.FlatChainLearner(cfg, graph, split, 2, "cpu")
