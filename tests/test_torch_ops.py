"""The port's step math (mcmc_ammsb_tpu_torch/ops) against the JAX
package's ops on the same seeded numpy arrays. Tolerance rtol 1e-5,
atol 1e-7 unless a test says otherwise; the row scatter is exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_ammsb_tpu import config as jax_config_mod
from mcmc_ammsb_tpu.ops import beta as jax_beta
from mcmc_ammsb_tpu.ops import perplexity as jax_ppx
from mcmc_ammsb_tpu.ops import phi as jax_phi
from mcmc_ammsb_tpu.ops import rowops as jax_rowops
from mcmc_ammsb_tpu.ops.edgeset import build_edge_set as jax_build_edge_set
from mcmc_ammsb_tpu_torch import config
from mcmc_ammsb_tpu_torch.ops import beta, perplexity, phi, rowops
from mcmc_ammsb_tpu_torch.ops.edgeset import build_edge_set

from torch_parity import assert_close, jax_config

RTOL, ATOL = 1e-5, 1e-7
N, K, B, NS, E = 100, 16, 9, 8, 12


@pytest.fixture(scope="module")
def cfg():
    return config.Config(K=K, mini_batch_size=B - 1,
                         num_node_sample=NS).finalize(N, 400, 10)


def _pi(r, rows, k=K):
    pi = r.gamma(1.0, size=(rows, k)).astype(np.float32)
    return pi / pi.sum(-1, keepdims=True)


def test_config_matches_jax_package():
    """The copied Config has the JAX Config's fields and defaults."""
    mine = {f.name: f.default for f in dataclasses.fields(config.Config)}
    ref = {f.name: f.default
           for f in dataclasses.fields(jax_config_mod.Config)}
    assert mine.keys() == ref.keys()
    for name, default in ref.items():
        got = mine[name]
        if hasattr(default, "value"):            # enums: compare values
            got, default = got.value, default.value
        assert got == default, name


def test_row_normalize():
    x = np.random.default_rng(0).random((7, K), np.float32) + 0.1
    rows, sums = rowops.row_normalize(torch.from_numpy(x))
    jrows, jsums = jax_rowops.row_normalize(jnp.asarray(x))
    assert_close(rows, jrows, RTOL, ATOL)
    assert_close(sums, jsums, RTOL, ATOL)


@pytest.mark.parametrize("cols", [1, 2, 5, 16, 33, 127, 128, 200])
def test_row_sums_and_sort(cols):
    """row_sums and row_sort against the JAX package's on ragged row
    lengths (tests/test_ops.py::test_rowops, test_row_sort)."""
    x = np.random.RandomState(cols).rand(7, cols).astype(np.float32) + 0.1
    assert_close(rowops.row_sums(torch.from_numpy(x)),
                 jax_rowops.row_sums(jnp.asarray(x)), RTOL, ATOL)
    np.testing.assert_array_equal(rowops.row_sort(torch.from_numpy(x)),
                                  np.asarray(jax_rowops.row_sort(
                                      jnp.asarray(x))))


def test_slice_normalize():
    """slice_normalize (theta pairs into beta) against the JAX
    package's."""
    flat = np.random.RandomState(1).rand(12).astype(np.float32) + 0.1
    for size in (2, 3):
        assert_close(rowops.slice_normalize(torch.from_numpy(flat), size),
                     jax_rowops.slice_normalize(jnp.asarray(flat), size),
                     RTOL, ATOL)


@pytest.mark.parametrize("form", ["shared_nbr_mask", "private"])
def test_phi_update_core(cfg, form):
    """phi_update_core, shared neighbor rows with the self-collision
    mask and private per-node rows."""
    r = np.random.default_rng(1)
    pi_n = _pi(r, B)
    phis = (1.0 + K * r.random(B)).astype(np.float32)
    nb_rows = 1 if form.startswith("shared") else B
    pi_nb = _pi(r, nb_rows * NS).reshape(nb_rows, NS, K)
    y = r.random((B, NS)) < 0.3
    beta_v = r.uniform(0.1, 0.9, K).astype(np.float32)
    noise = r.standard_normal((B, K)).astype(np.float32)
    mask = r.random((B, NS)) > 0.1 if form.startswith("shared") else None
    step = 37
    got = phi.phi_update_core(
        cfg, *(torch.from_numpy(a) for a in (pi_n, phis, pi_nb, y, beta_v)),
        step, torch.from_numpy(noise),
        None if mask is None else torch.from_numpy(mask))
    want = jax_phi.phi_update_core(
        jax_config(cfg), *(jnp.asarray(a) for a in (pi_n, phis, pi_nb, y,
                                                      beta_v)),
        jnp.asarray(step, jnp.int32), jnp.asarray(noise),
        None if mask is None else jnp.asarray(mask))
    assert_close(got[0], want[0], RTOL, ATOL, "rows")
    assert_close(got[1], want[1], RTOL, ATOL, "sums")


def test_scatter_rows_exact():
    """Masked lanes (sentinel N) are dropped; the kept rows land exactly
    where the JAX scatter puts them."""
    r = np.random.default_rng(2)
    pi = _pi(r, N)
    phi_sum = r.random(N).astype(np.float32)
    nodes = r.choice(N, B, replace=False).astype(np.int32)
    mask = np.ones(B, bool)
    mask[[2, 5, 8]] = False
    nodes[~mask] = N
    rows = r.random((B, K), np.float32)
    sums = r.random(B).astype(np.float32)
    got = phi.scatter_rows(torch.from_numpy(pi.copy()),
                           torch.from_numpy(phi_sum.copy()),
                           *(torch.from_numpy(a) for a in (nodes, mask, rows,
                                                           sums)))
    want = jax_phi.scatter_rows(*(jnp.asarray(a) for a in (
        pi, phi_sum, nodes, mask, rows, sums)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_beta_gradients_and_theta_step(cfg):
    r = np.random.default_rng(3)
    theta = (r.gamma(1.0, size=(K, 2)) + 0.5).astype(np.float32)
    beta_v = theta[:, 1] / theta.sum(-1)
    pi_u, pi_v = _pi(r, E), _pi(r, E)
    y = r.random(E) < 0.5
    emask = r.random(E) > 0.2
    grads = beta.beta_gradients_core(
        cfg, *(torch.from_numpy(a) for a in (theta, beta_v, pi_u, pi_v, y,
                                             emask)))
    jgrads = jax_beta.beta_gradients_core(
        jax_config(cfg), *(jnp.asarray(a) for a in (theta, beta_v, pi_u,
                                                    pi_v, y, emask)))
    assert_close(grads, jgrads, RTOL, ATOL, "grads")

    noise = r.standard_normal((K, 2)).astype(np.float32)
    scale = np.float32(N * 3.5)
    got = beta.theta_step(cfg, torch.from_numpy(theta), grads,
                          torch.tensor(scale), 11, torch.from_numpy(noise))
    want = jax_beta.theta_step(jax_config(cfg), jnp.asarray(theta), jgrads,
                               jnp.asarray(scale), jnp.asarray(11, jnp.int32),
                               jnp.asarray(noise))
    assert_close(got[0], want[0], RTOL, ATOL, "theta")
    assert_close(got[1], want[1], RTOL, ATOL, "beta")


def test_perplexity_step(cfg, small_dataset):
    """Two successive calls (the running average) on the conftest
    graph's held-out population, labels from the adjacency edge set."""
    n, split, _ = small_dataset
    r = np.random.default_rng(4)
    pi = _pi(r, n)
    beta_v = r.uniform(0.05, 0.95, K).astype(np.float32)
    hu, hv = split.heldout_edges_u, split.heldout_edges_v
    ho = build_edge_set(config.EdgeSetBackend.ADJACENCY, n, split.heldout_u,
                        split.heldout_v, "cpu")
    jho = jax_build_edge_set(jax_config_mod.EdgeSetBackend.ADJACENCY, n,
                             split.heldout_u, split.heldout_v)
    jcfg = jax_config(cfg)
    avg = np.zeros(len(hu), np.float32)
    javg = jnp.asarray(avg)
    tavg = torch.from_numpy(avg)
    for count in (1, 2):
        res = perplexity.perplexity_step(
            cfg, torch.from_numpy(pi), torch.from_numpy(beta_v), ho,
            torch.from_numpy(hu), torch.from_numpy(hv), tavg, count)
        jres = jax_ppx.perplexity_step(
            jcfg, jnp.asarray(pi), jnp.asarray(beta_v), jho,
            jnp.asarray(hu), jnp.asarray(hv), javg,
            jnp.asarray(count, jnp.int32))
        for a, b in zip(res, jres):
            assert_close(a, b, RTOL, ATOL)
        tavg, javg = res.ppx_per_edge, jres.ppx_per_edge
        pi = _pi(r, n)


def _unblocked(monkeypatch):
    """Every evaluation in one block (the unblocked gather)."""
    monkeypatch.setattr(perplexity, "EVAL_BLOCK_BYTES", 1 << 62)


@pytest.mark.parametrize("rows", [1, 7, 64])
def test_blocked_heldout_perplexity_matches_unblocked(cfg, small_dataset,
                                                      monkeypatch, rows):
    """perplexity_step in blocks of ``rows`` pairs (EVAL_BLOCK_BYTES set
    to ``rows`` float32 rows of K) against the unblocked path on the same
    inputs, two successive calls: the scalar, the link and non-link sums
    and each pair's running average within rtol 2e-5 (the float32 reorder
    tolerance), the counts exact."""
    n, split, _ = small_dataset
    r = np.random.default_rng(11)
    pi = torch.from_numpy(_pi(r, n))
    beta_v = torch.from_numpy(r.uniform(0.05, 0.95, K).astype(np.float32))
    hu = torch.from_numpy(split.heldout_edges_u)
    hv = torch.from_numpy(split.heldout_edges_v)
    ho = build_edge_set(config.EdgeSetBackend.ADJACENCY, n, split.heldout_u,
                        split.heldout_v, "cpu")
    assert perplexity.eval_block_rows(K) > len(hu)
    avg = {b: torch.zeros(len(hu)) for b in ("blocked", "unblocked")}
    for count in (1, 2):
        res = {}
        for kind in avg:
            if kind == "unblocked":
                _unblocked(monkeypatch)
            else:
                monkeypatch.setattr(perplexity, "EVAL_BLOCK_BYTES",
                                    rows * 4 * K)
                assert perplexity.eval_block_rows(K) == rows
            res[kind] = perplexity.perplexity_step(
                cfg, pi, beta_v, ho, hu, hv, avg[kind], count)
            avg[kind] = res[kind].ppx_per_edge
        for a, b in zip(res["blocked"], res["unblocked"]):
            torch.testing.assert_close(a, b, rtol=2e-5, atol=0.0)
        pi = torch.from_numpy(_pi(r, n))


@pytest.mark.parametrize("rows", [1, 5, 33])
def test_blocked_training_perplexity_matches_unblocked(small_dataset,
                                                       monkeypatch, rows):
    """learner.training_perplexity_step over its population in blocks of
    ``rows`` pairs against the unblocked path: -mean log and the running
    averages within rtol 2e-5 over three calls."""
    from mcmc_ammsb_tpu_torch import data, learner

    n, split, graph = small_dataset
    tu, tv = (torch.from_numpy(a)
              for a in data.make_training_ppx_edges(split, 0.05))
    lcfg = config.Config(K=K, mini_batch_size=8, num_node_sample=8,
                         calc_train_ppx=True, training_ppx_ratio=0.05
                         ).finalize(n, split.total_edges, graph.max_fan_out)
    tset = build_edge_set(config.EdgeSetBackend.ADJACENCY, n, graph.edges_u,
                          graph.edges_v, "cpu")
    state = learner.init_state(lcfg, 0, "cpu", train_ppx_size=len(tu))
    states = {"blocked": state, "unblocked": state}
    r = np.random.default_rng(12)
    for _ in range(3):
        res = {}
        for kind, st in states.items():
            monkeypatch.setattr(perplexity, "EVAL_BLOCK_BYTES",
                                rows * 4 * K if kind == "blocked"
                                else 1 << 62)
            states[kind], res[kind] = learner.training_perplexity_step(
                lcfg, tset, tu, tv, st)
        torch.testing.assert_close(res["blocked"].neg_avg_log,
                                   res["unblocked"].neg_avg_log,
                                   rtol=2e-5, atol=0.0)
        torch.testing.assert_close(states["blocked"].train_ppx_per_edge,
                                   states["unblocked"].train_ppx_per_edge,
                                   rtol=2e-5, atol=0.0)
        pi = torch.from_numpy(_pi(r, n))
        states = {k: s._replace(pi=pi) for k, s in states.items()}


@pytest.mark.parametrize("rows", [1, 6, 40])
def test_blocked_chain_perplexity_matches_unblocked(monkeypatch, rows):
    """chains_flat.chain_perplexity over C = 3 chains in blocks of
    ``rows`` pairs (a block holds [C, rows, K]) against the unblocked
    gather: the [C] scalars and the [C, H] running averages within rtol
    2e-5 over two calls."""
    from mcmc_ammsb_tpu_torch import chains_flat, data

    n, u, v = data.synthetic_edges(num_nodes=300, avg_degree=8, seed=2)
    split = data.generate_sets(n, u, v, heldout_ratio=0.2, seed=3)
    graph = data.Graph.from_edges(n, split.training_u, split.training_v)
    ccfg = config.Config(K=K, mini_batch_size=8, num_node_sample=8
                         ).finalize(n, split.total_edges, graph.max_fan_out)
    lrn = chains_flat.FlatChainLearner(ccfg, graph, split, 3, "cpu")
    assert lrn.heldout_u.shape[0] > rows
    states = {"blocked": lrn.state, "unblocked": lrn.state}
    for _ in range(2):
        out = {}
        for kind, st in states.items():
            monkeypatch.setattr(perplexity, "EVAL_BLOCK_BYTES",
                                rows * 4 * K * 3 if kind == "blocked"
                                else 1 << 62)
            states[kind], out[kind] = chains_flat.chain_perplexity(
                ccfg, 3, lrn.heldout_set, lrn.heldout_u, lrn.heldout_v, st)
        torch.testing.assert_close(out["blocked"], out["unblocked"],
                                   rtol=2e-5, atol=0.0)
        torch.testing.assert_close(states["blocked"].ppx_per_edge,
                                   states["unblocked"].ppx_per_edge,
                                   rtol=2e-5, atol=0.0)
        pi = lrn.state.pi.flip(0).contiguous()
        states = {k: s._replace(pi=pi) for k, s in states.items()}
