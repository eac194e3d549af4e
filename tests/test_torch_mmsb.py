"""The port's full MMSB (mcmc_ammsb_tpu_torch/models/mmsb.py,
ops/window_mmsb.py) against the JAX package's (mcmc_ammsb_tpu/models/
mmsb.py, ops/window_mmsb.py) on the same seeded operands: the step math,
the plain window core against the Pallas window kernel in interpret
mode, the fused window's plain version (gather, core, scatter) against
JAX's three, the kernel's cluster-size rule, a windowed trajectory with
its ppx series, and the learner on a planted partition. The CUDA kernel
itself is checked against the plain version on the card by
chip_smoke.py."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_ammsb_tpu.config import EdgeSetBackend as JaxEdgeSetBackend
from mcmc_ammsb_tpu.learner import DeviceBatch as JaxDeviceBatch
from mcmc_ammsb_tpu.models import mmsb as jax_mmsb
from mcmc_ammsb_tpu.ops import window as jax_window
from mcmc_ammsb_tpu.ops import window_mmsb as jax_window_mmsb
from mcmc_ammsb_tpu.ops.device_sampling import sample_minibatches_device
from mcmc_ammsb_tpu.ops.edgeset import build_edge_set as jax_build_edge_set
from mcmc_ammsb_tpu.ops.neighbor import sample_neighbors as jax_neighbors
from mcmc_ammsb_tpu.rng import native as jax_rng
from mcmc_ammsb_tpu_torch import config, data, learner, testing
from mcmc_ammsb_tpu_torch.interop import mmsb_state_from_numpy
from mcmc_ammsb_tpu_torch.models import mmsb
from mcmc_ammsb_tpu_torch.ops import window, window_mmsb
from mcmc_ammsb_tpu_torch.ops.edgeset import build_edge_set

from torch_parity import assert_close, jax_config, to_torch

RTOL, ATOL = 1e-5, 1e-7
# the measured multi-step envelope of tests/test_window_mmsb.py:57-59
PI_ATOL = 5e-3
TH_TOLS = dict(rtol=0.1, atol=0.15)
B_TOLS = dict(rtol=0.1, atol=0.05)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.fixture(scope="module")
def ops_case():
    """Seeded operands of one step at K=6, B=7, n=5, E=9."""
    r = np.random.default_rng(11)
    k, b, n, e = 6, 7, 5, 9
    f32 = np.float32

    def rows(*shape):
        g = r.gamma(1.0, size=(*shape, k)).astype(f32)
        return g / g.sum(-1, keepdims=True)

    theta = (r.gamma(1.0, size=(k, k, 2)) + 0.05).astype(f32)
    theta = f32(0.5) * (theta + theta.transpose(1, 0, 2))
    cfg = config.Config(K=k, num_node_sample=n).finalize(500, 1000, 10)
    return cfg, dict(
        pi_n=rows(b), phis=(1 + k * r.random(b)).astype(f32),
        pi_nb=rows(b, n), pi_nb_shared=rows(n), y=r.random((b, n)) < 0.3,
        mask=r.random((b, n)) < 0.9, noise=r.standard_normal((b, k)).astype(f32),
        theta=theta, b=theta[..., 1] / theta.sum(-1), pi_u=rows(e),
        pi_v=rows(e), y_e=r.random(e) < 0.5, e_mask=r.random(e) < 0.8,
        t_noise=r.standard_normal((k, k, 2)).astype(f32),
        grads=r.standard_normal((k, k, 2)).astype(f32),
        heldout=r.random(40) < 0.5, ppx=r.random(40).astype(f32) + 0.1)


def test_phi_cores_match_jax(ops_case):
    """_phi_rows_core (private draws) and _phi_rows_core_shared (one
    shared draw, self-collision mask) == the JAX cores. Sums at rtol
    1e-5; rows at rtol 3e-4, atol 1e-7, the bound of the JAX package's
    own MMSB phi check (tests/test_mmsb.py:57-58): a row element that
    comes out of the SGRLD step's abs() of a cancellation (N/n = 100
    times the gradient) differs at rtol 2.5e-4 between torch's and
    XLA's float32 sums (measured 2.46e-4 on one element), the private
    rows at 1.4e-6, the sums at 6.4e-7."""
    cfg, c = ops_case
    jcfg = jax_config(cfg)
    got = mmsb._phi_rows_core(cfg, *_t(c["pi_n"], c["phis"], c["b"],
                                       c["pi_nb"], c["y"]), 17,
                              *_t(c["noise"]))
    want = jax_mmsb._phi_rows_core(jcfg, *_j(c["pi_n"], c["phis"], c["b"],
                                             c["pi_nb"], c["y"]), 17,
                                   *_j(c["noise"]))
    assert_close(got[0], want[0], 3e-4, ATOL, "private rows")
    assert_close(got[1], want[1], RTOL, 0.0, "private sums")
    args = (c["pi_n"], c["phis"], c["b"], c["pi_nb_shared"], c["y"],
            c["mask"])
    got = mmsb._phi_rows_core_shared(cfg, *_t(*args), 17, *_t(c["noise"]))
    want = jax_mmsb._phi_rows_core_shared(jcfg, *_j(*args), 17,
                                          *_j(c["noise"]))
    assert_close(got[0], want[0], 3e-4, ATOL, "shared rows")
    assert_close(got[1], want[1], RTOL, 0.0, "shared sums")


@pytest.mark.parametrize("prior_diag", [None, 3.0, (2.0, 5.0)])
def test_theta_grads_and_step_match_jax(ops_case, prior_diag):
    """_theta_grads_core (symmetrized) and mmsb_theta_step, with and
    without the diagonal prior (a scalar or an (eta0, eta1) pair), ==
    the JAX functions at rtol 1e-5, atol 1e-7 (measured max elementwise
    relative error: grads 5.6e-7, theta_b 1.0e-6, b 5.0e-7)."""
    cfg, c = ops_case
    cfg = cfg.replace(mmsb_prior_diag=prior_diag)
    jcfg = jax_config(cfg)
    args = (c["theta"], c["b"], c["pi_u"], c["pi_v"], c["y_e"], c["e_mask"])
    got = mmsb._theta_grads_core(cfg, *_t(*args))
    want = jax_mmsb._theta_grads_core(jcfg, *_j(*args))
    assert_close(got, want, RTOL, ATOL, "grads")
    assert torch.equal(got, got.transpose(0, 1))
    step = (c["theta"], c["grads"], np.float32(412.0))
    got = mmsb.mmsb_theta_step(cfg, *_t(*step), 9, *_t(c["t_noise"]))
    want = jax_mmsb.mmsb_theta_step(jcfg, *_j(*step), 9, *_j(c["t_noise"]))
    for a, b, what in zip(got, want, ("theta_b", "b")):
        assert_close(a, b, RTOL, ATOL, what)


def test_noise_symmetrization_and_ppx_match_jax(ops_case):
    """_symmetrize_noise (exactly symmetric, the diagonal kept) and
    mmsb_perplexity (running average, -mean log) == JAX at rtol 1e-5,
    atol 1e-7 (measured: the noise and -mean log equal, the running
    averages at 9.2e-8)."""
    cfg, c = ops_case
    jcfg = jax_config(cfg)
    xi = c["grads"]
    got = mmsb._symmetrize_noise(cfg, *_t(xi))
    assert_close(got, jax_mmsb._symmetrize_noise(jcfg, *_j(xi)), RTOL,
                 ATOL, "noise")
    assert torch.equal(got, got.transpose(0, 1))
    assert torch.equal(got.diagonal(0, 0, 1), torch.from_numpy(xi)
                       .diagonal(0, 0, 1))
    # the stacked [S, K, K, 2] form the hoisting uses, step by step
    stacked = np.stack([xi, c["t_noise"]])
    got = mmsb._symmetrize_noise(cfg, *_t(stacked))
    for i in range(2):
        assert torch.equal(got[i], mmsb._symmetrize_noise(
            cfg, *_t(stacked[i])))

    k = cfg.K
    n_nodes = 30
    r = np.random.default_rng(3)
    pi = r.gamma(1.0, size=(n_nodes, k)).astype(np.float32)
    pi /= pi.sum(-1, keepdims=True)
    eu = r.integers(0, n_nodes, 40).astype(np.int32)
    ev = r.integers(0, n_nodes, 40).astype(np.int32)
    links = (eu[c["heldout"]], ev[c["heldout"]])
    jset = jax_build_edge_set(JaxEdgeSetBackend.ADJACENCY, n_nodes, *links)
    tset = build_edge_set(config.EdgeSetBackend.ADJACENCY, n_nodes, *links,
                          "cpu")
    fields = dict(pi=pi, phi_sum=pi.sum(-1), theta_b=c["theta"], b=c["b"],
                  step_count=5, theta_count=4, ppx_per_edge=c["ppx"],
                  ppx_count=2)
    tcfg = cfg.replace(N=n_nodes)
    ts = mmsb_state_from_numpy(fields, tcfg, "cpu")
    js = jax_mmsb.MMSBState(*(jnp.asarray(fields[f]) if f in fields else None
                              for f in jax_mmsb.MMSBState._fields))
    ts, tneg = mmsb.mmsb_perplexity(tcfg, tset, *_t(eu, ev), ts)
    js, jneg = jax_mmsb.mmsb_perplexity(jax_config(tcfg), jset,
                                        *_j(eu, ev), js)
    assert ts.ppx_count == 3
    assert_close(ts.ppx_per_edge, js.ppx_per_edge, RTOL, ATOL, "ppx_per_edge")
    assert_close(tneg, jneg, RTOL, ATOL, "neg_avg_log")


def test_init_state_is_symmetric_and_tilted():
    """init_mmsb_state: theta_b symmetric in (k, l), its link component
    tilted by 1 + 2 I, B = theta1 / (theta0 + theta1), pi rows normalized
    with phi_sum the raw sums; the same host init stream as init_state
    (theta first, then the pi rows)."""
    cfg = config.Config(K=5).finalize(40, 100, 4)
    s = mmsb.init_mmsb_state(cfg, 7, "cpu")
    assert torch.equal(s.theta_b, s.theta_b.transpose(0, 1))
    torch.testing.assert_close(s.b, s.theta_b[..., 1] / s.theta_b.sum(-1))
    torch.testing.assert_close(s.pi.sum(-1), torch.ones(40))
    assert s.step_count == 1 and s.theta_count == 0 and s.ppx_count == 0
    draws = np.random.default_rng(cfg.init_seed)
    raw = learner.gamma_draws(cfg, draws, (5, 5, 2), "cpu")
    sym = 0.5 * (raw + raw.transpose(0, 1))
    torch.testing.assert_close(s.theta_b[..., 0], sym[..., 0])
    torch.testing.assert_close(s.theta_b[..., 1],
                               sym[..., 1] * (1 + 2 * torch.eye(5)))


# ---------------------------------------------------------------------------
# The window core against the JAX kernel (interpret mode)
# ---------------------------------------------------------------------------

def _window_both(seed, shape, prior_diag=None):
    case = testing.mmsb_window_case(seed, *shape)
    cfg = testing.window_case_config(case).replace(
        mmsb_prior_diag=prior_diag)
    state, xs = testing.mmsb_window_case_torch(case, "cpu")
    batch, nbrs = xs[0], xs[1]
    g, sums = window._window_gather(cfg, state, batch, nbrs)
    mcode = window._correction_codes(cfg, batch.nodes, batch.node_mask, nbrs)
    # a collision needs an earlier step of the window
    assert shape[0] == 1 or (mcode > 0).any(), "the case must collide"
    return case, cfg, state, xs, g, sums, mcode


def _jax_kernel(cfg, case, g, sums, mcode):
    """mmsb_window_kernel_call on the case, its operands prepared as
    mmsb_windowed_scan prepares them (window_mmsb.py:316-356)."""
    jcfg = jax_config(cfg)
    t_win, b_cap = case["nodes"].shape
    k = cfg.K
    f32 = np.float32
    steps = case["step_count"] + np.arange(t_win)
    counts = case["theta_count"] + 1 + np.arange(t_win)
    eta = mmsb.mmsb_eta(cfg, torch.float32, "cpu").broadcast_to(k, k, 2)
    nbr_mask = case["neighbors"][:, None, :] != case["nodes"][:, :, None]
    tn = case["t_noise"]
    ops = [g.numpy(), sums.numpy()[..., None], case["y_phi"].astype(f32),
           nbr_mask.astype(f32), case["node_mask"][..., None].astype(f32),
           case["phi_noise"],
           np.concatenate([tn[..., 0], tn[..., 1]], axis=1),
           case["y_edges"][..., None].astype(f32),
           case["edge_mask"][..., None].astype(f32),
           case["lanes_u"][..., None], case["lanes_v"][..., None],
           mcode.numpy()[..., None], case["weight"][:, None, None],
           np.asarray(jcfg.eps_t(jnp.asarray(steps, jnp.int32)))[:, None],
           np.asarray(jcfg.eps_t(jnp.asarray(counts, jnp.int32)))[:, None],
           np.concatenate([eta[..., 0].numpy(), eta[..., 1].numpy()]),
           np.concatenate([case["theta_b"][..., 0],
                           case["theta_b"][..., 1]])]
    rows, rsums, theta_cm = jax_window_mmsb.mmsb_window_kernel_call(
        jcfg, *_j(*ops))
    theta_cm = np.asarray(theta_cm)
    return (np.asarray(rows), np.asarray(rsums)[:, 0],
            np.stack([theta_cm[:k], theta_cm[k:]], axis=-1))


def test_window_core_single_step_matches_jax_kernel():
    """T=1: mmsb_window_core_torch == the JAX Pallas kernel (interpret
    mode) at the single-step bounds of tests/test_window_mmsb.py:169-172
    (rows rtol 5e-4, atol 1e-7; theta rtol 5e-4, atol 1e-6). Measured
    max elementwise relative error: rows 3.2e-6, sums 8.9e-8, theta
    1.7e-7."""
    case, cfg, state, xs, g, sums, mcode = _window_both(2, (1, 9, 8, 8, 8))
    got = window_mmsb.mmsb_window_core_torch(cfg, state, xs, g, sums, mcode)
    want = _jax_kernel(cfg, case, g, sums, mcode)
    assert_close(got[0], want[0], 5e-4, 1e-7, "rows")
    assert_close(got[1], want[1], 5e-4, 1e-7, "sums")
    assert_close(got[2], want[2], 5e-4, 1e-6, "theta")


@pytest.mark.parametrize("shape, prior_diag", [
    ((4, 9, 8, 8, 8), None),
    ((4, 5, 7, 5, 12), (2.0, 5.0)),
])
def test_window_core_matches_jax_kernel(shape, prior_diag):
    """T=4 windows with in-window collisions, K=8 and the odd shape
    (B=5, n=7, K=12) with a diagonal prior pair: within the measured
    envelope of tests/test_window_mmsb.py:57-59 (rows atol 5e-3, theta
    rtol 0.1 / atol 0.15; sums rtol 1e-3). Measured at K=8 / K=12: rows
    max abs 6.7e-8 / 4.5e-8, sums max rel 2.2e-7 / 1.9e-7, theta max abs
    2.4e-7 / 2.4e-7 — far inside the envelope, which JAX measured between
    its kernel and its sequential scan over 24 steps."""
    case, cfg, state, xs, g, sums, mcode = _window_both(4, shape,
                                                        prior_diag)
    got = window_mmsb.mmsb_window_core_torch(cfg, state, xs, g, sums, mcode)
    want = _jax_kernel(cfg, case, g, sums, mcode)
    assert_close(got[0], want[0], 0.0, PI_ATOL, "rows")
    assert_close(got[1], want[1], 1e-3, 0.0, "sums")
    assert_close(got[2], want[2], what="theta", **TH_TOLS)
    assert torch.equal(got[2], got[2].transpose(0, 1))


def _window_apply_jax(cfg, case, state_np, keep):
    """JAX's _window_gather -> mmsb_window_kernel_call (interpret mode) ->
    _window_scatter on the case: (pi, phi_sum, theta_b)."""
    jcfg = jax_config(cfg)
    js = SimpleNamespace(pi=jnp.asarray(state_np["pi"]),
                         phi_sum=jnp.asarray(state_np["phi_sum"]))
    jbatch = JaxDeviceBatch(*(jnp.asarray(case[f])
                              for f in JaxDeviceBatch._fields))
    jnbrs = jnp.asarray(case["neighbors"])
    g, sums = jax_window._window_gather(jcfg, js, jbatch, jnbrs)
    jmcode = jax_window._correction_codes(jcfg, jbatch.nodes,
                                          jbatch.node_mask, jnbrs)
    rows, rsums, theta_b = _jax_kernel(
        cfg, case, torch.from_numpy(np.array(g)),
        torch.from_numpy(np.array(sums)),
        torch.from_numpy(np.array(jmcode)[..., 0]))
    jkeep = jax_window._last_write_wins(jbatch.nodes, jbatch.node_mask,
                                        case["nodes"].shape[0])
    np.testing.assert_array_equal(np.asarray(jkeep), keep.numpy())
    pi, phi_sum = jax_window._window_scatter(jcfg, js, jbatch, jkeep,
                                             jnp.asarray(rows),
                                             jnp.asarray(rsums))
    return np.asarray(pi), np.asarray(phi_sum), theta_b


@pytest.mark.parametrize("shape, prior_diag", [
    ((4, 9, 8, 8, 8), None),
    ((4, 5, 7, 5, 12), (2.0, 5.0)),
])
def test_window_apply_torch_matches_jax(shape, prior_diag):
    """The fused window's plain version (gather, core, scatter in one
    call: what the CUDA kernel computes in one launch) == JAX's
    _window_gather -> the Pallas kernel (interpret mode) ->
    _window_scatter on the same operands, with the case's in-window
    collisions, masked and padded lanes: pi updated in place (atol 5e-3),
    phi_sum rtol 1e-3, theta within the envelope of tests/
    test_window_mmsb.py:57-59 and exactly symmetric, B its ratio, the
    counters advanced by T."""
    case, cfg, state, xs, _, _, mcode = _window_both(6, shape, prior_diag)
    state_np = {f: getattr(state, f).numpy().copy() for f in ("pi",
                                                              "phi_sum")}
    keep = window._last_write_wins(xs[0].nodes, xs[0].node_mask, shape[0])
    assert not bool(xs[0].node_mask.all()), "the case must mask lanes"
    got = window_mmsb.mmsb_window_apply_torch(cfg, state, xs, mcode, keep)
    assert got.pi is state.pi                        # in place
    assert got.step_count == case["step_count"] + shape[0]
    assert got.theta_count == case["theta_count"] + shape[0]
    pi, phi_sum, theta_b = _window_apply_jax(cfg, case, state_np, keep)
    assert_close(got.pi, pi, 0.0, PI_ATOL, "pi")
    assert_close(got.phi_sum, phi_sum, 1e-3, 0.0, "phi_sum")
    assert_close(got.theta_b, theta_b, what="theta", **TH_TOLS)
    assert torch.equal(got.theta_b, got.theta_b.transpose(0, 1))
    torch.testing.assert_close(got.b, got.theta_b[..., 1]
                               / got.theta_b.sum(-1), rtol=0, atol=0)


@pytest.mark.parametrize("shape", [
    (12, 33, 32, 32, 64), (12, 33, 32, 32, 128), (12, 33, 32, 32, 256),
    (3, 6, 7, 5, 12), (48, 33, 32, 32, 64)])
def test_mmsb_window_cluster_size_rule(shape):
    """The K split of the MMSB window kernel: CTA r owns rows [r*w,
    min(K, (r+1)*w)) of B and theta; the slices tile K exactly with none
    empty, and the per-CTA shared memory fits an H100's 232,448 B per
    block — at the shapes chip_smoke.py runs (K = 64, 128, 256; the odd
    K = 12) and a long window (T = 48)."""
    t_win, b_cap, n_smpl, e_cap, k = shape
    s = window_mmsb.mmsb_window_cluster_size(*shape)
    assert 1 <= s <= window.MAX_CLUSTER
    w = window.window_slice_width(k, s)
    rows = [c for r in range(s) for c in range(r * w, min(k, (r + 1) * w))]
    assert rows == list(range(k))
    assert all(min(k, (r + 1) * w) > r * w for r in range(s))
    assert window_mmsb.mmsb_window_smem_bytes(*shape, s) <= window.H100_SMEM
    if k >= 64:
        assert s > 1


def test_mmsb_window_cluster_size_raises_and_window_fits():
    """A shape that fits at no cluster size raises naming the shape;
    window_fits (the learner's decision) says no for it and names the
    cluster and the bytes for a shape that fits."""
    with pytest.raises(ValueError, match=r"\(64, 33, 32, 32, 1024\)"):
        window_mmsb.mmsb_window_cluster_size(64, 33, 32, 32, 1024)
    assert window_mmsb.mmsb_window_cluster_size(12, 33, 32, 32, 256) == 16
    assert window_mmsb.mmsb_window_cluster_size(12, 33, 32, 32, 64) == 16
    # no power of two splits K = 12 or K = 100 into non-empty slices: the
    # nearest other size does
    assert window_mmsb.mmsb_window_cluster_size(3, 6, 7, 5, 12) == 3
    assert window_mmsb.mmsb_window_cluster_size(12, 33, 32, 32, 100) == 13
    # a smaller card: a shape that fits nowhere raises
    with pytest.raises(ValueError, match=r"\(12, 33, 32, 32, 64\)"):
        window_mmsb.mmsb_window_cluster_size(12, 33, 32, 32, 64, 70_000)


def test_window_core_cuda_rejects_cpu_tensors():
    """The fused kernel's wrapper never runs on the CPU: on a CPU tensor
    it raises (mmsb_windowed_scan picks the plain version by device)."""
    case, cfg, state, xs, g, sums, mcode = _window_both(4, (2, 6, 5, 4, 8))
    keep = window._last_write_wins(xs[0].nodes, xs[0].node_mask, 2)
    with pytest.raises(ValueError, match="CUDA"):
        window_mmsb.mmsb_window_apply_cuda(cfg, state, xs, mcode, keep)


# ---------------------------------------------------------------------------
# A windowed trajectory against the JAX package's
# ---------------------------------------------------------------------------

def _jax_mmsb_hoist(jcfg, edge_set, state, batches):
    """mmsb_steps_scan's operand tuple (models/mmsb.py:336-381),
    recomputed with the JAX package's functions: shared draws."""
    s_len, b_sz = batches.nodes.shape
    steps = state.step_count + jnp.arange(s_len, dtype=jnp.int32)
    nbr_keys = jax.vmap(
        lambda s: jax.random.fold_in(state.neighbor_key, s))(steps)
    sentinel = jnp.full((1,), jcfg.N, jnp.int32)
    neighbors = jax.vmap(lambda k: jax_neighbors(
        k, sentinel, jcfg.N, jcfg.num_node_sample))(nbr_keys)[:, 0]
    phi_noise = jax.vmap(lambda s: jax_rng.randn(
        jax.random.fold_in(state.phi_key, s), (b_sz, jcfg.K)))(steps)
    t_noise = jax.vmap(lambda s: jax_mmsb._symmetrize_noise(
        jcfg, jax_rng.randn(jax.random.fold_in(state.theta_key, s),
                            (jcfg.K, jcfg.K, 2))))(steps)
    lanes = [jnp.argmax(e[:, :, None] == batches.nodes[:, None, :],
                        axis=-1).astype(jnp.int32)
             for e in (batches.edges_u, batches.edges_v)]
    return (batches, neighbors,
            edge_set.has_edges(batches.nodes[:, :, None],
                               neighbors[:, None, :]),
            phi_noise, t_noise,
            edge_set.has_edges(batches.edges_u, batches.edges_v), *lanes)


INTERVAL, EVALS, WINDOW = 12, 2, 5       # 2 windows + 2 tail steps each


def test_windowed_trajectory_matches_jax():
    """24 steps (two 12-step intervals of 2 windows of 5 and 2 tail
    steps) and the ppx after each, from one state, on the JAX-built
    operands: JAX's mmsb_steps_scan (its mmsb_windowed_scan, Pallas
    kernel in interpret mode, and its own sequential body for the tails)
    against the port's mmsb_run_hoisted, on the collision-heavy N=300
    graph of tests/test_window_mmsb.py (K=8, m=n=8).

    The envelope of tests/test_window_mmsb.py:57-59 and ppx rtol 1e-3.
    Measured after interval 0 / 1: pi max abs 2.1e-7 / 4.6e-7, theta max
    abs 9.3e-6 / 5.5e-6, b max rel 3.0e-6 / 3.3e-6, ppx rel 1.2e-7 /
    0."""
    n, u, v = data.synthetic_edges(300, 8, seed=9)
    split = data.generate_sets(n, u, v, heldout_ratio=0.1, seed=10)
    graph = data.Graph.from_edges(n, split.training_u, split.training_v)
    cfg = config.Config(K=8, mini_batch_size=8, num_node_sample=8,
                        steps_per_call=INTERVAL, device_sampling=True,
                        shared_neighbors=True, window=WINDOW).finalize(
        n, split.total_edges, graph.max_fan_out)
    jcfg = jax_config(cfg)
    jtr = jax_build_edge_set(JaxEdgeSetBackend.ADJACENCY, n, graph.edges_u,
                             graph.edges_v)
    jho = jax_build_edge_set(JaxEdgeSetBackend.ADJACENCY, n,
                             split.heldout_u, split.heldout_v)
    adjacency = (jnp.asarray(graph.offsets, jnp.int32),
                 jnp.asarray(graph.cols, jnp.int32))
    hu, hv = (jnp.asarray(a) for a in (split.heldout_edges_u,
                                       split.heldout_edges_v))

    @jax.jit
    def jax_interval(state, key):
        ds = sample_minibatches_device(jcfg, jtr, jho, key, INTERVAL,
                                       adjacency)
        batches = JaxDeviceBatch(*ds)
        xs = _jax_mmsb_hoist(jcfg, jtr, state, batches)
        state = jax_mmsb.mmsb_steps_scan(jcfg, jtr, state, batches)
        state, neg = jax_mmsb.mmsb_perplexity(jcfg, jho, hu, hv, state)
        return state, xs, neg

    jstate = jax_mmsb.init_mmsb_state(jcfg, len(split.heldout_edges_u))
    tstate = mmsb_state_from_numpy(
        {f: np.asarray(v) for f, v in jstate._asdict().items()}, cfg, "cpu")
    tho = build_edge_set(config.EdgeSetBackend.ADJACENCY, n,
                         split.heldout_u, split.heldout_v, "cpu")
    for i in range(EVALS):
        jstate, xs, jneg = jax_interval(jstate, jax.random.PRNGKey(300 + i))
        tstate = mmsb.mmsb_run_hoisted(cfg, tstate,
                                       to_torch(xs, learner.DeviceBatch))
        tstate, tneg = mmsb.mmsb_perplexity(
            cfg, tho, *_t(split.heldout_edges_u, split.heldout_edges_v),
            tstate)
        assert tstate.step_count == int(jstate.step_count)
        assert tstate.theta_count == int(jstate.theta_count)
        assert_close(tstate.pi, jstate.pi, 0.0, PI_ATOL, f"{i}: pi")
        assert_close(tstate.theta_b, jstate.theta_b, what=f"{i}: theta",
                     **TH_TOLS)
        assert_close(tstate.b, jstate.b, what=f"{i}: b", **B_TOLS)
        assert_close(torch.exp(tneg), np.exp(np.asarray(jneg)), 1e-3, 0.0,
                     f"{i}: ppx")


def test_learner_recovers_planted_blocks():
    """FullMMSBLearner on the CPU (device sampling, shared draws, windows
    of 12 through the plain core) on the planted partition and with the
    identifiability knobs of tests/test_mmsb.py:96-116: B becomes
    diagonal (diag - off > 0.5, measured 0.927), every ppx of the series
    falls below ppx[0] (measured 2.047 -> 1.915), theta stays exactly
    symmetric and pi rows normalized."""
    n, u, v = data.synthetic_sbm_edges(300, 3, p_in=0.25, p_out=0.004,
                                       seed=31)
    split = data.generate_sets(n, u, v, heldout_ratio=0.1, seed=32)
    graph = data.Graph.from_edges(n, split.training_u, split.training_v)
    cfg = config.Config(
        K=3, mini_batch_size=16, num_node_sample=12, steps_per_call=1000,
        device_sampling=True, shared_neighbors=True, window=12,
        mmsb_prior_diag=(1.0, 50.0), mmsb_noise_scale=0.3, b=4096.0,
        eta0=50.0, eta1=1.0).finalize(n, split.total_edges,
                                      graph.max_fan_out)
    lrn = mmsb.FullMMSBLearner(cfg, graph, split, "cpu")
    p0 = lrn.heldout_perplexity()
    series = lrn.run_with_ppx(8000, 1000)
    assert [e["step"] for e in series] == list(range(1001, 8002, 1000))
    assert all(np.isfinite(e["ppx"]) and e["ppx"] < p0 for e in series)
    s = lrn.state
    off = s.b[~torch.eye(3, dtype=torch.bool)].mean()
    assert float(s.b.diagonal().mean() - off) > 0.5
    assert torch.equal(s.theta_b, s.theta_b.transpose(0, 1))
    torch.testing.assert_close(s.pi.sum(-1), torch.ones(n), atol=1e-5,
                               rtol=0)


@pytest.mark.cuda
def test_window_core_cuda_matches_plain_on_gpu():
    """On a GPU: the fused kernel against its plain version at the main
    path's shape at T=1, each on its own copy of the state (the kernel
    writes pi in place): rtol 1e-5, atol 1e-8 normwise, as chip_smoke.py
    checks it; theta exactly symmetric."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    case = testing.mmsb_window_case(0, 1, 33, 32, 32, 64)
    cfg = testing.window_case_config(case)
    state, xs = testing.mmsb_window_case_torch(case, "cuda")
    mcode = window._correction_codes(cfg, xs[0].nodes, xs[0].node_mask,
                                     xs[1])
    keep = window._last_write_wins(xs[0].nodes, xs[0].node_mask, 1)
    clone = state._replace(pi=state.pi.clone(), phi_sum=state.phi_sum.clone())
    got = window_mmsb.mmsb_window_apply_cuda(cfg, state, xs, mcode, keep)
    want = window_mmsb.mmsb_window_apply_torch(cfg, clone, xs, mcode, keep)
    assert torch.equal(got.theta_b, got.theta_b.transpose(0, 1))
    for f in ("pi", "phi_sum", "theta_b"):
        a, b = getattr(got, f), getattr(want, f)
        err = float((a - b).abs().max())
        assert err <= 1e-8 + 1e-5 * float(b.abs().max()), f


# ---------------------------------------------------------------------------
# Host-sampled MMSB against the JAX package's
# ---------------------------------------------------------------------------

def _jax_mmsb_hoist_private(jcfg, edge_set, state, batches):
    """The draws of JAX's mmsb_train_step and of its mmsb_steps_scan with
    private neighbors (models/mmsb.py:272-297, 351-368), recomputed from
    the same keys: (neighbors [S, B, n], phi_noise [S, B, K], t_noise
    [S, K, K, 2] symmetrized); JAX keys every draw by the step, so one
    step at a time and a scanned chunk see the same numbers."""
    s_len, b_sz = batches.nodes.shape
    steps = state.step_count + jnp.arange(s_len, dtype=jnp.int32)
    nbr_keys = jax.vmap(
        lambda s: jax.random.fold_in(state.neighbor_key, s))(steps)
    neighbors = jax.vmap(lambda k, nd: jax_neighbors(
        k, nd, jcfg.N, jcfg.num_node_sample))(nbr_keys, batches.nodes)
    phi_noise = jax.vmap(lambda s: jax_rng.randn(
        jax.random.fold_in(state.phi_key, s), (b_sz, jcfg.K)))(steps)
    t_noise = jax.vmap(lambda s: jax_mmsb._symmetrize_noise(
        jcfg, jax_rng.randn(jax.random.fold_in(state.theta_key, s),
                            (jcfg.K, jcfg.K, 2))))(steps)
    return neighbors, phi_noise, t_noise


def _host_setup(small_dataset, **kw):
    from mcmc_ammsb_tpu_torch.sampling import MiniBatchSampler

    n, split, graph = small_dataset
    cfg = config.Config(
        **{**dict(K=8, mini_batch_size=8, num_node_sample=8,
                  device_sampling=False, shared_neighbors=False,
                  host_sampler="numpy", steps_per_call=10,
                  mmsb_prior_diag=(1.0, 5.0)), **kw}).finalize(
        n, split.total_edges, graph.max_fan_out)
    jcfg = jax_config(cfg)
    jset = jax_build_edge_set(JaxEdgeSetBackend.ADJACENCY, n, graph.edges_u,
                              graph.edges_v)
    tset = build_edge_set(config.EdgeSetBackend.ADJACENCY, n, graph.edges_u,
                          graph.edges_v, "cpu")
    jstate = jax_mmsb.init_mmsb_state(jcfg, len(split.heldout_edges_u))
    tstate = mmsb_state_from_numpy(
        {f: np.asarray(v) for f, v in jstate._asdict().items()}, cfg, "cpu")
    sampler = MiniBatchSampler(cfg, graph, split, seed=0)
    return cfg, jcfg, jset, tset, jstate, tstate, sampler


def _compare_host(tstate, jstate, what):
    """Normwise rtol 5e-5, atol 1e-8 on the whole state, the tolerance
    of the a-MMSB host slice (tests/test_torch_host_slice.py)."""
    from torch_parity import assert_normwise

    assert tstate.step_count == int(jstate.step_count)
    assert tstate.theta_count == int(jstate.theta_count)
    for f in ("pi", "phi_sum", "theta_b", "b"):
        assert_normwise(getattr(tstate, f), getattr(jstate, f), 5e-5, 1e-8,
                        f"{what}: {f}")


def test_mmsb_train_step_matches_jax(small_dataset):
    """10 mmsb_train_steps on host batches (padded lanes hold id 0), with
    a diagonal prior and a noise temperature, against JAX's
    mmsb_train_step; the port is handed JAX's keyed draws. Measured max
    abs: pi 2.0e-7, theta_b 8.5e-6."""
    cfg, jcfg, jset, tset, jstate, tstate, sampler = _host_setup(
        small_dataset, mmsb_noise_scale=0.5)
    stacked = sampler.sample_many(10)
    assert not stacked.node_mask.all()
    jbatches = JaxDeviceBatch.from_stacked(stacked)
    tbatches = learner.DeviceBatch.from_stacked(stacked, "cpu")
    nbrs, phi_noise, t_noise = (
        torch.tensor(np.asarray(a)) for a in _jax_mmsb_hoist_private(
            jcfg, jset, jstate, jbatches))
    jstep = jax.jit(lambda es, s, b: jax_mmsb.mmsb_train_step(jcfg, es, s, b))
    for i in range(10):
        jstate = jstep(jset, jstate, JaxDeviceBatch(*(a[i] for a in jbatches)))
        tstate = mmsb.mmsb_train_step(
            cfg, tset, tstate, learner.DeviceBatch(*(a[i] for a in tbatches)),
            nbrs[i], 0.5 * phi_noise[i], 0.5 * t_noise[i])
    _compare_host(tstate, jstate, "train_step")
    assert torch.equal(tstate.theta_b, tstate.theta_b.transpose(0, 1))


def test_mmsb_draw_step_operands_shapes_and_modes(small_dataset):
    """mmsb_draw_step_operands: private neighbors [B, n] that avoid the
    node itself, phi noise [B, K] and symmetric theta noise [K, K, 2] at
    the noise temperature; ones (unscaled) in the noise-free mode, the
    phi stream then untouched."""
    cfg, _, _, _, _, _, sampler = _host_setup(small_dataset,
                                              mmsb_noise_scale=0.5)
    streams = learner.rng.make_streams(cfg, "cpu")
    batch = learner.DeviceBatch.from_host(sampler.sample(), "cpu")
    nbrs, phi_noise, t_noise = mmsb.mmsb_draw_step_operands(cfg, streams,
                                                            batch)
    assert nbrs.shape == (batch.nodes.shape[0], cfg.num_node_sample)
    assert not (nbrs == batch.nodes[:, None]).any()
    assert phi_noise.shape == (batch.nodes.shape[0], cfg.K)
    assert 0.35 < float(phi_noise.std()) < 0.65
    assert torch.equal(t_noise, t_noise.transpose(0, 1))
    quiet = cfg.replace(phi_disable_noise=True)
    before = streams.phi.get_state().clone()
    _, ones, t2 = mmsb.mmsb_draw_step_operands(quiet, streams, batch)
    assert torch.equal(ones, torch.ones_like(ones))
    assert torch.equal(streams.phi.get_state(), before)
    assert float(t2.std()) > 0.3


def test_mmsb_host_scanned_run_matches_jax(small_dataset):
    """Two scanned chunks of 10 host-sampled steps (private draws, a
    diagonal prior) against JAX's mmsb_steps_scan, with an evaluation
    after each (ppx rtol 1e-5). Measured max abs after chunk
    0 / 1: pi 2.1e-7 / 2.1e-7, theta_b 2.7e-6 / 4.3e-6."""
    cfg, jcfg, jset, tset, jstate, tstate, sampler = _host_setup(
        small_dataset)
    n, split, _ = small_dataset
    jho = jax_build_edge_set(JaxEdgeSetBackend.ADJACENCY, n,
                             split.heldout_u, split.heldout_v)
    tho = build_edge_set(config.EdgeSetBackend.ADJACENCY, n,
                         split.heldout_u, split.heldout_v, "cpu")
    held = (split.heldout_edges_u, split.heldout_edges_v)
    jscan = jax.jit(lambda es, s, b: jax_mmsb.mmsb_steps_scan(jcfg, es, s, b))
    for chunk in range(2):
        stacked = sampler.sample_many(10)
        jbatches = JaxDeviceBatch.from_stacked(stacked)
        tbatches = learner.DeviceBatch.from_stacked(stacked, "cpu")
        nbrs, phi_noise, t_noise = (
            torch.tensor(np.asarray(a)) for a in _jax_mmsb_hoist_private(
                jcfg, jset, jstate, jbatches))
        y_phi = tset.has_edges(tbatches.nodes[:, :, None], nbrs)
        y_edges = tset.has_edges(tbatches.edges_u, tbatches.edges_v)
        xs = (tbatches, nbrs, y_phi, phi_noise, t_noise, y_edges, None, None)
        jstate = jscan(jset, jstate, jbatches)
        for i in range(10):
            tstate = mmsb._mmsb_step_body(
                cfg, tstate, (learner.DeviceBatch(*(a[i] for a in tbatches)),
                              *(a[i] if a is not None else None
                                for a in xs[1:])))
        _compare_host(tstate, jstate, f"chunk {chunk}")
        jstate, jneg = jax_mmsb.mmsb_perplexity(jcfg, jho, *_j(*held), jstate)
        tstate, tneg = mmsb.mmsb_perplexity(cfg, tho, *_t(*held), tstate)
        assert_close(torch.exp(tneg), np.exp(np.asarray(jneg)), 1e-5, 0.0,
                     f"chunk {chunk}: ppx")


def test_mmsb_host_sampled_learner(small_dataset):
    """FullMMSBLearner without device sampling: the host branch of run
    (sample_many through the prefetch pipeline, one packed copy,
    mmsb_steps_scan) trains at every steps_per_call (1 included: the
    scanned loop, as in JAX), with and without prefetch giving the same
    bits; run_with_ppx raises as the JAX learner's does."""
    n, split, graph = small_dataset
    states = []
    for prefetch, spc in ((True, 5), (False, 5), (True, 1)):
        cfg = config.Config(K=8, mini_batch_size=8, num_node_sample=8,
                            steps_per_call=spc, host_sampler="numpy"
                            ).finalize(n, split.total_edges,
                                       graph.max_fan_out)
        lrn = mmsb.FullMMSBLearner(cfg, graph, split, "cpu",
                                   prefetch=prefetch)
        assert lrn.sampler is not None
        lrn.run(12)
        assert lrn.state.step_count == 13 and lrn.state.theta_count == 12
        assert np.isfinite(lrn.heldout_perplexity())
        with pytest.raises(RuntimeError, match="requires device_sampling"):
            lrn.run_with_ppx(10, 5)
        lrn.close()
        states.append(lrn.state)
    assert torch.equal(states[0].pi, states[1].pi)
    assert torch.equal(states[0].theta_b, states[1].theta_b)
    assert not torch.equal(states[0].pi, states[2].pi)
