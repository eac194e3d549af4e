"""The port's MMSB chain engine (MMSBChainState, the chain-axis step
cores, _mmsb_chains_chunk's body, _mmsb_chains_ppx, MMSBChainLearner in
mcmc_ammsb_tpu_torch/models/mmsb.py) against the JAX package's
(mcmc_ammsb_tpu/models/mmsb.py:564-869) on the same operands, and against
the port's own single-chain functions. The engine has no window kernel in
either package: everything here is torch ops.

Tolerances: the step cores at the single-chain bounds of
tests/test_torch_mmsb.py (rtol 1e-5, atol 1e-7; the phi rows rtol 3e-4
for the element that comes out of the abs() of a cancellation); a 2 x 10
step slice inside the envelope of docs/design.md "Windowed MMSB
tolerances" (the 1/theta conditioning; pi atol 5e-3, theta rtol 0.1 / atol
0.15), with the measured values and their cause in the test.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_ammsb_tpu.config import EdgeSetBackend as JaxEdgeSetBackend
from mcmc_ammsb_tpu.models import mmsb as jax_mmsb
from mcmc_ammsb_tpu.ops.edgeset import build_edge_set as jax_build_edge_set
from mcmc_ammsb_tpu_torch import config, data, learner
from mcmc_ammsb_tpu_torch.models import mmsb
from mcmc_ammsb_tpu_torch.ops.edgeset import build_edge_set

from torch_parity import assert_close, jax_config, jax_mmsb_chain_hoist

RTOL, ATOL = 1e-5, 1e-7
PI_ATOL = 5e-3
TH_TOLS = dict(rtol=0.1, atol=0.15)
B_TOLS = dict(rtol=0.1, atol=0.05)
C = 3


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.fixture(scope="module")
def ops_case():
    """Seeded operands of one step of C=3 chains at K=6, B=7, n=5, E=9."""
    r = np.random.default_rng(12)
    k, b, n, e = 6, 7, 5, 9
    f32 = np.float32

    def rows(*shape):
        g = r.gamma(1.0, size=(*shape, k)).astype(f32)
        return g / g.sum(-1, keepdims=True)

    theta = (r.gamma(1.0, size=(C, k, k, 2)) + 0.05).astype(f32)
    theta = f32(0.5) * (theta + theta.transpose(0, 2, 1, 3))
    cfg = config.Config(K=k, num_node_sample=n,
                        mmsb_prior_diag=(2.0, 5.0)).finalize(500, 1000, 10)
    return cfg, dict(
        pi_n=rows(C, b), phis=(1 + k * r.random((C, b))).astype(f32),
        pi_nb=rows(C, b, n), pi_nb_shared=rows(C, n),
        y=r.random((C, b, n)) < 0.3, mask=r.random((C, b, n)) < 0.9,
        noise=r.standard_normal((C, b, k)).astype(f32), theta=theta,
        b=theta[..., 1] / theta.sum(-1), pi_u=rows(C, e), pi_v=rows(C, e),
        y_e=r.random((C, e)) < 0.5, e_mask=r.random((C, e)) < 0.8,
        t_noise=r.standard_normal((C, k, k, 2)).astype(f32),
        grads=r.standard_normal((C, k, k, 2)).astype(f32),
        weight=(100 + 400 * r.random(C)).astype(f32))


def test_chain_axis_phi_cores_match_vmapped_jax(ops_case):
    """_phi_rows_core and _phi_rows_core_shared with a leading chain axis
    == jax.vmap of the JAX cores over that axis (how _mmsb_chains_chunk
    calls them), and == the port's own per-chain calls at the same
    bound."""
    cfg, c = ops_case
    jcfg = jax_config(cfg)
    for name, core, jcore, keys in (
            ("private", mmsb._phi_rows_core, jax_mmsb._phi_rows_core,
             ("pi_n", "phis", "b", "pi_nb", "y")),
            ("shared", mmsb._phi_rows_core_shared,
             jax_mmsb._phi_rows_core_shared,
             ("pi_n", "phis", "b", "pi_nb_shared", "y", "mask"))):
        args = [c[k] for k in keys]
        got = core(cfg, *_t(*args), 17, *_t(c["noise"]))
        want = jax.vmap(lambda *a: jcore(jcfg, *a[:-1], 17, a[-1]))(
            *_j(*args, c["noise"]))
        assert_close(got[0], want[0], 3e-4, ATOL, f"{name} rows")
        assert_close(got[1], want[1], RTOL, 0.0, f"{name} sums")
        for i in range(C):
            one = core(cfg, *_t(*(a[i] for a in args)), 17,
                       *_t(c["noise"][i]))
            assert_close(got[0][i], one[0], 3e-4, ATOL, f"{name} rows {i}")
            assert_close(got[1][i], one[1], RTOL, 0.0, f"{name} sums {i}")


def test_chain_axis_theta_cores_match_vmapped_jax(ops_case):
    """_theta_grads_core (symmetrized per chain) and mmsb_theta_step with
    a leading chain axis, a per-chain scale [C, 1, 1, 1] and a diagonal
    prior pair == jax.vmap of the JAX functions (rtol 1e-5, atol 1e-7),
    and bit for bit the port's own per-chain calls (elementwise ops and
    sums over the same axis in the same order)."""
    cfg, c = ops_case
    jcfg = jax_config(cfg)
    args = [c[k] for k in ("theta", "b", "pi_u", "pi_v", "y_e", "e_mask")]
    got = mmsb._theta_grads_core(cfg, *_t(*args))
    want = jax.vmap(partial(jax_mmsb._theta_grads_core, jcfg))(*_j(*args))
    assert_close(got, want, RTOL, ATOL, "grads")
    assert torch.equal(got, got.transpose(1, 2))
    for i in range(C):
        one = mmsb._theta_grads_core(cfg, *_t(*(a[i] for a in args)))
        assert torch.equal(got[i], one)
    theta, grads, w, noise = _t(c["theta"], c["grads"], c["weight"],
                                c["t_noise"])
    got = mmsb.mmsb_theta_step(cfg, theta, grads, w[:, None, None, None], 9,
                               noise)
    want = jax.vmap(lambda tb, g, s, nz: jax_mmsb.mmsb_theta_step(
        jcfg, tb, g, s, 9, nz))(*_j(c["theta"], c["grads"], c["weight"],
                                    c["t_noise"]))
    for a, b, what in zip(got, want, ("theta_b", "b")):
        assert_close(a, b, RTOL, ATOL, what)
    for i in range(C):
        one = mmsb.mmsb_theta_step(cfg, theta[i], grads[i], w[i], 9, noise[i])
        assert torch.equal(got[0][i], one[0])
        assert torch.equal(got[1][i], one[1])


# ---------------------------------------------------------------------------
# The chain engine against the JAX package's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def graph_case():
    n, u, v = data.synthetic_edges(300, 8, seed=9)
    split = data.generate_sets(n, u, v, heldout_ratio=0.1, seed=10)
    return n, split, data.Graph.from_edges(n, split.training_u,
                                           split.training_v)


def _cfg(graph_case, **kw):
    n, split, graph = graph_case
    return config.Config(
        **{**dict(K=8, mini_batch_size=8, num_node_sample=4,
                  device_sampling=True, steps_per_call=10,
                  mmsb_prior_diag=(1.0, 5.0)), **kw}).finalize(
        n, split.total_edges, graph.max_fan_out)


def _torch_state(jstate):
    return mmsb.MMSBChainState(
        *(torch.tensor(np.asarray(getattr(jstate, f))) if
          np.asarray(getattr(jstate, f)).ndim else int(getattr(jstate, f))
          for f in mmsb.MMSBChainState._fields))


@pytest.mark.parametrize("shared", [True, False])
def test_chain_slice_matches_jax(graph_case, shared):
    """Two chunks of 10 device-sampled steps of 3 chains, with a diagonal
    prior, shared draws (one per step and chain) and private ones: JAX's
    _mmsb_chains_chunk against the port's body on the operands that chunk
    builds (torch_parity.jax_mmsb_chain_hoist recomputes them from the
    same keys), then _mmsb_chains_ppx of both packages on JAX's state
    (rtol 1e-5).

    Held to the MMSB envelope (pi atol 5e-3, phi_sum rtol 1e-3, theta
    rtol 0.1 / atol 0.15). Measured max abs after chunk 0 / 1, private
    draws: pi 1.5e-7 / 1.2e-6, theta_b 6.9e-6 / 2.6e-5; shared draws: pi
    2.1e-7 / 6.7e-5, theta_b 8.5e-6 / 2.0e-3. The jump in the shared run
    is one cell of theta that goes through the abs() of the SGRLD step
    near zero at step 15: against a float64 run of the same operands the
    port then stands at 6.4e-4 on theta_b and 2.1e-5 on pi, the JAX
    package at 1.4e-3 and 4.6e-5. (The operands built under jit are
    symmetric in (k, l) only to the last bit, so exact symmetry of
    theta_b is asserted on the port's own operands, below.)"""
    n, split, graph = graph_case
    cfg = _cfg(graph_case, shared_neighbors=shared)
    jcfg = jax_config(cfg)
    jl = jax_mmsb.MMSBChainLearner(jcfg, graph, split, C)
    tset = build_edge_set(config.EdgeSetBackend.ADJACENCY, n,
                          split.heldout_u, split.heldout_v, "cpu")
    hu, hv = _t(split.heldout_edges_u, split.heldout_edges_v)
    jstate = jl.state
    tstate = _torch_state(jstate)
    assert tstate.pi.shape == (C * n, cfg.K)
    hoist = jax.jit(partial(jax_mmsb_chain_hoist, jcfg, C), static_argnums=4)
    chunk = jax.jit(partial(jax_mmsb._mmsb_chains_chunk, jcfg, C),
                    static_argnames="num_steps")
    ppx = tstate.ppx_per_edge
    for i in range(2):
        xs = hoist(jl.training_set, jl.heldout_set, jl.adjacency, jstate, 10)
        jstate = chunk(jl.training_set, jl.heldout_set, jl.adjacency, jstate,
                       num_steps=10)
        tstate = mmsb.mmsb_run_chain_hoisted(
            cfg, C, tstate, tuple(torch.tensor(np.asarray(a)) for a in xs))
        assert tstate.step_count == int(jstate.step_count) == 10 * i + 11
        assert tstate.theta_count == int(jstate.theta_count)
        assert_close(tstate.pi, jstate.pi, 0.0, PI_ATOL, f"{i}: pi")
        assert_close(tstate.phi_sum, jstate.phi_sum, 1e-3, 0.0,
                     f"{i}: phi_sum")
        assert_close(tstate.theta_b, jstate.theta_b, what=f"{i}: theta",
                     **TH_TOLS)
        assert_close(tstate.b, jstate.b, what=f"{i}: b", **B_TOLS)
        # the evaluation on one state in both packages: JAX's
        jstate, jneg = jax_mmsb._mmsb_chains_ppx(
            jcfg, C, jl.heldout_set, jl.heldout_u, jl.heldout_v, jstate)
        before = _torch_state(jstate)._replace(
            pi=torch.tensor(np.asarray(jstate.pi)), ppx_per_edge=ppx,
            ppx_count=i)
        after, tneg = mmsb._mmsb_chains_ppx(cfg, C, tset, hu, hv, before)
        ppx = after.ppx_per_edge
        assert after.ppx_count == i + 1 == int(jstate.ppx_count)
        assert_close(tneg, jneg, 1e-5, 0.0, f"{i}: -mean log")
        assert_close(ppx, jstate.ppx_per_edge, 1e-5, 1e-7,
                     f"{i}: running averages")


def test_chain_hoist_layouts_and_noise_modes(graph_case):
    """mmsb_hoist_chain_operands gives the tuple of the JAX chunk, field
    for field in shape and dtype; the theta noise is symmetric per chain
    and scaled by mmsb_noise_scale; the phi noise is scaled too, or ones
    (unscaled) in the noise-free mode."""
    n, split, graph = graph_case
    for shared in (True, False):
        cfg = _cfg(graph_case, shared_neighbors=shared, mmsb_noise_scale=0.5)
        lrn = mmsb.MMSBChainLearner(cfg, graph, split, C, "cpu")
        xs = mmsb.mmsb_hoist_chain_operands(
            cfg, C, lrn.training_set, lrn.heldout_set, lrn.adjacency,
            lrn.streams, 4)
        jl = jax_mmsb.MMSBChainLearner(jax_config(cfg), graph, split, C)
        want = jax_mmsb_chain_hoist(jax_config(cfg), C, jl.training_set,
                                    jl.heldout_set, jl.adjacency, jl.state, 4)
        for a, b in zip(xs, want):
            assert tuple(a.shape) == b.shape
            assert a.numpy().dtype == np.asarray(b).dtype
        assert torch.equal(xs[9], xs[9].transpose(2, 3))
        assert 0.4 < float(xs[8].std()) < 0.6
        assert 0.4 < float(xs[9].std()) < 0.6
    quiet = mmsb.mmsb_hoist_chain_operands(
        cfg.replace(phi_disable_noise=True), C, lrn.training_set,
        lrn.heldout_set, lrn.adjacency, lrn.streams, 4)
    assert torch.equal(quiet[8], torch.ones_like(quiet[8]))
    assert float(quiet[9].std()) > 0.4


@pytest.mark.parametrize("shared", [True, False])
def test_chain_step_equals_single_chain_steps(graph_case, shared):
    """Two batched chain steps equal the same steps of C single
    FullMMSBLearner states (_mmsb_step_body on each chain's slice of the
    state and operands): the flat ids, the sentinel and the per-chain B
    and theta line up chain by chain. rtol 1e-5, atol 1e-7: the batched
    and the single matrix products of the phi cores sum in other orders
    (measured 6e-7 relative at most); theta and B, which are elementwise
    given the rows, follow at the same bound."""
    n, split, graph = graph_case
    cfg = _cfg(graph_case, shared_neighbors=shared)
    lrn = mmsb.MMSBChainLearner(cfg, graph, split, C, "cpu")
    xs = mmsb.mmsb_hoist_chain_operands(cfg, C, lrn.training_set,
                                        lrn.heldout_set, lrn.adjacency,
                                        lrn.streams, 2)
    st = lrn.state
    singles = [mmsb.MMSBState(
        pi=st.pi[c * n:(c + 1) * n].clone(),
        phi_sum=st.phi_sum[c * n:(c + 1) * n].clone(), theta_b=st.theta_b[c],
        b=st.b[c], step_count=1, theta_count=0,
        ppx_per_edge=st.ppx_per_edge[c], ppx_count=0) for c in range(C)]
    for s in range(2):
        (nodes, nmask, eu, ev, emask, w, nbrs, y_n, n_phi, n_theta,
         y_e) = (a[s] for a in xs)
        b_cap = nodes.shape[-1]
        st = mmsb._mmsb_chain_step_body(cfg, C, st, tuple(a[s] for a in xs))
        for c in range(C):
            batch = learner.DeviceBatch(eu[c], ev[c], emask[c], nodes[c],
                                        nmask[c], w[c])
            x = (batch, nbrs[c] if shared
                 else nbrs[c * b_cap:(c + 1) * b_cap], y_n[c], n_phi[c],
                 n_theta[c], y_e[c], None, None)
            singles[c] = mmsb._mmsb_step_body(cfg, singles[c], x)
    assert st.step_count == 3 and st.theta_count == 2
    for c in range(C):
        sl = slice(c * n, (c + 1) * n)
        for got, want in ((st.pi[sl], singles[c].pi),
                          (st.phi_sum[sl], singles[c].phi_sum),
                          (st.theta_b[c], singles[c].theta_b),
                          (st.b[c], singles[c].b)):
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_chain_init_is_the_single_chain_init_per_seed(graph_case):
    """Chain c starts from init_mmsb_state with init_seed + c; the
    counters are shared host integers."""
    n, split, graph = graph_case
    cfg = _cfg(graph_case, shared_neighbors=True)
    st = mmsb.init_mmsb_chain_state(cfg, C, 7, "cpu")
    assert st.ppx_per_edge.shape == (C, 7) and st.step_count == 1
    for c in range(C):
        one = mmsb.init_mmsb_state(cfg.replace(init_seed=cfg.init_seed + c),
                                   7, "cpu")
        assert torch.equal(st.pi[c * n:(c + 1) * n], one.pi)
        assert torch.equal(st.theta_b[c], one.theta_b)
        assert torch.equal(st.b[c], one.b)
    assert not torch.equal(st.pi[:n], st.pi[n:2 * n])


def test_mmsb_chain_learner_trains_on_a_planted_partition():
    """MMSBChainLearner on the CPU on the planted 3-block partition with
    the identifiability knobs of tests/test_mmsb.py: every chain's B
    becomes diagonal (diag - off > 0.5) and every chain's ppx falls below
    its ppx[0]; the chains are distinct; run_with_ppx reports a [C]
    vector at the single chain's steps."""
    n, u, v = data.synthetic_sbm_edges(300, 3, p_in=0.25, p_out=0.004,
                                       seed=31)
    split = data.generate_sets(n, u, v, heldout_ratio=0.1, seed=32)
    graph = data.Graph.from_edges(n, split.training_u, split.training_v)
    cfg = config.Config(
        K=3, mini_batch_size=16, num_node_sample=12, steps_per_call=1000,
        device_sampling=True, shared_neighbors=True,
        mmsb_prior_diag=(1.0, 50.0), mmsb_noise_scale=0.3, b=4096.0,
        eta0=50.0, eta1=1.0).finalize(n, split.total_edges,
                                      graph.max_fan_out)
    lrn = mmsb.MMSBChainLearner(cfg, graph, split, 2, "cpu")
    p0 = lrn.heldout_perplexity()
    series = lrn.run_with_ppx(3000, 1000)
    assert [e["step"] for e in series] == [1001, 2001, 3001]
    assert p0.shape == (2,)
    assert all(e["ppx"].shape == (2,) and (e["ppx"] < p0).all()
               for e in series)
    b = lrn.state.b
    eye = torch.eye(3, dtype=torch.bool)
    for c in range(2):
        assert float(b[c].diagonal().mean() - b[c][~eye].mean()) > 0.5
    assert not torch.allclose(b[0], b[1])
    assert torch.equal(lrn.state.theta_b, lrn.state.theta_b.transpose(1, 2))


@pytest.mark.parametrize("bad, match", [
    (dict(phi_impl=config.PhiImpl.PALLAS), "phi_impl=jnp only"),
    (dict(rng_backend=config.RngBackend.REFERENCE), "native RNG"),
    (dict(pi_dtype="bfloat16"), "keep pi in fp32"),
])
def test_mmsb_chain_guards_raise(graph_case, bad, match):
    """The JAX MMSBChainLearner's guards (models/mmsb.py:760-770), and no
    held-out edges."""
    n, split, graph = graph_case
    with pytest.raises(ValueError, match=match):
        mmsb.MMSBChainLearner(_cfg(graph_case, **bad), graph, split, 2, "cpu")
    empty = data.generate_sets(n, split.training_u, split.training_v,
                               heldout_ratio=0.0, seed=1)
    with pytest.raises(ValueError, match="no held-out edges"):
        mmsb.MMSBChainLearner(_cfg(graph_case), graph, empty, 2, "cpu")
