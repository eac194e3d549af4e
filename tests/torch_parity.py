"""Shared helpers of the port's parity tests (test_torch_*.py): the same
numpy operands go to the JAX package and to the PyTorch port."""

import dataclasses
import enum
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mcmc_ammsb_tpu import config as jax_config_mod
from mcmc_ammsb_tpu.learner import DeviceBatch as JaxDeviceBatch
from mcmc_ammsb_tpu.ops.neighbor import sample_neighbors as jax_neighbors
from mcmc_ammsb_tpu.rng import native as jax_rng


def require_native():
    """Skip the calling test where the port's native library cannot be
    built (no g++). Decided inside the test, never at import: every
    worker collects the same tests."""
    import pytest

    from mcmc_ammsb_tpu_torch import native
    if not native.available():
        pytest.skip(f"g++ is absent: no native library "
                    f"({native.build_error})")


def jax_config(cfg):
    """The port's Config as the JAX package's Config (enum fields are
    mapped by value onto the JAX package's own enum classes)."""
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, enum.Enum):
            v = getattr(jax_config_mod, type(v).__name__)(v.value)
        kw[f.name] = v
    return jax_config_mod.Config(**kw)


class JaxWindowState(NamedTuple):
    """The state fields the JAX window functions read."""

    pi: jnp.ndarray
    phi_sum: jnp.ndarray
    theta: jnp.ndarray
    beta: jnp.ndarray
    step_count: jnp.ndarray
    beta_count: jnp.ndarray


def jax_window_case(case):
    """(state, xs_t) of a mcmc_ammsb_tpu_torch.testing.window_case as
    JAX arrays, in the JAX package's layouts."""
    s = JaxWindowState(
        jnp.asarray(case["pi"]), jnp.asarray(case["phi_sum"]),
        jnp.asarray(case["theta"]), jnp.asarray(case["beta"]),
        jnp.asarray(case["step_count"], jnp.int32),
        jnp.asarray(case["beta_count"], jnp.int32))
    batch = JaxDeviceBatch(*(jnp.asarray(case[f])
                             for f in JaxDeviceBatch._fields))
    xs_t = (batch, *(jnp.asarray(case[f]) for f in (
        "neighbors", "y_phi", "phi_noise", "beta_noise", "y_edges",
        "lanes_u", "lanes_v")))
    return s, xs_t


def assert_close(got, want, rtol, atol, what=""):
    """np.testing.assert_allclose on torch / jax / numpy arrays."""
    got = got.detach().cpu().numpy() if hasattr(got, "detach") else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=what)


def assert_normwise(got, want, rtol, atol, what=""):
    """max |got - want| <= atol + rtol * max |want| over the whole tensor
    (chip_smoke.max_err's check): the bound for a trajectory, whose few
    elements that come out of the abs() of a cancellation keep no
    elementwise relative accuracy in any float32 evaluation."""
    got = got.detach().cpu().numpy() if hasattr(got, "detach") else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = float(np.max(np.abs(got - want)))
    bound = atol + rtol * float(np.max(np.abs(want)))
    assert err <= bound, f"{what}: max abs err {err:.3e} > {bound:.3e}"


def jax_hoist(jcfg, edge_set, state, batches):
    """The operand tuple of the JAX learner's train_steps_scan
    (learner.py:488-536), native RNG, recomputed with its own functions:
    shared neighbor draws [S, 1, n] or private ones [S, B, n]."""
    s_len, b = batches.nodes.shape
    steps = state.step_count + jnp.arange(s_len, dtype=jnp.int32)
    nbr_keys = jax.vmap(
        lambda s: jax.random.fold_in(state.neighbor_key, s))(steps)
    if jcfg.shared_neighbors:
        sentinel = jnp.full((1,), jcfg.N, jnp.int32)
        neighbors = jax.vmap(lambda k: jax_neighbors(
            k, sentinel, jcfg.N, jcfg.num_node_sample))(nbr_keys)
    else:
        neighbors = jax.vmap(lambda k, nd: jax_neighbors(
            k, nd, jcfg.N, jcfg.num_node_sample))(nbr_keys, batches.nodes)
    y_phi = edge_set.has_edges(batches.nodes[:, :, None], neighbors)
    y_edges = edge_set.has_edges(batches.edges_u, batches.edges_v)
    lanes_u = jnp.argmax(batches.edges_u[:, :, None]
                         == batches.nodes[:, None, :],
                         axis=-1).astype(jnp.int32)
    lanes_v = jnp.argmax(batches.edges_v[:, :, None]
                         == batches.nodes[:, None, :],
                         axis=-1).astype(jnp.int32)
    phi_noise = jax.vmap(lambda s: jax_rng.randn(
        jax.random.fold_in(state.phi_key, s), (b, jcfg.K)))(steps)
    beta_noise = jax.vmap(lambda s: jax_rng.randn(
        jax.random.fold_in(state.beta_key, s), (jcfg.K, 2)))(steps)
    return (batches, neighbors, y_phi, phi_noise, beta_noise, y_edges,
            lanes_u, lanes_v)


def to_torch(xs, batch_type):
    """A JAX-built hoisted operand tuple as torch CPU tensors; its first
    entry (the batches) becomes ``batch_type``."""
    batch = batch_type(*(torch.tensor(np.asarray(a)) for a in xs[0]))
    return (batch, *(torch.tensor(np.asarray(a)) for a in xs[1:]))


def jax_chain_window(jcfg, c, case):
    """The window bookkeeping and the blocked kernel's operands of a
    mcmc_ammsb_tpu_torch.testing.chain_window_case, computed as the JAX
    package's _windowed_chain_scan computes them for one window
    (chains_flat.py:275-348): a dict of the gathered rows g
    [T, C*(B+n), K] (all node blocks, then all neighbor blocks), sums
    [T, C*B], the correction codes mcode [T, C*(B+n), 1], the
    last-write-wins mask keep [C, T, B], the scatter rows safe [C*T*B]
    and ``args``, the keyword arguments of window_kernel_call and
    _windowed_chain_jnp; and ``state``, the window's JAX ChainState."""
    from functools import partial

    from mcmc_ammsb_tpu.chains_flat import ChainState as JaxChainState
    from mcmc_ammsb_tpu.ops.window import (_correction_codes,
                                           _last_write_wins)
    from mcmc_ammsb_tpu_torch.testing import CHAIN_FIELDS

    (nodes, nmask, eu, ev, emask, wts, nbrs, y_n, n_phi, n_beta, y_e, nm,
     lu, lv) = (jnp.asarray(case[f]) for f in CHAIN_FIELDS)
    key = jax.random.PRNGKey(0)
    st = JaxChainState(
        pi=jnp.asarray(case["pi"]), phi_sum=jnp.asarray(case["phi_sum"]),
        theta=jnp.asarray(case["theta"]), beta=jnp.asarray(case["beta"]),
        step_count=jnp.asarray(case["step_count"], jnp.int32),
        beta_count=jnp.asarray(case["beta_count"], jnp.int32),
        ppx_per_edge=jnp.zeros((c, 1), jnp.float32),
        ppx_count=jnp.asarray(0, jnp.int32), phi_key=key, beta_key=key,
        neighbor_key=key, sample_key=key)
    t_win, _, b_cap = nodes.shape
    e_cap, n_nbr, k = eu.shape[2], nbrs.shape[2], jcfg.K
    n_rows = jcfg.N
    f32 = jnp.float32
    offsets = (jnp.arange(c, dtype=jnp.int32) * n_rows)[None, :, None]
    nodes_f = jnp.where(nodes < n_rows, nodes + offsets, c * n_rows)
    flat_nodes = nodes_f.reshape(t_win, c * b_cap)
    vmask = nmask.reshape(t_win, c * b_cap)
    nbrs_f = nbrs + offsets
    flat_nbrs = nbrs_f.reshape(t_win, c * n_nbr)
    read_idx = jnp.concatenate([flat_nodes, flat_nbrs], axis=1)
    g = st.pi[read_idx.reshape(-1)].astype(f32).reshape(
        t_win, c * (b_cap + n_nbr), k)
    sums_g = st.phi_sum[flat_nodes.reshape(-1)].reshape(t_win, c * b_cap)
    mcode_c = jax.vmap(partial(_correction_codes, jcfg),
                       in_axes=(1, 1, 1))(nodes_f, nmask, nbrs_f)
    mc_n = jnp.swapaxes(mcode_c[:, :, :b_cap], 0, 1).reshape(
        t_win, c * b_cap, 1)
    mc_b = jnp.swapaxes(mcode_c[:, :, b_cap:], 0, 1).reshape(
        t_win, c * n_nbr, 1)
    mcode = jnp.concatenate([mc_n, mc_b], axis=1)
    lane_off = (jnp.arange(c, dtype=jnp.int32) * b_cap)[None, :, None]
    lu_f = (lu + lane_off).reshape(t_win, c * e_cap)
    lv_f = (lv + lane_off).reshape(t_win, c * e_cap)
    steps = st.step_count + jnp.arange(t_win, dtype=jnp.int32)
    counts = st.beta_count + 1 + jnp.arange(t_win, dtype=jnp.int32)
    args = dict(
        g=g, sums=sums_g[..., None].astype(f32),
        yf=y_n.reshape(t_win, c * b_cap, n_nbr).astype(f32),
        mf=nm.reshape(t_win, c * b_cap, n_nbr).astype(f32),
        nmask=vmask[..., None].astype(f32), noise=n_phi.astype(f32),
        bnoise=jnp.moveaxis(n_beta, 3, 1).reshape(t_win, 2 * c, k).astype(
            f32),
        yef=y_e.reshape(t_win, c * e_cap)[..., None].astype(f32),
        emf=emask.reshape(t_win, c * e_cap)[..., None].astype(f32),
        lanes_u=lu_f[..., None], lanes_v=lv_f[..., None], mcode=mcode,
        wts=wts[..., None].astype(f32),
        eps_phi=jcfg.eps_t(steps).astype(f32)[:, None],
        eps_theta=jcfg.eps_t(counts).astype(f32)[:, None],
        theta_cb=jnp.moveaxis(st.theta, 2, 0).reshape(2 * c, k),
        beta_cb=st.beta)
    nodes_cm = jnp.swapaxes(nodes_f, 0, 1)
    keep = jax.vmap(_last_write_wins, in_axes=(0, 1, None))(
        nodes_cm, nmask, t_win)
    safe = jnp.where(keep.reshape(-1), nodes_cm.reshape(-1), c * n_rows)
    return dict(g=g, sums=sums_g, mcode=mcode, keep=keep, safe=safe,
                args=args, state=st)


def jax_chain_hoist(jcfg, c, edge_set, heldout_set, adjacency, state, s_len):
    """The operand tuple that the JAX chain engine's _chunk builds
    (chains_flat.py:83-149), recomputed with the JAX package's own
    functions and the same keys, so that it equals the tuple _chunk
    runs on from ``state``."""
    from mcmc_ammsb_tpu.ops.device_sampling import sample_minibatches_device

    b_cap, e_cap, k = jcfg.max_batch_nodes, jcfg.max_batch_edges, jcfg.K
    chunk_key = jax.random.fold_in(state.sample_key, state.step_count)
    ds = sample_minibatches_device(jcfg, edge_set, heldout_set, chunk_key,
                                   s_len * c, adjacency, alt_period=c)

    def r(x, cap):
        return x.reshape(s_len, c, cap, *x.shape[2:])

    nodes = r(ds.nodes, b_cap)
    node_mask = r(ds.node_mask, b_cap)
    eu, ev = r(ds.edges_u, e_cap), r(ds.edges_v, e_cap)
    emask = r(ds.edge_mask, e_cap)
    weight = ds.weight.reshape(s_len, c)
    steps = state.step_count + jnp.arange(s_len, dtype=jnp.int32)
    flat_nodes_all = nodes.reshape(s_len, c * b_cap)
    nbr_keys = jax.vmap(
        lambda s: jax.random.fold_in(state.neighbor_key, s))(steps)
    if jcfg.shared_neighbors:
        sentinel = jnp.full((c,), jcfg.N, jnp.int32)
        neighbors = jax.vmap(lambda key: jax_neighbors(
            key, sentinel, jcfg.N, jcfg.num_node_sample))(nbr_keys)
        y_phi = edge_set.has_edges(nodes[..., None],
                                   neighbors[:, :, None, :])
        nbr_mask = neighbors[:, :, None, :] != nodes[..., None]
        lanes_u = jnp.argmax(eu[..., None] == nodes[:, :, None, :],
                             axis=-1).astype(jnp.int32)
        lanes_v = jnp.argmax(ev[..., None] == nodes[:, :, None, :],
                             axis=-1).astype(jnp.int32)
    else:
        neighbors = jax.vmap(lambda key, nd: jax_neighbors(
            key, nd, jcfg.N, jcfg.num_node_sample))(nbr_keys,
                                                    flat_nodes_all)
        y_phi = edge_set.has_edges(flat_nodes_all[:, :, None], neighbors)
        nbr_mask = jnp.zeros((s_len,), jnp.bool_)
        lanes_u = lanes_v = jnp.zeros((s_len,), jnp.int32)
    phi_noise = jax.vmap(lambda s: jax_rng.randn(
        jax.random.fold_in(state.phi_key, s), (c * b_cap, k)))(steps)
    beta_noise = jax.vmap(lambda s: jax_rng.randn(
        jax.random.fold_in(state.beta_key, s), (c, k, 2)))(steps)
    y_edges = edge_set.has_edges(eu, ev)
    return (nodes, node_mask, eu, ev, emask, weight, neighbors, y_phi,
            phi_noise, beta_noise, y_edges, nbr_mask, lanes_u, lanes_v)


def blocked(x, b_cap):
    """A port window array in the chain-major layout [C, T, B+n, ...] in
    the JAX blocked kernel's [T, C*(B+n), ...]: every chain's node lanes,
    then every chain's neighbor lanes."""
    x = np.swapaxes(np.asarray(x), 0, 1)                    # [T, C, R, ...]
    t_win, c = x.shape[:2]
    return np.concatenate(
        [x[:, :, :b_cap].reshape(t_win, -1, *x.shape[3:]),
         x[:, :, b_cap:].reshape(t_win, -1, *x.shape[3:])], axis=1)


def jax_mmsb_chain_hoist(jcfg, c, edge_set, heldout_set, adjacency, state,
                         s_len):
    """The scan operands that the JAX MMSB chain engine's
    _mmsb_chains_chunk builds (models/mmsb.py:593-650), recomputed with
    the JAX package's own functions and the same keys, so that they equal
    the operands the chunk runs on from ``state``."""
    from functools import partial

    from mcmc_ammsb_tpu.models.mmsb import _symmetrize_noise
    from mcmc_ammsb_tpu.ops.device_sampling import sample_minibatches_device

    b_cap, e_cap, k = jcfg.max_batch_nodes, jcfg.max_batch_edges, jcfg.K
    chunk_key = jax.random.fold_in(state.sample_key, state.step_count)
    ds = sample_minibatches_device(jcfg, edge_set, heldout_set, chunk_key,
                                   s_len * c, adjacency, alt_period=c)

    def r(x, cap):
        return x.reshape(s_len, c, cap, *x.shape[2:])

    nodes, node_mask = r(ds.nodes, b_cap), r(ds.node_mask, b_cap)
    eu, ev = r(ds.edges_u, e_cap), r(ds.edges_v, e_cap)
    emask = r(ds.edge_mask, e_cap)
    weight = ds.weight.reshape(s_len, c)
    steps = state.step_count + jnp.arange(s_len, dtype=jnp.int32)
    nbr_keys = jax.vmap(
        lambda s: jax.random.fold_in(state.neighbor_key, s))(steps)
    if jcfg.shared_neighbors:
        sentinel = jnp.full((c,), jcfg.N, jnp.int32)
        neighbors = jax.vmap(lambda key: jax_neighbors(
            key, sentinel, jcfg.N, jcfg.num_node_sample))(nbr_keys)
        y_phi = edge_set.has_edges(nodes[..., None],
                                   neighbors[:, :, None, :])
    else:
        flat = nodes.reshape(s_len, c * b_cap)
        neighbors = jax.vmap(lambda key, nd: jax_neighbors(
            key, nd, jcfg.N, jcfg.num_node_sample))(nbr_keys, flat)
        y_phi = edge_set.has_edges(flat[:, :, None], neighbors).reshape(
            s_len, c, b_cap, -1)
    if jcfg.phi_disable_noise:
        phi_noise = jnp.ones((s_len, c, b_cap, k), jnp.float32)
    else:
        phi_noise = jax.vmap(lambda s: jax_rng.randn(
            jax.random.fold_in(state.phi_key, s), (c, b_cap, k)))(steps)
        if jcfg.mmsb_noise_scale != 1.0:
            phi_noise = phi_noise * jcfg.mmsb_noise_scale
    t_noise = jax.vmap(lambda s: jax.vmap(partial(_symmetrize_noise, jcfg))(
        jax_rng.randn(jax.random.fold_in(state.theta_key, s),
                      (c, k, k, 2))))(steps)
    if jcfg.mmsb_noise_scale != 1.0:
        t_noise = t_noise * jcfg.mmsb_noise_scale
    y_edges = edge_set.has_edges(eu, ev)
    return (nodes, node_mask, eu, ev, emask, weight, neighbors, y_phi,
            phi_noise, t_noise, y_edges)
