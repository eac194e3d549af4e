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
