"""Shared helpers of the port's parity tests (test_torch_*.py): the same
numpy operands go to the JAX package and to the PyTorch port."""

import dataclasses
import enum
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from mcmc_ammsb_tpu import config as jax_config_mod
from mcmc_ammsb_tpu.learner import DeviceBatch as JaxDeviceBatch


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
