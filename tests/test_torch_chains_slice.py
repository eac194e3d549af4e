"""The port's flat chain engine as a whole against the JAX package's.

The two packages draw different random numbers, so the JAX package
draws everything state-independent — the tuple its chain engine's
_chunk builds, recomputed with its own functions and keys
(torch_parity.jax_chain_hoist) — and both packages run the same steps
from the same state, carried across by chain_state_from_numpy: JAX's
jitted _chunk, the port's run_chain_hoisted on the injected tuple, then
each package's per-chain perplexity. Two 10-step intervals: at window 4
that is 2 windows and 2 tail steps each.
"""

import numpy as np
import pytest
import torch

from mcmc_ammsb_tpu.chains_flat import FlatChainLearner as JaxChains
from mcmc_ammsb_tpu_torch import chains_flat, config
from mcmc_ammsb_tpu_torch.interop import chain_state_from_numpy
from mcmc_ammsb_tpu_torch.ops.edgeset import build_edge_set

from torch_parity import (assert_close, assert_normwise, jax_chain_hoist,
                          jax_config)

CHAINS, INTERVAL, EVALS = 3, 10, 2


@pytest.mark.parametrize("variant", ["window4_jnp", "window4_pallas",
                                     "private_window0"])
def test_chain_slice_matches_jax(small_dataset, variant):
    """pi, phi_sum, theta and beta after each interval within rtol 5e-5,
    atol 1e-8 normwise (max |port - JAX| <= atol + rtol max |JAX| per
    tensor), the per-chain ppx at rtol 1e-5 elementwise.

    Normwise, not elementwise as tests/test_torch_slice.py checks one
    chain: torch's and XLA's CPU sums run in other orders, the
    trajectory feeds those last-bit differences back into every later
    step, and an element that comes out of the abs() of a near
    cancellation (the phi and theta SGRLD steps) keeps no relative
    accuracy. With three chains there are three times as many such
    elements: over sample_seed 0-5 x these variants, elementwise rtol
    5e-5 failed by up to 312x (a theta element of 8.7e-4 that the port
    and JAX each miss by ~1% of a float64 run of the same steps, on
    either side), while the normwise error stayed at most 0.20 of its
    bound and the ppx error at most 0.049 of its bound.
    "private_window0" is --no-shared-neighbors: private draws, every step
    through the sequential body's private branch."""
    n, split, graph = small_dataset
    shared = variant != "private_window0"
    cfg = config.Config(
        K=16, mini_batch_size=8, num_node_sample=8, device_sampling=True,
        shared_neighbors=shared, window=4 if shared else 0,
        window_impl="jnp" if variant.endswith("jnp") else "pallas",
        steps_per_call=INTERVAL, ppx_interval=INTERVAL).finalize(
        n, split.total_edges, graph.max_fan_out)
    jcfg = jax_config(cfg)
    jl = JaxChains(jcfg, graph, split, CHAINS)
    tstate = chain_state_from_numpy(
        {f: np.asarray(v) for f, v in jl.state._asdict().items()}, cfg,
        CHAINS, "cpu")
    tho = build_edge_set(config.EdgeSetBackend.ADJACENCY, n,
                         split.heldout_u, split.heldout_v, "cpu")
    hu = torch.from_numpy(split.heldout_edges_u)
    hv = torch.from_numpy(split.heldout_edges_v)
    for i in range(EVALS):
        xs = jax_chain_hoist(jcfg, CHAINS, jl.training_set, jl.heldout_set,
                             jl.adjacency, jl.state, INTERVAL)
        jl.state = jl._chunk(jl.training_set, jl.heldout_set, jl.adjacency,
                             jl.state, num_steps=INTERVAL)
        jl.state, jneg = jl._ppx(jl.heldout_set, jl.heldout_u, jl.heldout_v,
                                 jl.state)
        tstate = chains_flat.run_chain_hoisted(
            cfg, CHAINS, tstate,
            tuple(torch.tensor(np.asarray(a)) for a in xs))
        tstate, tneg = chains_flat.chain_perplexity(cfg, CHAINS, tho, hu, hv,
                                                    tstate)
        assert tstate.step_count == int(jl.state.step_count)
        assert tstate.beta_count == int(jl.state.beta_count)
        for f in ("pi", "phi_sum", "theta", "beta"):
            assert_normwise(getattr(tstate, f), getattr(jl.state, f), 5e-5,
                            1e-8, f"interval {i}: {f}")
        assert tneg.shape == (CHAINS,)
        assert_close(torch.exp(tneg), np.exp(np.asarray(jneg)), 1e-5, 0.0,
                     f"interval {i}: ppx")
    # the chains stay distinct
    pi = tstate.pi.reshape(CHAINS, n, -1)
    assert not torch.allclose(pi[0], pi[1])

