"""The port's entry() twin (mcmc_ammsb_tpu_torch/graft.py) against the
JAX package's __graft_entry__.entry(): one a-MMSB train step on the same
tiny problem. The two steps draw their noise from other streams, so their
values are not compared (tests/test_torch_slice.py holds the step's
values on shared operands); the structure is."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_graft
from mcmc_ammsb_tpu_torch import graft

#: the state fields both packages' TrainState carry as arrays
FIELDS = ("pi", "phi_sum", "theta", "beta", "ppx_per_edge",
          "train_ppx_per_edge")


@pytest.fixture(scope="module")
def steps():
    fn, args = graft.entry("cpu")
    jfn, jargs = jax_graft.entry()
    return (fn, args, fn(*args)), (jfn, jargs, jax.jit(jfn)(*jargs))


def test_step_advances_the_count(steps):
    (_, args, out), _ = steps
    assert args[1].step_count == 1 and out.step_count == 2
    assert out.beta_count == 1


def test_outputs_have_jax_shapes_and_dtypes(steps):
    """Each state field has the JAX output's shape and dtype; finite
    values; pi rows sum to 1 within 1e-5."""
    (_, _, out), (_, _, jout) = steps
    for f in FIELDS:
        mine, ref = getattr(out, f), np.asarray(getattr(jout, f))
        assert tuple(mine.shape) == ref.shape, f
        assert str(mine.dtype).removeprefix("torch.") == str(ref.dtype), f
        assert torch.isfinite(mine).all(), f
    assert int(jout.step_count) == out.step_count
    assert (out.pi.sum(-1) - 1.0).abs().max() <= 1e-5


def test_arguments_match_jax_entry(steps):
    """The same problem as JAX's: N, K, the batch's shapes and contents
    (both sample the same host minibatch), the edge-set backend and its
    table."""
    (_, (eset, state, batch), _), (_, (jset, jstate, jbatch), _) = steps
    assert state.pi.shape == np.asarray(jstate.pi).shape == (256, 16)
    assert eset.backend == jset.backend
    for a, b in zip(eset.arrays, jset.arrays):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for f in batch._fields:
        mine, ref = getattr(batch, f).numpy(), np.asarray(getattr(jbatch, f))
        assert mine.shape == ref.shape, f
        np.testing.assert_array_equal(mine, ref.astype(mine.dtype), f)
    cfg, _, split = graft.tiny_problem()
    jcfg, _, jsplit = jax_graft._tiny_problem()
    assert (cfg.N, cfg.K, cfg.E, cfg.max_fan_out) == (
        jcfg.N, jcfg.K, jcfg.E, jcfg.max_fan_out)
    np.testing.assert_array_equal(split.heldout_edges_u,
                                  jsplit.heldout_edges_u)


def test_entry_defaults_to_the_card():
    """Without a device the entry runs on the card, and raises without
    one: there is no quiet fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft.entry()
