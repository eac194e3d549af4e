"""Chains over several GPUs (``parallel/chains_sharded.py``): C = G x
C_local flat chains, a group of whole chains per rank, the window
kernel's chain mode for each window of a rank (its plain version on the
CPU).

The JAX engine's contract in the port: chain c starts from the global
``init_seed + c`` law whatever G is; G = 1 is the single-GPU flat chain
engine bit for bit; the perplexities of all C chains are gathered; R-hat
across all chains; resume bit-exact; the guards raise as JAX's do. The
2-rank cases are gloo ranks, each spawn under its own deadline."""

import logging
import re

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist_workers as W
from mcmc_ammsb_tpu_torch import cli
from mcmc_ammsb_tpu_torch.chains_flat import FlatChainLearner
from mcmc_ammsb_tpu_torch.config import PhiImpl, RngBackend
from mcmc_ammsb_tpu_torch.parallel.chains_sharded import (ShardedChainLearner,
                                                          make_chain_mesh)
from mcmc_ammsb_tpu_torch.parallel.dryrun import spawn

SEED = 9
CFG = dict(device_sampling=True, shared_neighbors=True, steps_per_call=10,
           window=4)
TINY = ["--synthetic", "300,8", "-k", "8", "-m", "8", "-n", "8",
        "-x", "60", "-i", "20", "--steps-per-call", "40", "--device", "cpu"]


@pytest.fixture(scope="module")
def two_groups(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("chains"))
    return spawn(W.chains, 2, (SEED, 2, ck), timeout=120)


@pytest.fixture
def world1():
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    yield
    dist.destroy_process_group()


def test_chain_init_does_not_depend_on_g(two_groups, world1):
    """Chain c's rows start from init_seed + c on any chain mesh: the
    4 chains of G = 2 (2 per rank) are those of G = 1 and of the flat
    engine with 4 chains."""
    cfg, graph, split = W.graph_case(SEED, **CFG)
    one = ShardedChainLearner(cfg, graph, split, 4,
                              make_chain_mesh(1, device="cpu"))
    flat = FlatChainLearner(cfg, graph, split, 4, "cpu")
    assert torch.equal(one.state.pi, flat.state.pi)
    for r in two_groups:
        np.testing.assert_array_equal(r["init_pi"], one.state.pi.numpy())


def test_g1_is_the_flat_chain_engine(world1):
    """G = 1: group 0's streams are the flat engine's, so the run is
    FlatChainLearner's with the same C, bit for bit."""
    cfg, graph, split = W.graph_case(SEED, **CFG)
    one = ShardedChainLearner(cfg, graph, split, 3,
                              make_chain_mesh(1, device="cpu"))
    flat = FlatChainLearner(cfg, graph, split, 3, "cpu")
    for lrn in (one, flat):
        lrn.run(30)
    for f in ("pi", "phi_sum", "theta", "beta"):
        assert torch.equal(getattr(one.state, f), getattr(flat.state, f)), f
    np.testing.assert_array_equal(one.heldout_perplexity(),
                                  flat.heldout_perplexity())


def test_two_groups_train(two_groups):
    """Every chain's held-out perplexity falls; each rank reports all
    four chains (gathered), the same on both ranks."""
    (p0, p1), (q0, q1) = (r["ppx"] for r in two_groups)
    assert p0.shape == p1.shape == (4,)
    assert np.isfinite(p1).all() and (p1 < p0).all()
    np.testing.assert_array_equal(p1, q1)


def test_two_groups_rhat_and_resume(two_groups):
    """R-hat over beta across all four chains is finite and the same on
    both ranks; run, save, run == restore, run on both ranks."""
    r0, r1 = two_groups
    assert r0["rhat"].shape == (8,) and np.isfinite(r0["rhat"]).all()
    np.testing.assert_array_equal(r0["rhat"], r1["rhat"])
    assert r0["resume_equal"] and r1["resume_equal"]


def test_whole_chains_per_rank(two_groups):
    assert "num_chains=3 must be divisible by the chain mesh size 2" in (
        two_groups[0]["guard"])


@pytest.mark.parametrize("kw, match", [
    (dict(rng_backend=RngBackend.REFERENCE, device_sampling=False),
     "native"),
    (dict(phi_impl=PhiImpl.PALLAS, shared_neighbors=False), "jnp"),
    (dict(window=4, shared_neighbors=False), "shared_neighbors"),
])
def test_chain_guards(kw, match, world1):
    """The JAX ShardedChainLearner's guards (chains_sharded.py:77-100)."""
    cfg, graph, split = W.graph_case(SEED, **dict(CFG, **kw))
    with pytest.raises(ValueError, match=match):
        ShardedChainLearner(cfg, graph, split, 2,
                            make_chain_mesh(1, device="cpu"))


def test_chain_mesh_needs_the_ranks(world1):
    with pytest.raises(ValueError, match="chain mesh needs 2 devices, "
                                         "only 1 available"):
        make_chain_mesh(2, device="cpu")


def test_cli_chain_devices_on_two_ranks():
    """`--num-chains 4 --chain-devices 2 --device cpu` on 2 ranks started
    as torchrun starts them: every chain's ppx falls; rank 0 logs the
    [4] vectors and the R-hat line."""
    out = spawn(W.run_cli, 2, (TINY + ["--num-chains", "4",
                                       "--chain-devices", "2",
                                       "--rhat-draws", "2"],),
                timeout=120, launcher=True)
    assert [rc for rc, _ in out] == [0, 0]
    msgs = out[0][1]
    ppx = {int(m.group(1)): np.array(m.group(2).split(), float)
           for m in (re.fullmatch(r"ppx\[(\d+)\] = \[(.*)\]", x)
                     for x in msgs) if m}
    assert sorted(ppx) == [0, 20, 40, 60]
    assert all(p.shape == (4,) for p in ppx.values())
    assert (ppx[60] < ppx[0]).all()
    assert any(m.startswith("4 chains over 2 GPUs (2 per rank)")
               for m in msgs)
    assert sum(m.startswith("beta R-hat over 4 chains") for m in msgs) == 1
    assert not any(m.startswith("ppx[") for m in out[1][1])


def test_cli_chain_devices_mmsb_refused(caplog):
    """--model mmsb chains run on one GPU: the chain mesh is built first
    (at world size 1 it needs 2 devices, as in the JAX CLI)."""
    with caplog.at_level(logging.INFO, logger="mcmc_ammsb_tpu_torch"):
        rc = cli.main(TINY + ["--num-chains", "2", "--model", "mmsb",
                              "--chain-devices", "2"])
    assert rc == 1
    assert any("chain mesh needs 2 devices" in r.getMessage()
               for r in caplog.records)
