"""The JAX package's sharded checkpoints in the port's sharded learners
on 2 gloo ranks (``parallel.dryrun.spawn``, under its deadline): the
JAX package (on the virtual CPU devices of conftest.py) trains the
learner its CLI builds for the arguments 10 steps and saves the global
state, pi's rows padded to the model axis and the batches and running
averages to the data axis; each port rank reads its own rows of the
file (``checkpoint._load_sharded``), and the port's save of what the
ranks hold equals the file leaf for leaf. The CLI's ``--mesh 2,1``
start restores a JAX file on both ranks."""

import json
import os

import numpy as np
import pytest

import jax_fixtures as F
import torch_dist_workers as W
from mcmc_ammsb_tpu import checkpoint as jax_checkpoint
from mcmc_ammsb_tpu_torch import chains_flat, checkpoint, learner
from mcmc_ammsb_tpu_torch.parallel.dryrun import spawn

TINY = ["--synthetic", "300,8", "-k", "8", "-m", "8", "-n", "8", "-x", "10",
        "-i", "10", "--window-impl", "jnp"]
# name -> (arguments, the port state class)
SHARDED = {
    # host-sampled: the pending chunk's batches are padded to 2 data ranks
    "ShardedLearner 2,1 host-sampled": (
        TINY + ["--mesh", "2,1", "--no-device-sampling"],
        learner.TrainState),
    # pi's rows split over 2 model ranks
    "ShardedLearner 1,2": (TINY + ["--mesh", "1,2"], learner.TrainState),
    "ShardedChainLearner G=2": (
        TINY + ["--num-chains", "4", "--chain-devices", "2"],
        chains_flat.ChainState),
}


@pytest.fixture(scope="module")
def restored(tmp_path_factory):
    """{name: (the JAX file, the port's save after the restore, the
    ranks' restored steps)}, and the two ranks' CLI results."""
    d = tmp_path_factory.mktemp("jax_sharded")
    files, calls = {}, []
    for i, (name, (argv, _)) in enumerate(SHARDED.items()):
        jl = F.jax_cli_learner(argv)
        jl.heldout_perplexity()
        jl.run(10)
        if jl.cfg.device_sampling is False:
            # the producer's chunk in flight, padded to the data axis
            jl._pending.append(jl.sampler.sample_many(
                jl.cfg.steps_per_call))
        path, out = str(d / f"jax{i}.npz"), str(d / f"port{i}.npz")
        jax_checkpoint.save_checkpoint(path, jl)
        if hasattr(jl, "close"):
            jl.close()
        files[name] = (path, out)
        calls.append((name, "restore_and_save", (argv, path, out)))
    cli_path = files["ShardedLearner 2,1 host-sampled"][0]
    calls.append(("cli", "run_cli", (
        SHARDED["ShardedLearner 2,1 host-sampled"][0]
        + ["--restore", cli_path, "--device", "cpu"],)))
    ranks = spawn(W.suite, 2, (calls,), timeout=240)
    return files, ranks, cli_path


@pytest.mark.parametrize("name", list(SHARDED))
def test_jax_sharded_file_restores_bit_equal(restored, name):
    files, ranks, _ = restored
    path, out = files[name]
    assert [r[name] for r in ranks] == [11, 11]
    cls = SHARDED[name][1]
    with np.load(out, allow_pickle=False) as z:
        manifest = json.loads(bytes(z["manifest"]).decode())
        assert manifest["learner"] == name.split()[0]
        named = {f: z[f"leaf_{i}"] for i, f in enumerate(cls._fields)}
    F.assert_state_is_the_file(path, named)
    if "--no-device-sampling" not in SHARDED[name][0]:
        return
    with np.load(path, allow_pickle=False) as jz, \
            np.load(out, allow_pickle=False) as pz:
        # the host sampler's state and the pending batches carry over
        for blob in ("sampler_rng", "pending"):
            assert F.same_values(checkpoint._loads(bytes(jz[blob])),
                                 checkpoint._loads(bytes(pz[blob]))), blob


def test_cli_mesh_restores_a_jax_file_on_two_ranks(restored):
    files, ranks, path = restored
    (rc0, log0), (rc1, _) = (r["cli"] for r in ranks)
    assert rc0 == rc1 == 0
    assert f"restored checkpoint {path} (step=11)" in log0
    assert ("random streams re-seeded at step 11 (checkpoint written by "
            "jax)") in log0
    assert os.path.exists(path)
