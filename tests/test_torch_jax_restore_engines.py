"""Every single-process engine whose npz checkpoint the JAX CLI writes
restores in the port (``checkpoint.load_checkpoint`` through
``interop.jax_leaf_keys``), on the CPU: the JAX package trains the
learner its CLI builds for the arguments 10 steps and saves it; the
port's learner for the same arguments loads the file with every state
leaf bit-equal to the file's (bf16 pi against its float32 leaf, cast back
to bf16), the counters equal, and the port's CLI start for that engine
restores it too, re-seeding its streams once. The sharded engines:
test_torch_jax_restore_sharded.py."""

import jax
import numpy as np
import pytest
import torch

import jax_fixtures as F
import torch_dist_workers as W
from mcmc_ammsb_tpu import chains_flat as jax_chains_flat
from mcmc_ammsb_tpu import checkpoint as jax_checkpoint
from mcmc_ammsb_tpu import learner as jax_learner
from mcmc_ammsb_tpu.models import mmsb as jax_mmsb
from mcmc_ammsb_tpu.parallel import chains_sharded as jax_chains_sharded
from mcmc_ammsb_tpu_torch import checkpoint, cli, interop

TINY = ["--synthetic", "300,8", "-k", "8", "-m", "8", "-n", "8", "-x", "10",
        "-i", "10", "--window-impl", "jnp"]
ENGINES = {
    "Learner": TINY + ["--pi-dtype", "bfloat16"],
    "FullMMSBLearner": TINY + ["--model", "mmsb"],
    "MMSBChainLearner": TINY + ["--model", "mmsb", "--num-chains", "3"],
    "FlatChainLearner": TINY + ["--num-chains", "3", "--pi-dtype",
                                "bfloat16"],
}


def test_leaf_tables_are_the_jax_states_fields():
    """interop.JAX_LEARNERS holds each JAX state's fields in order (the
    reference RNG's seeds sit in TrainState's ``ref_seeds``, which has
    no leaf with the native RNG)."""
    train = tuple(f for f in jax_learner.TrainState._fields
                  if f != "ref_seeds")
    want = {"Learner": train, "ShardedLearner": train,
            "FullMMSBLearner": jax_mmsb.MMSBState._fields,
            "MMSBChainLearner": jax_mmsb.MMSBChainState._fields,
            "FlatChainLearner": jax_chains_flat.ChainState._fields,
            "ShardedChainLearner": jax_chains_sharded.ChainState._fields}
    assert interop.JAX_LEARNERS == want
    assert jax_learner.TrainState._fields.index("ref_seeds") == (
        train.index("neighbor_key") + 1)


@pytest.mark.parametrize("name", list(ENGINES))
def test_jax_file_restores_bit_equal(name, tmp_path, caplog):
    argv = ENGINES[name]
    jl = F.jax_cli_learner(argv)
    assert type(jl).__name__ == name
    jl.heldout_perplexity()
    jl.run(10)
    path = str(tmp_path / "jax.npz")
    jax_checkpoint.save_checkpoint(path, jl)
    step = int(jax.device_get(jl.state.step_count))
    if hasattr(jl, "close"):
        jl.close()

    tl = W.cli_learner(argv)
    assert type(tl).__name__ == name
    checkpoint.load_checkpoint(path, tl)
    F.assert_state_is_the_file(path, F.named_leaves(tl.state))
    assert tl.step_count == step == 11
    if "bfloat16" in argv:
        assert tl.state.pi.dtype == torch.bfloat16
    tl.close()

    with caplog.at_level("INFO", logger="mcmc_ammsb_tpu_torch"):
        assert cli.main(argv + ["--restore", path, "--device", "cpu"]) == 0
    messages = [r.getMessage() for r in caplog.records]
    assert f"restored checkpoint {path} (step=11)" in messages
    assert [m for m in messages if "re-seeded" in m] == [
        "random streams re-seeded at step 11 (checkpoint written by jax)"]
    ppx = [float(m.split(" = ")[1].strip("[]").split()[0])
           for m in messages if m.startswith("ppx[")]
    assert len(ppx) == 2 and np.isfinite(ppx).all()
