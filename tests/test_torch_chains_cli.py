"""The port's CLI with --num-chains on the CPU: the flat chain engine end
to end at a tiny size (per-chain ppx vectors, the R-hat line), the MMSB
chain engine and the vmap engine with a checkpoint and a resume, the
chain flags whose engines are not ported refused with their ROADMAP item,
and the --rhat-draws guard."""

import logging
import re

import numpy as np
import pytest

from mcmc_ammsb_tpu_torch import cli

TINY = ["--synthetic", "300,8", "-k", "8", "-m", "8", "-n", "8",
        "-x", "60", "-i", "20", "--steps-per-call", "40", "--device", "cpu"]


def _run(args, caplog):
    with caplog.at_level(logging.INFO, logger="mcmc_ammsb_tpu_torch"):
        rc = cli.main(args)
    return rc, [r.getMessage() for r in caplog.records]


def _chain_ppx(messages):
    """{step: [C] ppx} from the ``ppx[i] = [c0 c1 ...]`` lines."""
    out = {}
    for msg in messages:
        m = re.fullmatch(r"ppx\[(\d+)\] = \[(.*)\]", msg)
        if m:
            out[int(m.group(1))] = np.array(m.group(2).split(), float)
    return out


@pytest.mark.parametrize("flags", [
    ["--num-chains", "3", "--window", "4", "--rhat-draws", "2"],
    ["--num-chains", "2", "--no-shared-neighbors"],
    ["--num-chains", "3", "--node-coin", "alternate"],
])
def test_cli_chains_on_cpu(flags, caplog):
    """Windows of 4 with tail steps and the R-hat line; private draws
    through the sequential body; the alternate coin (the chip path's).
    Each chain's ppx is logged as one vector per evaluation and ends
    below that chain's ppx[0]."""
    rc, messages = _run(TINY + flags, caplog)
    assert rc == 0
    ppx = _chain_ppx(messages)
    c = int(flags[1])
    assert sorted(ppx) == [0, 20, 40, 60]
    assert all(p.shape == (c,) and np.isfinite(p).all()
               for p in ppx.values())
    assert (ppx[60] < ppx[0]).all()
    assert any(f"{c} chains initialized in" in m for m in messages)
    rhat = [m for m in messages if m.startswith("beta R-hat")]
    if "--rhat-draws" in flags:
        assert len(rhat) == 1
        vals = re.findall(r"(?:max|median) (\S+)", rhat[0])
        assert len(vals) == 2 and np.isfinite(np.array(vals, float)).all()
    else:
        assert not rhat


@pytest.mark.parametrize("flags, rc, message", [
    # ported (item 14): one process is a chain mesh of one rank, so two
    # groups fail as the JAX CLI fails on one device
    (["--num-chains", "2", "--chain-devices", "2"], 1,
     "chain mesh needs 2 devices, only 1 available"),
    (["--num-chains", "2", "--model", "mmsb", "--chain-devices", "2"], 1,
     "chain mesh needs 2 devices, only 1 available"),
    # ported (item 15, bf16 pi): the JAX CLI's behaviour
    (["--num-chains", "2", "--checkpoint", "ck", "--checkpoint-backend",
      "orbax"], 0, "checkpoint saved to ck"),
    (["--num-chains", "2", "--restore-ref", "ck.bin"], 1,
     "--restore-ref imports the reference's single-GPU state"),
    (["--num-chains", "2", "--chain-engine", "vmap", "--pi-dtype",
      "bfloat16"], 1, "the vmap chain engine keeps pi in fp32"),
])
def test_cli_refuses_unported_chain_engines(flags, rc, message, caplog,
                                            tmp_path, monkeypatch):
    """No chain engine of the JAX CLI is refused any more: each flag runs,
    or exits 1 with the JAX CLI's message where the JAX CLI refuses the
    combination (in the run's directory). In one process --chain-devices
    2 exits 1 as on one device (tests/test_torch_chains_sharded.py runs
    two ranks); the directory backend saves a chain run; --restore-ref
    and bf16 pi on the vmap engine are refused as in JAX. The vmap
    engine, the MMSB chains and checkpoints of chain runs are driven by
    test_cli_chain_engines_and_checkpoints below."""
    monkeypatch.chdir(tmp_path)
    got, messages = _run(TINY + flags, caplog)
    assert got == rc
    assert any(message in m and (rc != 2 or "ROADMAP" in m)
               for m in messages)
    if "--checkpoint-backend" in flags:
        assert (tmp_path / "ck" / "streams.npz").is_file()


@pytest.mark.parametrize("flags, rhat, falls", [
    (["--num-chains", "2", "--chain-engine", "vmap"], True, True),
    (["--num-chains", "2", "--model", "mmsb"], False, False),
    (["--num-chains", "2", "--model", "mmsb", "--no-shared-neighbors"],
     False, False),
    (["--num-chains", "3", "--window", "4"], False, True),
])
def test_cli_chain_engines_and_checkpoints(flags, rhat, falls, caplog,
                                           tmp_path):
    """--chain-engine vmap, --model mmsb --num-chains (shared and private
    draws) and the flat engine: a [C] ppx vector per evaluation (falling
    for the a-MMSB; the MMSB sits at the structure-free plateau of 2 on
    this graph), a checkpoint at exit, and a second run that restores it
    at step 61 and trains on."""
    ck = str(tmp_path / "chains.npz")
    first = flags + (["--rhat-draws", "2"] if rhat else [])
    rc, messages = _run(TINY + first + ["--checkpoint", ck], caplog)
    assert rc == 0
    ppx = _chain_ppx(messages)
    c = int(flags[1])
    assert sorted(ppx) == [0, 20, 40, 60]
    assert all(p.shape == (c,) and np.isfinite(p).all() and (p > 1).all()
               for p in ppx.values())
    if falls:
        assert (ppx[60] < ppx[0]).all()
    assert f"checkpoint saved to {ck}" in messages
    assert rhat == any(m.startswith("beta R-hat") for m in messages)
    caplog.clear()
    rc, messages = _run(TINY + flags + ["--restore", ck, "-x", "20"], caplog)
    assert rc == 0
    step = 61 + (2 * 40 if rhat else 0)    # the R-hat draws train on
    assert f"restored checkpoint {ck} (step={step})" in messages
    assert sorted(_chain_ppx(messages)) == [0, 20]
    caplog.clear()
    rc, messages = _run(TINY + ["--restore", ck], caplog)
    assert rc == 1 and any("num_chains" in m for m in messages)


@pytest.mark.parametrize("flags", [
    ["--num-chains", "3", "--rhat-draws", "1"],
    ["--rhat-draws", "2"],
])
def test_cli_rhat_draws_guard_exits_1(flags):
    """R-hat needs >= 2 draws of >= 2 chains (the JAX CLI's guard)."""
    assert cli.main(TINY + flags) == 1


def test_cli_chains_cuda_without_gpu_fails():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert cli.main(TINY[:-1] + ["cuda", "--num-chains", "2"]) == 1
