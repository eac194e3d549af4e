"""The port's CLI on the CPU: the main path end to end at a tiny size,
engines that are not ported yet refused with their ROADMAP item, and no
silent fallback to the CPU when the GPU is asked for."""

import logging
import re

import pytest
import torch

from mcmc_ammsb_tpu_torch import cli

TINY = ["--synthetic", "300,8", "-k", "8", "-m", "8", "-n", "8",
        "-x", "60", "-i", "20", "--steps-per-call", "40", "--window", "4",
        "--device", "cpu"]


@pytest.mark.parametrize("window", ["4", "-1"])
def test_cli_main_path_on_cpu(window, caplog):
    """Windows of 4 (the window engine with tail steps), and --window -1
    (every step through the sequential body)."""
    args = TINY[:TINY.index("--window") + 1] + [window, "--device", "cpu"]
    with caplog.at_level(logging.INFO, logger="mcmc_ammsb_tpu_torch"):
        assert cli.main(args) == 0
    ppx = {int(m.group(1)): float(m.group(2)) for m in
           (re.fullmatch(r"ppx\[(\d+)\] = (\S+)", r.getMessage())
            for r in caplog.records) if m}
    assert sorted(ppx) == [0, 20, 40, 60]
    assert ppx[60] < ppx[0]
    assert any("links:" in r.getMessage() for r in caplog.records)


@pytest.mark.parametrize("flags", [
    ["--mesh", "1,2"], ["--num-chains", "2"], ["--model", "mmsb"],
    ["--rng", "reference"], ["--phi-impl", "pallas"], ["-s", "BF"],
    ["--no-device-sampling"], ["--no-shared-neighbors"],
    ["--checkpoint", "ck.npz"],
    ["--edgeset", "perfect"],
])
def test_cli_refuses_unported_engines(flags, caplog):
    with caplog.at_level(logging.INFO, logger="mcmc_ammsb_tpu_torch"):
        assert cli.main(TINY + flags) == 2
    assert any("ROADMAP" in r.getMessage() for r in caplog.records)


def test_cli_cuda_without_gpu_fails():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert cli.main(TINY[:-1] + ["cuda"]) == 1
