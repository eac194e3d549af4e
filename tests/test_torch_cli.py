"""The port's CLI on the CPU: the main path, the ``--phi-impl pallas``
path and the full MMSB end to end at a tiny size, the window rule of
``resolve_fast_defaults``, the learner guards, engines that are not
ported yet refused with their ROADMAP item, and no silent fallback to
the CPU when the GPU is asked for."""

import logging
import re

import pytest
import torch

from mcmc_ammsb_tpu_torch import cli, config, learner
from mcmc_ammsb_tpu_torch.config import PhiImpl

TINY = ["--synthetic", "300,8", "-k", "8", "-m", "8", "-n", "8",
        "-x", "60", "-i", "20", "--steps-per-call", "40", "--window", "4",
        "--device", "cpu"]


@pytest.mark.parametrize("window", ["4", "-1"])
def test_cli_main_path_on_cpu(window, caplog):
    """Windows of 4 (the window engine with tail steps), and --window -1
    (every step through the sequential body)."""
    args = TINY[:TINY.index("--window") + 1] + [window, "--device", "cpu"]
    ppx = _ppx_series(args, caplog)
    assert sorted(ppx) == [0, 20, 40, 60]
    assert ppx[60] < ppx[0]
    assert any("links:" in r.getMessage() for r in caplog.records)


def _ppx_series(args, caplog):
    with caplog.at_level(logging.INFO, logger="mcmc_ammsb_tpu_torch"):
        assert cli.main(args) == 0
    return {int(m.group(1)): float(m.group(2)) for m in
            (re.fullmatch(r"ppx\[(\d+)\] = (\S+)", r.getMessage())
             for r in caplog.records) if m}


@pytest.mark.parametrize("flags", [
    ["--phi-impl", "pallas", "--device-sampling"],
    ["--model", "mmsb", "--window", "4"],
    ["--model", "mmsb", "--window", "4", "--mmsb-prior-diag", "1", "5",
     "--mmsb-noise-scale", "0.5"],
    ["--model", "mmsb", "--no-shared-neighbors"],
])
def test_cli_new_paths_on_cpu(flags, caplog):
    """The --phi-impl pallas path (private draws, the phi kernel's plain
    version here) and the full MMSB (windows of 4 with tail steps, the
    identifiability knobs, private draws) print a finite ppx series at
    every interval. (The full MMSB's perplexity on a structure-free
    graph hovers at the coin-flip bound of 2, so its fall is not
    asserted here; tests/test_torch_mmsb.py trains it on a planted
    partition.)"""
    base = TINY[:TINY.index("--window")] + ["--device", "cpu"]
    ppx = _ppx_series(base + flags, caplog)
    assert sorted(ppx) == [0, 20, 40, 60]
    assert all(p == p and 1.0 < p < float("inf") for p in ppx.values())
    if "pallas" in flags:
        assert ppx[60] < ppx[0]


def _resolved(*flags):
    args = cli.build_arg_parser().parse_args(["--synthetic", "300,8",
                                               *flags])
    cli.resolve_fast_defaults(args)
    return args


def test_window_rule_matches_jax():
    """The JAX CLI's rule (mcmc_ammsb_tpu/cli.py:348-375): auto windows
    for the a-MMSB fast path only — 12 up to 8 chains, 96 // C up to 16,
    none past 16 chains or on the vmap chain engine. --model mmsb without
    --window stays sequential, with --window 12 keeps 12; --phi-impl
    pallas draws privately and never windows."""
    from mcmc_ammsb_tpu import cli as jax_cli

    cases = [(), ("--model", "mmsb"), ("--model", "mmsb", "--window", "12"),
             ("--phi-impl", "pallas", "--device-sampling"),
             ("--window", "-1"), ("--no-shared-neighbors",)]
    cases += [("--num-chains", str(c), "--chain-engine", engine)
              for c in (1, 2, 8, 9, 16, 17) for engine in ("flat", "vmap")]
    for flags in cases:
        port = _resolved(*flags)
        jargs = jax_cli.build_arg_parser().parse_args(["--synthetic",
                                                       "300,8", *flags])
        jax_cli.resolve_fast_defaults(jargs)
        for f in ("window", "device_sampling", "shared_neighbors",
                  "steps_per_call"):
            assert getattr(port, f) == getattr(jargs, f), (flags, f)
    assert _resolved("--model", "mmsb").window == 0
    assert _resolved("--model", "mmsb", "--window", "12").window == 12
    assert _resolved().window == 12
    assert _resolved("--num-chains", "16").window == 6
    assert _resolved("--num-chains", "17").window == 0


@pytest.mark.parametrize("bad", [
    dict(shared_neighbors=True, phi_impl=PhiImpl.PALLAS),
    dict(pi_dtype="bfloat16", phi_impl=PhiImpl.PALLAS),
    dict(window=4, phi_impl=PhiImpl.PALLAS),
    dict(window=4, shared_neighbors=False),
])
def test_learner_guards_raise(bad):
    """The JAX Learner's guards (learner.py:859-881) raise ValueError
    before anything is built; the CLI turns them into exit 1."""
    cfg = config.Config(K=8, device_sampling=True,
                        **{"shared_neighbors": False, **bad})
    with pytest.raises(ValueError):
        learner.Learner(cfg, None, None, "cpu")


def test_cli_guard_exits_1():
    assert cli.main(TINY + ["--no-shared-neighbors"]) == 1


@pytest.mark.parametrize("flags", [
    ["--mesh", "1,2"], ["--num-chains", "2", "--chain-engine", "vmap"],
    ["--model", "mmsb", "--num-chains", "2"],
    ["--rng", "reference"], ["--phi-impl", "pallas"], ["-s", "BF"],
    ["--no-device-sampling"], ["--pi-dtype", "bfloat16"],
    ["--checkpoint", "ck.npz"],
    ["--edgeset", "perfect"],
    ["--model", "mmsb", "--restore", "ck.npz"],
])
def test_cli_refuses_unported_engines(flags, caplog):
    """Exit 2, naming the ROADMAP item. ``--phi-impl pallas`` without
    --device-sampling resolves to host sampling, item 7. Of the chain
    engines only the flat one is ported: the vmap engine is item 12,
    the MMSB chains item 11 (tests/test_torch_chains_cli.py has the
    rest)."""
    with caplog.at_level(logging.INFO, logger="mcmc_ammsb_tpu_torch"):
        assert cli.main(TINY + flags) == 2
    assert any("ROADMAP" in r.getMessage() for r in caplog.records)
    if flags == ["--phi-impl", "pallas"]:
        assert any("item 7" in r.getMessage() for r in caplog.records)
    if "--chain-engine" in flags:
        assert any("item 12" in r.getMessage() for r in caplog.records)
    if flags == ["--model", "mmsb", "--num-chains", "2"]:
        assert any("item 11" in r.getMessage() for r in caplog.records)


def test_cli_cuda_without_gpu_fails():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert cli.main(TINY[:-1] + ["cuda"]) == 1


@pytest.mark.parametrize("engine", ["Learner", "FlatChainLearner",
                                    "FullMMSBLearner"])
def test_learners_default_to_the_card(engine, monkeypatch):
    """The entry points run on the card unless the caller asks for the
    CPU: constructed without a device on a machine without CUDA (forced
    here), each raises, naming the way to the CPU, before anything is
    built; it never quietly runs on the CPU."""
    from mcmc_ammsb_tpu_torch import chains_flat
    from mcmc_ammsb_tpu_torch.models import mmsb

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config.Config(K=8, device_sampling=True, shared_neighbors=True)
    make = {"Learner": lambda: learner.Learner(cfg, None, None),
            "FlatChainLearner": lambda: chains_flat.FlatChainLearner(
                cfg, None, _NoHeldout(), 2),
            "FullMMSBLearner": lambda: mmsb.FullMMSBLearner(
                cfg.replace(window=4), None, None)}[engine]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


class _NoHeldout:
    """A split with one held-out edge (FlatChainLearner checks that
    there is one before its device)."""

    heldout_edges_u = [0]
