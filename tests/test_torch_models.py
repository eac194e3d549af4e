"""The AMMSB model-family facade (mcmc_ammsb_tpu_torch/models/ammsb.py)
against the JAX package's (the surface check of tests/test_models.py and
a trajectory on the JAX package's own draws), the independent-states
chain engine (chains.MultiChainLearner, --chain-engine vmap) against the
single Learner, and the port's CLI argument parsing against the JAX
CLI's."""

import jax
import numpy as np
import pytest
import torch

from mcmc_ammsb_tpu import cli as jax_cli
from mcmc_ammsb_tpu.learner import DeviceBatch as JaxDeviceBatch
from mcmc_ammsb_tpu.models import AMMSB as JaxAMMSB
from mcmc_ammsb_tpu_torch import chains, cli, config, data, learner
from mcmc_ammsb_tpu_torch.interop import state_from_numpy
from mcmc_ammsb_tpu_torch.models.ammsb import AMMSB
from mcmc_ammsb_tpu_torch.sampling import MiniBatchSampler

from torch_parity import (assert_close, assert_normwise, jax_config,
                          jax_hoist, to_torch)


@pytest.fixture(scope="module")
def dataset():
    n, u, v = data.synthetic_edges(250, 8, seed=51)
    split = data.generate_sets(n, u, v, heldout_ratio=0.1, seed=52)
    return n, split, data.Graph.from_edges(n, split.training_u,
                                           split.training_v)


def _cfg(dataset, **kw):
    n, split, graph = dataset
    return config.Config(K=8, mini_batch_size=8, num_node_sample=4,
                         host_sampler="numpy", **kw).finalize(
        n, split.total_edges, graph.max_fan_out)


def test_ammsb_surface(dataset):
    """init / step / steps / eval, as tests/test_models.py drives the JAX
    facade: 5 steps one at a time, a scanned chunk of 4, an evaluation;
    rows stay normalized; the device is explicit and defaults to the
    card."""
    _, split, graph = dataset
    cfg = _cfg(dataset)
    model = AMMSB(cfg, graph, split, "cpu")
    state, streams = model.init(), model.streams()
    sampler = MiniBatchSampler(cfg, graph, split)
    for _ in range(5):
        state = model.step(state, learner.DeviceBatch.from_host(
            sampler.sample(), "cpu"), streams)
    assert state.step_count == 6 and state.beta_count == 5
    state = model.steps(state, learner.DeviceBatch.from_stacked(
        sampler.sample_many(4), "cpu"), streams)
    assert state.step_count == 10
    state, res = model.eval(state)
    assert np.isfinite(float(res.neg_avg_log)) and state.ppx_count == 1
    torch.testing.assert_close(state.pi.sum(-1), torch.ones(cfg.N),
                               atol=1e-5, rtol=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            AMMSB(cfg, graph, split)


def test_ammsb_facade_matches_jax(dataset):
    """The same 6 steps through both facades from one initial state: the
    JAX facade's step draws from its keys, the port's is handed those
    draws through train_step (what AMMSB.step calls); then steps() on a
    chunk against JAX's, and eval (rtol 1e-5). State normwise rtol 5e-5,
    atol 1e-8 (tests/test_torch_slice.py)."""
    _, split, graph = dataset
    cfg = _cfg(dataset)
    jcfg = jax_config(cfg)
    jm, tm = JaxAMMSB(jcfg, graph, split), AMMSB(cfg, graph, split, "cpu")
    jstate = jm.init()
    tstate = state_from_numpy(
        {f: np.asarray(v) for f, v in jstate._asdict().items()
         if v is not None}, cfg, "cpu")
    stacked = MiniBatchSampler(cfg, graph, split, seed=3).sample_many(10)
    jb = JaxDeviceBatch.from_stacked(stacked)
    tb = learner.DeviceBatch.from_stacked(stacked, "cpu")
    first = lambda b, n: type(b)(*(a[:n] for a in b))          # noqa: E731
    xs = to_torch(jax_hoist(jcfg, jm.training_set, jstate, first(jb, 6)),
                  learner.DeviceBatch)
    jstep = jax.jit(jm.step)
    for i in range(6):
        jstate = jstep(jstate, JaxDeviceBatch(*(a[i] for a in jb)))
        tstate = learner.train_step(
            cfg, tm.training_set, tstate,
            learner.DeviceBatch(*(a[i] for a in tb)), xs[1][i], xs[3][i],
            xs[4][i])
    rest = lambda b: type(b)(*(a[6:] for a in b))              # noqa: E731
    xs = to_torch(jax_hoist(jcfg, jm.training_set, jstate, rest(jb)),
                  learner.DeviceBatch)
    jstate = jax.jit(jm.steps)(jstate, rest(jb))
    tstate = learner.run_hoisted(cfg, tstate, xs)
    assert tstate.step_count == int(jstate.step_count) == 11
    for f in ("pi", "phi_sum", "theta", "beta"):
        assert_normwise(getattr(tstate, f), getattr(jstate, f), 5e-5, 1e-8, f)
    jstate, jres = jax.jit(jm.eval)(jstate)
    tstate, tres = tm.eval(tstate)
    assert_close(tres.neg_avg_log, jres.neg_avg_log, 1e-5, 0.0, "eval")


# ---------------------------------------------------------------------------
# The independent-states chain engine
# ---------------------------------------------------------------------------

FAST = dict(device_sampling=True, shared_neighbors=True, steps_per_call=10)


def test_multi_chain_equals_single_learners(dataset):
    """Chain c of MultiChainLearner is the single Learner built from
    chain_config(cfg, c) (init_seed + c, the chain index folded into
    every stream's seed pair), bit for bit on the CPU: state and
    perplexity after 25 steps in chunks of 10; chain 0 is the plain
    config's Learner; the chains differ."""
    _, split, graph = dataset
    cfg = _cfg(dataset, **FAST)
    assert chains.chain_config(cfg, 0) == cfg
    multi = chains.MultiChainLearner(cfg, graph, split, 3, "cpu")
    p0 = multi.heldout_perplexity()
    multi.run(25)
    ppx = multi.heldout_perplexity()
    assert multi.step_count == 26 and ppx.shape == (3,)
    assert (ppx < p0).all()
    assert not hasattr(multi, "state") and len(multi.states) == 3
    for c in range(3):
        one = learner.Learner(chains.chain_config(cfg, c), graph, split,
                              "cpu")
        one.heldout_perplexity()
        one.run(25)
        # the states bit for bit; the scalar through torch's exp here and
        # numpy's there (as the chain engines of both packages), 1 ulp
        np.testing.assert_allclose(one.heldout_perplexity(), ppx[c],
                                   rtol=3e-7)
        for f in ("pi", "phi_sum", "theta", "beta", "ppx_per_edge"):
            assert torch.equal(getattr(one.state, f),
                               getattr(multi.states[c], f)), (c, f)
    assert not torch.equal(multi.states[0].pi, multi.states[1].pi)
    assert not torch.equal(multi.states[1].theta, multi.states[2].theta)


def test_multi_chain_rhat_and_guards(dataset):
    """beta_rhat gives a finite [K] PSRF (chains.rhat over the kept
    betas); the engine forces device sampling, has no run_with_ppx (the
    CLI asks with hasattr) and keeps the JAX class's guards."""
    n, split, graph = dataset
    cfg = _cfg(dataset, shared_neighbors=True, steps_per_call=8)
    multi = chains.MultiChainLearner(cfg, graph, split, 2, "cpu")
    assert multi.cfg.device_sampling and multi.sampler is None
    assert not hasattr(multi, "run_with_ppx")
    r = multi.beta_rhat(2)
    assert r.shape == (8,) and np.isfinite(r).all()
    assert multi.step_count == 17
    with pytest.raises(ValueError, match="keeps pi in fp32"):
        chains.MultiChainLearner(cfg.replace(pi_dtype="bfloat16"), graph,
                                 split, 2, "cpu")
    empty = data.generate_sets(n, split.training_u, split.training_v,
                               heldout_ratio=0.0, seed=1)
    with pytest.raises(ValueError, match="no held-out edges"):
        chains.MultiChainLearner(cfg, graph, empty, 2, "cpu")
    with pytest.raises(ValueError, match="window > 1"):
        chains.MultiChainLearner(cfg.replace(window=4,
                                             shared_neighbors=False),
                                 graph, split, 2, "cpu")


# ---------------------------------------------------------------------------
# Argument parsing
# ---------------------------------------------------------------------------

def test_cli_arg_parsing_matches_jax():
    """The arguments of tests/test_models.py and the flags this slice
    brings give the same Config fields in both CLIs."""
    argv = ["--synthetic", "100,4", "-k", "64", "-m", "16", "-n", "8",
            "-a", "0.05", "-b", "512", "-c", "0.33", "-e", "1e-6",
            "-r", "0.02", "-s", "BFLink", "--phi-impl", "pallas",
            "--edgeset", "sorted", "--rng", "reference",
            "--steps-per-call", "50", "--device-sampling",
            "--calc-train-ppx", "--train-ppx-ratio", "0.03",
            "--phi-disable-noise", "--window-impl", "jnp",
            "--phi-seed", "7", "8", "--no-ref-rng-block", "--theta-init",
            "libstdc++"]
    mine = cli.config_from_args(cli.build_arg_parser().parse_args(argv))
    theirs = jax_cli.config_from_args(
        jax_cli.build_arg_parser().parse_args(argv))
    assert mine == config.Config(**{
        f: getattr(mine, f) for f in mine.__dataclass_fields__})
    for f in ("K", "mini_batch_size", "num_node_sample", "a", "b", "c",
              "epsilon", "heldout_ratio", "steps_per_call",
              "device_sampling", "calc_train_ppx", "training_ppx_ratio",
              "phi_disable_noise", "window_impl", "phi_seed",
              "ref_rng_block", "theta_init"):
        assert getattr(mine, f) == getattr(theirs, f), f
    for f in ("strategy", "phi_impl", "edgeset_backend", "rng_backend"):
        assert getattr(mine, f).value == getattr(theirs, f).value, f
    assert mine.training_ppx_ratio == 0.03 and mine.phi_disable_noise
    for flag in ("--checkpoint", "--restore", "--dump-file", "--load-file"):
        args = cli.build_arg_parser().parse_args(["--synthetic", "9,2",
                                                  flag, "x"])
        jargs = jax_cli.build_arg_parser().parse_args(["--synthetic", "9,2",
                                                       flag, "x"])
        dest = flag[2:].replace("-", "_")
        assert getattr(args, dest) == getattr(jargs, dest) == "x"
    defaults = cli.build_arg_parser().parse_args(["--synthetic", "9,2"])
    jdefaults = jax_cli.build_arg_parser().parse_args(["--synthetic", "9,2"])
    for dest in ("checkpoint", "restore", "checkpoint_interval", "dump_data",
                 "dump_file", "load_data", "load_file", "cache_format",
                 "train_ppx_ratio", "phi_disable_noise", "window_impl",
                 "checkpoint_backend", "checkpoint_ref", "restore_ref",
                 "split_seed", "mesh", "coordinator", "num_processes",
                 "process_id", "partitioned_ingest", "chain_devices"):
        assert getattr(defaults, dest) == getattr(jdefaults, dest), dest
