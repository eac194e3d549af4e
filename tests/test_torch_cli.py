"""The port's CLI on the CPU: the main path, the ``--phi-impl pallas``
paths (host-sampled by default, device-sampled when asked), host
sampling with every strategy, every membership backend, the power-law
surrogate and the full MMSB end to end at a tiny size, the rules of
``resolve_fast_defaults``, the learner guards, engines that are not
ported yet refused with their ROADMAP item, checkpoint and resume, the
dataset cache, training perplexity, the noise-free mode and the golden
twin of the window, and no silent fallback to the CPU when the GPU is
asked for."""

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
    """The JAX CLI's rule (mcmc_ammsb_tpu/cli.py:297-375), flag for flag:
    auto windows for the a-MMSB fast path only — 12 up to 8 chains,
    96 // C up to 16, none past 16 chains or on the vmap chain engine;
    --model mmsb without --window stays sequential, with --window 12
    keeps 12; --phi-impl pallas resolves to host sampling with private
    draws and chunks of min(200, ppx interval), and never windows;
    --no-device-sampling keeps explicit shared draws and windows; the
    breadth-first family is device-sampled with private draws and no
    windows, as in JAX."""
    from mcmc_ammsb_tpu import cli as jax_cli

    cases = [(), ("--model", "mmsb"), ("--model", "mmsb", "--window", "12"),
             ("--phi-impl", "pallas", "--device-sampling"),
             ("--window", "-1"), ("--no-shared-neighbors",),
             ("--phi-impl", "pallas"), ("--phi-impl", "pallas", "-i", "500"),
             ("--phi-impl", "pallas", "-i", "7"),
             ("--phi-impl", "pallas", "--steps-per-call", "1"),
             ("--no-device-sampling",), ("--no-device-sampling", "-i", "50"),
             ("--no-device-sampling", "--shared-neighbors", "--window", "12"),
             ("--no-device-sampling", "--shared-neighbors"),
             ("--no-device-sampling", "--no-shared-neighbors",
              "--steps-per-call", "1", "--phi-impl", "pallas"),
             ("--rng", "reference"), ("--model", "mmsb", "--phi-impl",
                                      "pallas"),
             ("--steps-per-call", "37"), ("-i", "5000")]
    cases += [("-s", s) for s in ("NodeLink", "NodeNonLink")]
    cases += [("-s", s, "--no-device-sampling") for s in
              ("Node", "NodeLink", "NodeNonLink", "BF", "BFLink",
               "BFNonLink")]
    cases += [("-s", s, "--device-sampling") for s in ("BF", "BFLink")]
    cases += [("--num-chains", str(c), "--chain-engine", engine)
              for c in (1, 2, 8, 9, 16, 17) for engine in ("flat", "vmap")]
    fields = ("window", "device_sampling", "shared_neighbors",
              "steps_per_call")
    for flags in cases:
        port = _resolved(*flags)
        jargs = jax_cli.build_arg_parser().parse_args(["--synthetic",
                                                       "300,8", *flags])
        jax_cli.resolve_fast_defaults(jargs)
        for f in fields:
            assert getattr(port, f) == getattr(jargs, f), (flags, f)
    for s in ("BF", "BFLink", "BFNonLink"):
        port, jargs = _resolved("-s", s), jax_cli.build_arg_parser(
        ).parse_args(["--synthetic", "300,8", "-s", s])
        jax_cli.resolve_fast_defaults(jargs)
        assert jargs.device_sampling and port.device_sampling
        assert (port.window, port.shared_neighbors) == (
            jargs.window, jargs.shared_neighbors) == (0, False)
        assert port.steps_per_call == jargs.steps_per_call == 1000
    assert _resolved("--model", "mmsb").window == 0
    assert _resolved("--model", "mmsb", "--window", "12").window == 12
    assert _resolved().window == 12
    assert _resolved("--num-chains", "16").window == 6
    assert _resolved("--num-chains", "17").window == 0
    pallas = _resolved("--phi-impl", "pallas", "-i", "500")
    assert (pallas.device_sampling, pallas.shared_neighbors,
            pallas.steps_per_call, pallas.window) == (False, False, 200, 0)


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


# ---------------------------------------------------------------------------
# The window against the kernel's rule (ops/window.window_plan)
# ---------------------------------------------------------------------------

def _wide_k_config(k=4096):
    """The main path's resolved config at K = ``k`` on a small graph (no
    learner is built)."""
    args = cli.build_arg_parser().parse_args(
        ["--synthetic", "300,8", "-k", str(k), "--device", "cpu"])
    cli.resolve_fast_defaults(args)
    return args, cli.config_from_args(args).finalize(300, 1200, 20)


def _fit_limit(t_win, b_cap, n_smpl, e_cap, k):
    """The least shared memory in which some layout of the kernel (either
    mode, any cluster size that tiles K, any chunk) takes a window of
    ``t_win``: it admits that window and no longer one (the words that
    grow with T do not depend on S)."""
    from mcmc_ammsb_tpu_torch.ops import window
    shape = (t_win, b_cap, n_smpl, e_cap, k)
    return min(min(window.window_smem_bytes(*shape, s),
                   *(window.window_wide_smem_bytes(*shape, s, wc)
                     for wc in window.WIDE_CHUNKS))
               for s in range(1, window.MAX_CLUSTER + 1)
               if window._tiles(k, s))


def test_fit_window_rule():
    """fit_window keeps a T the kernel's plan admits (T = 12 at K = 4096
    and the main path's B = 33, n = 32, E = 32 on an H100), clamps an
    automatic T it refuses to the largest of WINDOW_CLAMP below it that
    it admits, gives 0 when it admits none, and raises for an explicit
    T it refuses."""
    from mcmc_ammsb_tpu_torch.ops import window
    h100 = window.H100_SMEM
    assert cli.fit_window(12, True, 33, 32, 32, 4096, h100) == 12
    assert cli.fit_window(12, False, 33, 32, 32, 16384, h100) == 12
    assert cli.fit_window(64, False, 33, 32, 32, 16384, h100) == 64
    limit = _fit_limit(4, 33, 32, 32, 4096)
    assert cli.fit_window(12, True, 33, 32, 32, 4096, limit) == 4
    assert cli.fit_window(3, True, 33, 32, 32, 4096, limit) == 3
    assert cli.fit_window(12, True, 33, 32, 32, 4096, 1000) == 0
    with pytest.raises(ValueError, match="fits 1000 B"):
        cli.fit_window(12, False, 33, 32, 32, 4096, 1000)
    with pytest.raises(ValueError, match="<= 64 steps"):
        cli.fit_window(65, False, 33, 32, 32, 256, h100)


def test_auto_window_clamped_and_logged(monkeypatch, caplog):
    """On a card whose blocks fit a window of 4 but not of 6 at K = 4096,
    the main path's automatic 12 is clamped to 4 and logged in the JAX
    CLI's words; where none fits it becomes 0; at the H100's limit 12
    stays. The limit is passed in through kernel_smem_limit, which gives
    None on the CPU (nothing is clamped there)."""
    from mcmc_ammsb_tpu_torch.ops import window
    args, cfg = _wide_k_config()
    assert args.window_auto and cfg.window == 12
    dev = torch.device("cpu")
    assert cli.kernel_smem_limit(dev) is None
    assert cli.resolve_kernel_window(args, cfg, dev).window == 12
    shape = (cfg.max_batch_nodes, cfg.num_node_sample, cfg.max_batch_edges,
             cfg.K)
    for limit, want in ((_fit_limit(4, *shape), 4), (1000, 0),
                        (window.H100_SMEM, 12)):
        monkeypatch.setattr(cli, "kernel_smem_limit", lambda d, x=limit: x)
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="mcmc_ammsb_tpu_torch"):
            got = cli.resolve_kernel_window(args, cfg, dev)
        assert got.window == want
        clamped = [r.getMessage() for r in caplog.records
                   if "window auto-clamped" in r.getMessage()]
        if want == 12:
            assert clamped == []
        else:
            assert len(clamped) == 1
            assert clamped[0].startswith(f"window auto-clamped 12 -> {want} (")


def test_explicit_window_that_does_not_fit_exits_1(monkeypatch, caplog):
    """An explicit --window that the kernel's plan refuses on the card
    ends the run with exit 1 and the plan's reason, before any learner is
    built or any step trained: never a traceback from the first window.
    The card's limit is passed in through kernel_smem_limit; the same
    run with the automatic window trains, clamped."""
    built = []
    real = cli.make_learner
    monkeypatch.setattr(cli, "make_learner",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    monkeypatch.setattr(cli, "kernel_smem_limit", lambda d: 1000)
    with caplog.at_level(logging.INFO, logger="mcmc_ammsb_tpu_torch"):
        assert cli.main(TINY) == 1
    messages = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("--window 4: window kernel: (T, B, n, E, K) = "
                            "(4, ") and "fits 1000 B" in m
               for m in messages)
    assert not built
    assert not any(m.startswith("ppx[") for m in messages)
    caplog.clear()
    auto = [a for a in TINY if a not in ("--window", "4")]
    with caplog.at_level(logging.INFO, logger="mcmc_ammsb_tpu_torch"):
        assert cli.main(auto) == 0
    messages = [r.getMessage() for r in caplog.records]
    assert "window auto-clamped 12 -> 0" in " ".join(messages)
    assert built and any(m.startswith("ppx[60] = ") for m in messages)


@pytest.mark.parametrize("flags, rc, message", [
    # ported (item 14): at world size 1 the JAX CLI's behaviour
    (["--mesh", "1,2"], 1, "mesh 1x2 needs 2 devices, only 1 available"),
    (["--num-chains", "2", "--chain-devices", "2"], 1,
     "chain mesh needs 2 devices, only 1 available"),
    (["--split-seed", "7"], 0, "ppx[60] = "),
    # ported (bf16 pi, item 15): the JAX CLI's behaviour
    (["--pi-dtype", "bfloat16"], 0, "ppx[60] = "),
    (["--checkpoint", "ck", "--checkpoint-backend", "orbax"], 0,
     "checkpoint saved to ck"),
    (["--restore-ref", "ck.bin", "--model", "mmsb"], 1,
     "--restore-ref imports the reference's single-GPU state"),
    (["--checkpoint-ref", "ck.bin"], 0,
     "reference-format checkpoint saved to ck.bin (step=61)"),
])
def test_cli_refuses_unported_engines(flags, rc, message, caplog, tmp_path,
                                      monkeypatch):
    """No engine of the JAX CLI is refused any more: every flag runs, or
    exits 1 with the JAX CLI's message where the JAX CLI refuses the
    combination (in the run's directory). In one process (world size 1)
    --mesh 1,2 and --chain-devices 2 fail as the JAX CLI fails on one
    device; --split-seed outside --partitioned-ingest trains as without
    it (the JAX CLI reads it only there); --pi-dtype bfloat16 trains;
    --checkpoint-backend orbax writes a directory; --restore-ref refuses
    --model mmsb; --checkpoint-ref writes the reference-format file. The
    engines are driven end to end below, in tests/test_torch_chains_cli.py,
    test_torch_rng_reference.py, test_torch_profiling.py,
    test_torch_sharded.py, test_torch_bf16.py and
    test_torch_refckpt.py."""
    monkeypatch.chdir(tmp_path)
    with caplog.at_level(logging.INFO, logger="mcmc_ammsb_tpu_torch"):
        assert cli.main(TINY + flags) == rc
    messages = [r.getMessage() for r in caplog.records]
    assert any(message in m and (rc != 2 or "ROADMAP" in m)
               for m in messages)
    if "--checkpoint-backend" in flags:
        assert (tmp_path / "ck" / "manifest.json").is_file()
    if "--checkpoint-ref" in flags:
        assert (tmp_path / "ck.bin").stat().st_size > 0


def _messages(args, caplog, rc=0):
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="mcmc_ammsb_tpu_torch"):
        assert cli.main(args) == rc
    return [r.getMessage() for r in caplog.records]


def _series(messages, name="ppx"):
    return {int(m.group(1)): float(m.group(2)) for m in
            (re.fullmatch(name + r"\[(\d+)\] = (\S+)", msg)
             for msg in messages) if m}


@pytest.mark.parametrize("flags", [
    ["--window", "4"],
    ["--window", "4", "--calc-train-ppx"],
    ["--model", "mmsb", "--window", "4"],
    ["--model", "mmsb", "--no-device-sampling"],
    ["--no-device-sampling", "--steps-per-call", "7"],
    ["--no-device-sampling", "--no-shared-neighbors", "--steps-per-call", "1",
     "--phi-impl", "pallas"],
])
def test_cli_checkpoint_then_restore(flags, caplog, tmp_path):
    """--checkpoint with --checkpoint-interval 20 saves at the eval-loop
    boundaries the interval reaches and once more at exit; --restore
    resumes at step 61, logs the restored step, evaluates ppx[0] (one more
    evaluation, as in the JAX CLI: the series of a resumed run is not
    that of an uninterrupted one) and trains on; a checkpoint of another
    learner class exits 1 with the loader's message."""
    ck = str(tmp_path / "run.npz")
    base = TINY[:TINY.index("--window")] + ["--device", "cpu"] + flags
    messages = _messages(base + ["--checkpoint", ck,
                                 "--checkpoint-interval", "20"], caplog)
    saves = [m for m in messages if m.startswith("checkpoint saved to")]
    assert saves[-1] == f"checkpoint saved to {ck}"
    steps = [int(re.search(r"\(step (\d+)\)", m).group(1))
             for m in saves[:-1]]
    # device-sampled runs group 40 steps per fused call: boundaries at 40
    # and 60; the host loop reaches every interval
    assert steps == ([40, 60] if "--no-device-sampling" not in flags
                     else [20, 40, 60])
    first = _series(messages)
    messages = _messages(base + ["--restore", ck, "-x", "40"], caplog)
    assert f"restored checkpoint {ck} (step=61)" in messages
    resumed = _series(messages)
    assert sorted(resumed) == [0, 20, 40]
    assert all(1.0 < p < float("inf") for p in resumed.values())
    if "mmsb" not in flags:
        assert resumed[40] < first[0]
    if "--calc-train-ppx" in flags:
        assert sorted(_series(messages, "train_ppx")) == [20, 40]
    other = (["--model", "mmsb"] if "mmsb" not in flags else [])
    messages = _messages(TINY[:TINY.index("--window")]
                         + ["--device", "cpu"] + other + ["--restore", ck],
                         caplog, rc=1)
    assert any("state leaves" in m for m in messages)


def test_cli_sigint_saves_a_checkpoint(caplog, tmp_path, monkeypatch):
    """After SIGINT the loop drains at the next boundary, logs FORCED
    TERMINATE and still saves: the run resumes from where it stopped."""
    import os
    import signal

    from mcmc_ammsb_tpu_torch import learner as learner_mod

    ck = str(tmp_path / "int.npz")
    run = learner_mod.Learner.run

    def interrupted(self, max_iters):
        run(self, max_iters)
        os.kill(os.getpid(), signal.SIGINT)

    monkeypatch.setattr(learner_mod.Learner, "run", interrupted)
    args = HOST + ["--no-device-sampling", "--checkpoint", ck]
    messages = _messages(args, caplog)
    assert "FORCED TERMINATE" in messages
    assert f"checkpoint saved to {ck}" in messages
    monkeypatch.setattr(learner_mod.Learner, "run", run)
    messages = _messages(HOST + ["--no-device-sampling", "--restore", ck,
                                 "-x", "20"], caplog)
    assert f"restored checkpoint {ck} (step=21)" in messages


@pytest.mark.parametrize("fmt", ["npz", "ref"])
def test_cli_dump_then_load_data(fmt, caplog, tmp_path):
    """--dump-data writes the cache and exits 0 without training;
    --load-data trains on it with the held-out ratio from the file: the
    same ppx[0] as the run on the generated graph (the ratio 0.125 is
    exact in the reference layout's float32)."""
    cache = str(tmp_path / "graph.cache")
    gen = ["--synthetic", "300,8", "--heldout-ratio", "0.125"]
    tail = ["-k", "8", "-m", "8", "-n", "8", "-x", "20", "-i", "20",
            "--device", "cpu"]
    messages = _messages(gen + tail + ["--dump-data", "--dump-file", cache,
                                       "--cache-format", fmt], caplog)
    assert not _series(messages)
    assert any(m.startswith(f"dataset cache ({fmt}) written") for m in messages)
    loaded = _messages(tail + ["--load-data", "--load-file", cache], caplog)
    assert any(m.startswith(f"Loaded {cache} (N=300") for m in loaded)
    assert "heldout_ratio=0.125" in next(m for m in loaded
                                         if m.startswith("config: "))
    direct = _messages(gen + tail, caplog)
    assert _series(loaded) == _series(direct) and len(_series(direct)) == 2
    assert cli.main(tail + ["--load-data"]) == 1
    assert cli.main(gen + tail + ["--dump-data"]) == 1


def test_cli_train_ppx_lines(caplog):
    """--calc-train-ppx --train-ppx-ratio: a train_ppx[i] line after
    every ppx[i] but ppx[0], from the fused series and from the host
    loop; without the flag none; the MMSB learner keeps no training
    population and logs none."""
    base = TINY[:TINY.index("--window")] + ["--device", "cpu"]
    flags = ["--calc-train-ppx", "--train-ppx-ratio", "0.05"]
    for extra in (["--window", "4"], ["--no-device-sampling"]):
        messages = _messages(base + extra + flags, caplog)
        train = _series(messages, "train_ppx")
        assert sorted(train) == [20, 40, 60]
        assert all(1.0 < p < float("inf") for p in train.values())
        order = [m.split("[")[0] for m in messages
                 if m.startswith(("ppx[", "train_ppx["))]
        assert order == ["ppx"] + ["ppx", "train_ppx"] * 3
        assert "training_ppx_ratio=0.05" in _config_echo(caplog)
    assert not _series(_messages(base + ["--window", "4"], caplog),
                       "train_ppx")
    assert not _series(_messages(base + ["--model", "mmsb"] + flags, caplog),
                       "train_ppx")


def test_cli_noise_free_and_window_impl(caplog):
    """--phi-disable-noise trains (a deterministic phi update) and
    --window-impl jnp gives the default's series on the CPU, character
    for character; the log says which version of the window runs."""
    base = TINY[:TINY.index("--window")] + ["--device", "cpu", "--window", "4"]
    default = _messages(base + ["--phi-disable-noise"], caplog)
    assert "phi_disable_noise=True" in _config_echo(caplog)
    assert any("windows of 4 steps run the plain PyTorch version of the "
               "window (--window-impl pallas on cpu)" in m for m in default)
    golden = _messages(base + ["--phi-disable-noise", "--window-impl", "jnp"],
                       caplog)
    assert any("(--window-impl jnp on cpu)" in m for m in golden)
    lines = [[m for m in ms if m.startswith("ppx[")]
             for ms in (default, golden)]
    assert len(lines[0]) == 4 and lines[0] == lines[1]
    series = _series(default)
    assert series[60] < series[0]
    noisy = _series(_messages(base, caplog))
    assert noisy[0] == series[0] and noisy[60] != series[60]


HOST = ["--synthetic", "400,12", "-k", "16", "-x", "60", "-i", "20",
        "--device", "cpu"]


def _config_echo(caplog):
    return next(r.getMessage() for r in caplog.records
                if r.getMessage().startswith("config: "))


def test_cli_phi_pallas_resolves_to_host_sampling(caplog):
    """--phi-impl pallas without --device-sampling is the JAX CLI's
    resolution: host batches, private draws, chunks of min(200, i)."""
    ppx = _ppx_series(["--phi-impl", "pallas"] + HOST, caplog)
    echo = _config_echo(caplog)
    for want in ("device_sampling=False", "shared_neighbors=False",
                 "steps_per_call=20", "window=0", "'pallas'"):
        assert want in echo, want
    assert sorted(ppx) == [0, 20, 40, 60] and ppx[60] < ppx[0]
    assert any(r.getMessage().startswith("host sampler: ")
               for r in caplog.records)


def test_cli_reference_exact_slow_path(caplog):
    """--no-device-sampling --no-shared-neighbors --steps-per-call 1: one
    train_step per step, with either phi."""
    slow = ["--no-device-sampling", "--no-shared-neighbors",
            "--steps-per-call", "1"]
    ppx = _ppx_series(slow + ["--phi-impl", "pallas"] + HOST, caplog)
    assert "steps_per_call=1," in _config_echo(caplog)
    assert sorted(ppx) == [0, 20, 40, 60] and ppx[60] < ppx[0]


@pytest.mark.parametrize("strategy", ["Node", "NodeLink", "NodeNonLink",
                                      "BF", "BFLink", "BFNonLink"])
def test_cli_host_sampling_every_strategy(strategy, caplog):
    """A finite series for every strategy; it falls where the strategy
    shows the sampler links. (Non-links alone push the held-out links'
    likelihood down: with NodeNonLink the JAX CLI's series rises too,
    5.18 -> 7.35 on this graph.)"""
    ppx = _ppx_series(["--no-device-sampling", "-s", strategy] + HOST,
                      caplog)
    assert sorted(ppx) == [0, 20, 40, 60]
    assert all(1.0 < p < float("inf") for p in ppx.values())
    if strategy in ("Node", "NodeLink", "BF", "BFLink"):
        assert ppx[60] < ppx[0]
    assert "device_sampling=False" in _config_echo(caplog)


def test_cli_host_sampled_windows(caplog):
    """--no-device-sampling --shared-neighbors --window 4: the window
    engine on host batches (padded lanes hold id 0)."""
    ppx = _ppx_series(["--no-device-sampling", "--shared-neighbors",
                       "--window", "4"] + HOST, caplog)
    assert "window=4," in _config_echo(caplog) and ppx[60] < ppx[0]


@pytest.fixture(scope="module")
def adjacency_series():
    import logging as _logging

    records = []
    handler = _logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logger = _logging.getLogger("mcmc_ammsb_tpu_torch")
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(_logging.INFO)
    try:
        assert cli.main(["--edgeset", "adjacency"] + HOST) == 0
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    return [m for m in records if m.startswith("ppx[")]


@pytest.mark.parametrize("backend", ["perfect", "csr", "sorted", "cuckoo"])
def test_cli_edgeset_backends_give_the_adjacency_series(backend, caplog,
                                                        adjacency_series):
    """Membership is exact, so every backend trains the same bits: the
    ppx lines equal the adjacency run's, character for character."""
    with caplog.at_level(logging.INFO, logger="mcmc_ammsb_tpu_torch"):
        assert cli.main(["--edgeset", backend] + HOST) == 0
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("ppx[")]
    assert len(lines) == 4 and lines == adjacency_series
    assert any(r.getMessage() == f"edge sets: training {backend}, held-out "
               f"{backend}" for r in caplog.records)


def test_cli_synthetic_powerlaw(caplog):
    """The degree-realistic surrogate. With hubs past 63 neighbors the
    hub-padded batches switch the auto window off (max_batch_nodes > 64),
    and --ds-link-cap, which caps the lanes, keeps it."""
    tail = ["-k", "16", "-x", "40", "-i", "20", "--device", "cpu"]
    ppx = _ppx_series(["--synthetic-powerlaw", "3000,6.6,60,8"] + tail,
                      caplog)
    assert sorted(ppx) == [0, 20, 40] and ppx[40] < ppx[0]
    caplog.clear()
    hubby = ["--synthetic-powerlaw", "3000,6.6,150,8"] + tail
    ppx = _ppx_series(hubby, caplog)
    assert any("window auto-disabled" in r.getMessage()
               for r in caplog.records)
    assert "window=0," in _config_echo(caplog) and ppx[40] < ppx[0]
    caplog.clear()
    ppx = _ppx_series(hubby + ["--ds-link-cap", "32", "--edgeset",
                               "perfect"], caplog)
    assert "window=12," in _config_echo(caplog) and ppx[40] < ppx[0]


def test_cli_cuda_without_gpu_fails():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert cli.main(TINY[:-1] + ["cuda"]) == 1


@pytest.mark.parametrize("engine", ["Learner", "FlatChainLearner",
                                    "FullMMSBLearner", "MMSBChainLearner",
                                    "MultiChainLearner"])
def test_learners_default_to_the_card(engine, monkeypatch):
    """The entry points run on the card unless the caller asks for the
    CPU: constructed without a device on a machine without CUDA (forced
    here), each raises, naming the way to the CPU, before anything is
    built; it never quietly runs on the CPU."""
    from mcmc_ammsb_tpu_torch import chains, chains_flat
    from mcmc_ammsb_tpu_torch.models import mmsb

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config.Config(K=8, device_sampling=True, shared_neighbors=True)
    make = {"Learner": lambda: learner.Learner(cfg, None, None),
            "FlatChainLearner": lambda: chains_flat.FlatChainLearner(
                cfg, None, _NoHeldout(), 2),
            "FullMMSBLearner": lambda: mmsb.FullMMSBLearner(
                cfg.replace(window=4), None, None),
            "MMSBChainLearner": lambda: mmsb.MMSBChainLearner(
                cfg, None, _NoHeldout(), 2),
            "MultiChainLearner": lambda: chains.MultiChainLearner(
                cfg, None, _NoHeldout(), 2)}[engine]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


class _NoHeldout:
    """A split with one held-out edge (FlatChainLearner checks that
    there is one before its device)."""

    heldout_edges_u = [0]
