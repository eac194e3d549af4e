"""The port's stage profile (utils/profiling.py, the Learner's profile
methods, --profile) and window autotuner (autotune.py,
--auto-tune-window) on the CPU: the JAX package's stage names, the
stage ranges free when no trace runs, a traced CPU run attributed by
stage, the unfused fallback when a trace is empty, and the autotuner's
rules with a fake learner and clock, as tests/test_autotune.py:143-211
pins the JAX package's."""

import logging
import re

import pytest
import torch

from mcmc_ammsb_tpu.utils import profiling as jax_profiling
from mcmc_ammsb_tpu_torch import autotune, cli, config, learner
from mcmc_ammsb_tpu_torch.chains_flat import FlatChainLearner
from mcmc_ammsb_tpu_torch.data import Graph, generate_sets, synthetic_edges
from mcmc_ammsb_tpu_torch.ops import window
from mcmc_ammsb_tpu_torch.utils import profiling


def tiny(**kw):
    base = dict(K=8, mini_batch_size=8, num_node_sample=4, steps_per_call=8,
                device_sampling=True, shared_neighbors=True)
    base.update(kw)
    n, u, v = synthetic_edges(300, 8, seed=1)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=2)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = config.Config(**base).finalize(n, split.total_edges,
                                         graph.max_fan_out)
    return cfg, graph, split


def test_stage_names_are_the_jax_packages():
    """JAX's list first, then the port's additions: the two BF
    sub-stages its device sampler opens (``ds_bf_link``,
    ``ds_bf_nonlink``) but its list lacks, and the port's own spans."""
    jax_names = jax_profiling.STAGE_NAMES
    assert profiling.STAGE_NAMES[:len(jax_names)] == jax_names
    assert profiling.STAGE_NAMES[len(jax_names):] == (
        "ds_bf_link", "ds_bf_nonlink", "call", "chunk", "window_tail",
        "readback", "device_wait")


def test_stage_is_free_without_a_trace():
    """Outside a trace every stage is the same shared null context;
    inside one it is a profiler range."""
    assert profiling.stage("phi_update") is profiling.stage("ppx")
    seen = []
    profiling.profile_trace(lambda: seen.append(profiling.stage("ppx")))
    assert isinstance(seen[0], torch.profiler.record_function)
    assert profiling._active == 0


def test_attribute_launches_innermost_range():
    """Each launch goes to the innermost range open at its time (ranges
    nest, a sibling ends before the next starts), else to 'other'."""
    ranges = [(0, 10, "a"), (2, 4, "b"), (5, 8, "c"), (6, 7, "d"),
              (20, 30, "e")]
    launches = [(1, 1.0), (3, 2.0), (4, 4.0), (6.5, 8.0), (7.5, 16.0),
                (9, 32.0), (15, 64.0), (25, 128.0), (31, 256.0)]
    got = profiling.attribute_launches(ranges, launches)
    assert dict(got) == {"a": 1.0 + 32.0, "b": 2.0 + 4.0, "d": 8.0,
                         "c": 16.0, "e": 128.0, "other": 64.0 + 256.0}


@pytest.mark.parametrize("flags", [dict(window=4),
                                   dict(window=0, strategy=config.
                                        SampleStrategy.BF_LINK,
                                        shared_neighbors=False)])
def test_profile_trace_attributes_a_cpu_run(flags):
    """A traced CPU run of the learner: CPU-op time by the JAX package's
    stage names and the BF sub-stages (nested stages once, the rest in
    'other'), adding up to the traced total."""
    cfg, graph, split = tiny(**flags)
    lrn = learner.Learner(cfg, graph, split, "cpu")
    lrn.run(8)
    prof = profiling.profile_trace(lambda: lrn.run(16))
    assert prof["source"] == "cpu" and prof["total_op_seconds"] > 0
    stages = prof["stages"]
    assert set(stages) <= set(profiling.STAGE_NAMES) | {"other"}
    want = ({"window_kernel", "window_correct"} if cfg.window
            else {"phi_update", "pi_scatter", "beta_grads", "ds_bf_link"})
    assert want | {"device_sampling", "neighbor_draws", "membership"} \
        <= set(stages)
    assert all(v >= 0 for v in stages.values())
    assert sum(stages.values()) == pytest.approx(prof["total_op_seconds"],
                                                 rel=1e-6)


def _lines(fn):
    out = []
    fn(out.append)
    return out


def test_learner_stage_profile_and_fallback(monkeypatch):
    """print_stage_profile: the traced table over whole chunks (200 steps
    by default, 16 here); an empty trace falls back to the unfused upper bounds,
    saying so, as the JAX Learner does; the chain engine has no
    fallback."""
    cfg, graph, split = tiny(window=4)
    lrn = learner.Learner(cfg, graph, split, "cpu")
    lines = _lines(lambda log: lrn.print_stage_profile(log, iters=20))
    assert lines[0].startswith("fused per-step stage profile over 16 ")
    assert any(x.startswith("WINDOW_KERNEL") for x in lines)
    assert lrn.step_count == 1 + 8 + 16

    empty = dict(stages={}, total_op_seconds=0.0, source="none")
    monkeypatch.setattr(profiling, "profile_trace", lambda run: dict(empty))
    lines = _lines(lambda log: lrn.print_stage_profile(log, iters=8))
    assert lines[0].startswith("trace captured no attributable device ops")
    assert lines[1].startswith("per-step stage profile (unfused upper")
    assert [x.split(":")[0].strip() for x in lines[2:]] == [
        "SAMPLING (nbr)", "PHI", "PI", "GRADS PAR+SUM", "UPDATE+NORM THETA",
        "PPX CALC+ACCUM"]
    chains = FlatChainLearner(cfg, graph, split, 2, "cpu")
    assert _lines(lambda log: chains.print_stage_profile(log, 8)) == [
        "trace captured no attributable device ops"]


def test_profile_stages_leaves_the_state():
    cfg, graph, split = tiny(window=4)
    lrn = learner.Learner(cfg, graph, split, "cpu")
    pi = lrn.state.pi.clone()
    prof = lrn.profile_stages(iters=2)
    assert set(prof) == {"sample_neighbors", "phi", "pi_scatter",
                         "beta_grads", "theta_update", "ppx"}
    assert all(v > 0 for v in prof.values())
    assert torch.equal(lrn.state.pi, pi) and lrn.step_count == 1


# ---------------------------------------------------------------------------
# autotune
# ---------------------------------------------------------------------------

def test_window_candidates_filtering():
    """The engine's preconditions and the hub fallback collapse the list
    to [0]; the shared-memory rule drops the T whose window fits no
    cluster on the card."""
    cfg, _, _ = tiny()
    assert autotune.window_candidates(cfg) == [0, 6, 8, 12, 16]
    assert autotune.window_candidates(cfg.replace(shared_neighbors=False)) \
        == [0]
    assert autotune.window_candidates(
        cfg.replace(rng_backend=config.RngBackend.REFERENCE)) == [0]
    assert autotune.window_candidates(cfg.replace(batch_nodes_cap=65)) == [0]
    big = cfg.replace(K=256)
    # a card whose blocks take what the T = 8 window needs in its smallest
    # layout (the wide mode's step layout with one set of rows at the
    # largest cluster): the longer windows fit in no layout at any cluster
    # size
    limit = window.window_layout_bytes(
        (8, big.max_batch_nodes, big.num_node_sample, big.max_batch_edges,
         256), (16, "step1", 0))
    assert autotune.window_candidates(big, smem_limit=limit) == [0, 6, 8]


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _StubState:
    def __init__(self):
        self.step_count = 0


class _StubLearner:
    """An engine whose run() advances a fake clock at a per-window
    rate, so tune_window's ranking is deterministic."""

    def __init__(self, clock, per_step):
        self.state = _StubState()
        self._clock = clock
        self._per_step = per_step

    def run(self, n):
        self.state.step_count += n
        self._clock.t += n * self._per_step

    def close(self):
        pass


class _NoisyStubLearner(_StubLearner):
    """The first timed probe is 3x slower than the steady state."""

    def __init__(self, clock, per_step):
        super().__init__(clock, per_step)
        self._runs = 0

    def run(self, n):
        self._runs += 1
        slow = 3.0 if self._runs == 2 else 1.0   # run 1 is the warm-up
        self.state.step_count += n
        self._clock.t += n * self._per_step * slow


def test_tune_window_picks_fastest():
    cfg, _, _ = tiny()
    clock = _FakeClock()
    per_step = {0: 5e-3, 6: 2e-3, 8: 2.5e-3, 12: 1e-3, 16: 3e-3}
    best, table = autotune.tune_window(
        cfg, lambda c: _StubLearner(clock, per_step[c.window]), clock=clock)
    assert best.window == 12
    assert set(table) == {0, 6, 8, 12, 16}
    assert table[12] == max(table.values())


@pytest.mark.parametrize("error", [
    ValueError("window=12 needs shared_neighbors"),
    torch.cuda.OutOfMemoryError("CUDA out of memory")])
def test_tune_window_records_a_failing_candidate(caplog, error):
    """A candidate that a config guard refuses or that runs out of device
    memory is recorded as None, its error logged, and the others are
    still ranked."""
    cfg, _, _ = tiny()
    clock = _FakeClock()

    def make(c):
        if c.window == 12:
            raise error
        return _StubLearner(clock, {0: 2e-3, 6: 1e-3, 8: 3e-3,
                                    16: 4e-3}[c.window])

    with caplog.at_level(logging.WARNING):
        best, table = autotune.tune_window(cfg, make, clock=clock)
    assert best.window == 6 and table[12] is None
    assert any(f"window=12 failed ({type(error).__name__}: {error}"
               in r.getMessage() for r in caplog.records)


@pytest.mark.parametrize("where", ["build", "run"])
def test_tune_window_kernel_error_propagates(where):
    """A kernel that does not build or launch ends the tuning with its
    error instead of leaving the run at window 0."""
    cfg, _, _ = tiny()
    clock = _FakeClock()

    class _Broken(_StubLearner):
        def run(self, n):
            if self._per_step < 3e-3:     # the windowed candidates
                raise RuntimeError("window kernel launch failed: CUDA "
                                   "error 719")
            super().run(n)

    def make(c):
        if where == "build" and c.window:
            raise RuntimeError("nvcc failed on window_kernel.cu")
        return _Broken(clock, 5e-3 if c.window == 0 else 1e-3)

    with pytest.raises(RuntimeError, match="nvcc failed|launch failed"):
        autotune.tune_window(cfg, make, clock=clock)


def test_probe_rate_best_of_two():
    """Best of two reports the steady rate when the first timed probe
    stalls; a single probe reports the stall."""
    clock = _FakeClock()
    noisy = autotune.probe_rate(lambda: _NoisyStubLearner(clock, 1e-3),
                                probe_steps=10, warm_steps=5, clock=clock)
    assert noisy == pytest.approx(1000.0)
    single = autotune.probe_rate(lambda: _NoisyStubLearner(clock, 1e-3),
                                 probe_steps=10, warm_steps=5, clock=clock,
                                 repeats=1)
    assert single == pytest.approx(1000.0 / 3.0)


def test_tune_window_all_fail_raises():
    cfg, _, _ = tiny()

    def make(c):
        raise ValueError("boom")

    with pytest.raises(RuntimeError, match="every candidate failed"):
        autotune.tune_window(cfg, make, candidates=[0, 6])


def test_probe_rate_real_learner():
    cfg, graph, split = tiny()
    rate = autotune.probe_rate(
        lambda: learner.Learner(cfg.replace(window=4), graph, split, "cpu"),
        probe_steps=16, warm_steps=8)
    assert rate > 0


@pytest.mark.parametrize("flags", [
    ["--profile"],
    ["--auto-tune-window"],
    ["--num-chains", "2", "--auto-tune-window", "--profile"],
    ["--model", "mmsb", "--auto-tune-window", "--profile"],
])
def test_cli_profile_and_auto_tune(flags, caplog):
    """--profile prints the stage table after the stats table (a-MMSB
    engines only, as in the JAX CLI); --auto-tune-window logs the probe
    table, no candidate failing, and trains with the pick; the MMSB keeps
    its window with a warning."""
    args = ["--synthetic", "300,8", "-k", "8", "-m", "8", "-n", "8", "-x",
            "40", "-i", "20", "--steps-per-call", "20", "--device",
            "cpu"] + flags
    with caplog.at_level(logging.INFO, logger="mcmc_ammsb_tpu_torch"):
        assert cli.main(args) == 0
    msgs = [r.getMessage() for r in caplog.records]
    mmsb = "mmsb" in flags
    if "--profile" in flags:
        table = any(x.startswith("fused per-step stage profile")
                    or x == "trace captured no attributable device ops"
                    for x in msgs)
        assert table != mmsb
    if "--auto-tune-window" in flags:
        tuned = [x for x in msgs if x.startswith("window auto-tuned to ")]
        if mmsb:
            assert not tuned and any("--auto-tune-window supports" in x
                                     for x in msgs)
        else:
            assert len(tuned) == 1 and "failed" not in tuned[0]
            pick = int(re.match(r"window auto-tuned to (\d+)",
                                tuned[0]).group(1))
            assert f"window={pick}," in next(
                x for x in msgs if x.startswith("config: "))
