"""The whole command on the CPU at a test-only tiny size: its last
line, its refusals, and ``correct`` under the check's control and under
faults planted in the timed path."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import types

import pytest

from ammsb_bench import check, control, run
from ammsb_bench.tests.conftest import REPO, TINY, tiny_bench

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_last_line(tiny):
    rc, line, err = tiny("tiny.ppx100", 2 ** 31 + 17)
    assert rc == 0
    assert list(line) == KEYS + ["checks"]
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    assert {"updates_per_s", "setup_s"} <= set(line["metrics"])
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    # the numbers compared are the last lines on standard error
    tail = err.strip().splitlines()[-len(check.NAMES):]
    assert [t.split()[0] for t in tail] == list(check.NAMES)
    assert list(line["checks"]) == list(check.NAMES)


def test_traced_line(tiny):
    rc, line, _ = tiny("tiny.ppx200", 23, trace=1)
    assert rc == 0 and line["correct"] is True
    assert list(line) == KEYS + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert {"setup.data_s", "setup.warm_s"} <= set(line["metrics"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "dblp-k16384.ppx1000", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc == 2 and capsys.readouterr().out == ""


@pytest.mark.parametrize("name", ["jax", "jaxlib.xla", "flax",
                                  "mcmc_ammsb_tpu", "mcmc_ammsb_tpu.ops"])
def test_forbidden_module_refuses_the_result(tiny, monkeypatch, name):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    rc, line, err = tiny("tiny.ppx200", 5)
    assert rc == 3 and line is None and name in err


def test_command_loads_no_jax():
    code = ("import sys; from ammsb_bench.tests.conftest import run_tiny; "
            "rc, line, err = run_tiny('tiny.ppx200', 29); "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'mcmc_ammsb_tpu'}); "
            "print(rc, line['correct'], bad)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.split() == ["0", "True", "[]"], out.stderr[-2000:]


def test_benchmark_alone_exits_nonzero(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "ammsb_bench", tmp_path / "ammsb_bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "ammsb_bench.run",
                          "--workload", "dblp-k16384.ppx1000", "--seed", "3",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("workload", ["tiny.ppx100", "tiny-bf16.ppx100"])
def test_control_fails(workload):
    spec = run.cell_spec(workload, tiny_bench(), TINY)
    got = control.seed_readings(spec, 31, "cpu")
    assert check.verdict(got["program"], spec["limits"])
    for kind in ("control", "unchanged", "half", "fanin", "answer"):
        assert not check.verdict(got[kind], spec["limits"]), kind


def _patch_windows(monkeypatch, change):
    """Plant ``change(cfg, state, xs_t, apply)`` in place of every
    window and every step after the last window (the plain versions that
    the CPU runs)."""
    from mcmc_ammsb_tpu_torch import learner
    from mcmc_ammsb_tpu_torch.ops import window

    real_apply = window.window_apply_torch
    real_body = learner._hoisted_step_body

    def apply(cfg, s, xs_t, mcode, keep):
        return change(s, xs_t, lambda xs: real_apply(cfg, s, xs, mcode, keep))

    def body(cfg, s, x):
        one = (type(x[0])(*(a[None] for a in x[0])), *(a[None] for a in x[1:]))
        return change(s, one, lambda xs: real_body(
            cfg, s, (type(xs[0])(*(a[0] for a in xs[0])),
                     *(a[0] for a in xs[1:]))))

    monkeypatch.setattr(window, "window_apply_torch", apply)
    monkeypatch.setattr(learner, "_hoisted_step_body", body)


def _unchanged(s, xs, real):
    steps = xs[0].nodes.shape[0]
    return s._replace(step_count=s.step_count + steps,
                      beta_count=s.beta_count + steps)


def _half(s, xs, real):
    batch = xs[0]
    b, e = batch.nodes.shape[1], batch.edges_u.shape[1]
    nm, em = batch.node_mask.clone(), batch.edge_mask.clone()
    nm[:, b // 2:] = False
    em[:, e // 2:] = False
    return real((batch._replace(node_mask=nm, edge_mask=em,
                                weight=batch.weight * 2.0), *xs[1:]))


def _row(s, xs, real):
    out = real(xs)
    out.pi[int(xs[0].nodes[0, 0])] *= 1.001
    return out


def _theta_kept(s, xs, real):
    return real(xs)._replace(theta=s.theta, beta=s.beta)


@pytest.mark.parametrize("fault", [_unchanged, _half, _row, _theta_kept])
def test_fault_in_the_steps_is_caught(tiny, monkeypatch, fault):
    _patch_windows(monkeypatch, fault)
    rc, line, _ = tiny("tiny.ppx100", 37)
    assert rc == 0 and line["correct"] is False


def test_steps_outside_the_windows_are_missing(tiny, monkeypatch):
    # steps that the program runs without the window launch (as a CUDA
    # graph replaying a chunk would) are not followed: not correct
    from mcmc_ammsb_tpu_torch import learner
    from mcmc_ammsb_tpu_torch.ops import window

    def scan(cfg, state, xs, body):
        for i in range(xs[1].shape[0]):
            state = body(state, window.index_operands(xs, i))
        return state

    monkeypatch.setattr(learner, "windowed_scan", scan)
    rc, line, _ = tiny("tiny.ppx100", 53)
    assert rc == 0 and line["correct"] is False
    assert line["checks"]["steps_missing"][0] > 0


def _streams(s_len=40, b=3, k=64, n_nodes=1000, chunks=2, seed=0):
    import torch

    from ammsb_bench import reference

    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(chunks):
        d = reference.Draws(
            *(torch.zeros(s_len, 1) for _ in range(6)),
            torch.randint(0, n_nodes, (s_len, 32), generator=g),
            torch.randn(s_len, b, k, generator=g),
            torch.randn(s_len, k, 2, generator=g))
        out.append(types.SimpleNamespace(draws=d))
    return out


def _reused_step(c):
    c[0].draws.phi_noise[5] = c[0].draws.phi_noise[4]


def _reused_window(c):
    c[1].draws.beta_noise[20] = c[1].draws.beta_noise[8]


def _reused_chunk(c):
    c[1].draws.phi_noise[0] = c[0].draws.phi_noise[0]


def _low_half(c):
    for x in c:
        x.draws.nbrs //= 2


@pytest.mark.parametrize("fault", [None, _reused_step, _reused_window,
                                   _reused_chunk, _low_half])
def test_stream_faults(fault):
    judge = types.SimpleNamespace(md=types.SimpleNamespace(T=12, N=1000))
    chunks = _streams()
    if fault is not None:
        fault(chunks)
    got = check.Judge.stream_faults(judge, chunks)
    assert (got > 0) == (fault is not None)


def test_altered_answer_is_caught(tiny, monkeypatch):
    from mcmc_ammsb_tpu_torch.ops import perplexity

    real = perplexity.perplexity_step

    def step(*args, **kw):
        res = real(*args, **kw)
        return res._replace(neg_avg_log=res.neg_avg_log * 1.0001)

    monkeypatch.setattr(perplexity, "perplexity_step", step)
    from mcmc_ammsb_tpu_torch import learner
    monkeypatch.setattr(learner.ppx_ops, "perplexity_step", step)
    rc, line, _ = tiny("tiny.ppx200", 41)
    assert rc == 0 and line["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["tiny.ppx100", "tiny-bf16.ppx100"])
def test_tiny_cells_on_the_card(tiny, workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rc, line, err = tiny(workload, 43, device="cuda")
    assert rc == 0 and line["correct"] is True, err[-2000:]
    spec = run.cell_spec(workload, tiny_bench(), TINY)
    got = control.seed_readings(spec, 47, "cuda")
    assert check.verdict(got["program"], spec["limits"])
    assert not check.verdict(got["control"], spec["limits"])
