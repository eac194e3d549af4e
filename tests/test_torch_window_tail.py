"""The window engine's chunk tail (mcmc_ammsb_tpu_torch/ops/window.py,
``windowed_scan``): the S % T steps after a chunk's last whole window run
as one short window through the window launch, not step by step through
the step body (``learner._hoisted_step_body``), which bf16 pi storage
keeps. On the CPU the plain window against the step body, the tail
counter and the layouts the tails take; on a card (``-m cuda``) the
kernel's tail launch against the body, the launches of a 1000-step
chunk, and chip_smoke.py's five-draw float64 check at the benchmark
cells' tail shapes. This file imports no
JAX, so its ``cuda`` tests run on the card with ``python -m pytest
--noconftest -m cuda tests/test_torch_window_tail.py``."""

import pytest
import torch

from mcmc_ammsb_tpu_torch import config, learner, testing
from mcmc_ammsb_tpu_torch.data import Graph, generate_sets, synthetic_edges
from mcmc_ammsb_tpu_torch.ops import window

FIELDS = ("pi", "phi_sum", "theta", "beta")
#: (T', B, n, E, K) of the benchmark cells' tail: 1000 % 12 = 100 % 12 = 4
TAIL_SHAPE = (4, 33, 32, 32, 16384)
#: the tail shapes of the cells and the layout each takes: K = 16384 the
#: grid layout, as its whole windows, K = 1024 (youtube-k1024) the
#: resident mode
TAIL_LAYOUTS = [(TAIL_SHAPE, "grid"), ((4, 33, 32, 32, 1024), "resident")]


def _fresh(state):
    """A copy of the state whose pi and phi_sum may be written."""
    return state._replace(pi=state.pi.clone(), phi_sum=state.phi_sum.clone())


def _steps(cfg, state, xs):
    """Every step of ``xs`` through the step body, one after another."""
    for i in range(xs[1].shape[0]):
        state = learner._hoisted_step_body(cfg, state,
                                           window.index_operands(xs, i))
    return state


def _never(state, x):
    raise AssertionError("a step went through the step body")


def _graph(n_nodes):
    n, u, v = synthetic_edges(n_nodes, 8, seed=1)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=2)
    return n, split, Graph.from_edges(n, split.training_u, split.training_v)


# (S, T): tails of S % T = 1, 4 and T - 1 steps after whole windows, a
# chunk shorter than one window, and a chunk of whole windows alone
CHUNKS = [(13, 6), (16, 6), (17, 6), (3, 6), (12, 6)]


@pytest.mark.parametrize("s_len,t_win", CHUNKS)
def test_tail_runs_as_one_short_window(s_len, t_win, monkeypatch):
    """windowed_scan on a collision-heavy case (later steps read rows that
    earlier ones wrote, inside the tail too): the whole windows, then
    one window of S % T steps, no step through the body; the state after
    the chunk is the per-step body chain's from the same state at rtol
    2e-5, atol 1e-8 (the windowed-versus-sequential bound of
    tests/test_torch_chains_learner.py); ``tail_launches`` counts the
    short window, and nothing at S % T = 0."""
    case = testing.window_case(7, s_len, 9, 8, 8, 16)
    cfg = testing.window_case_config(case).replace(window=t_win)
    state, xs = testing.window_case_torch(case, "cpu")
    want = _steps(cfg, _fresh(state), xs)
    lengths, real = [], window.window_apply_torch

    def apply(cfg, s, xs_t, *args):
        lengths.append(xs_t[0].nodes.shape[0])
        return real(cfg, s, xs_t, *args)

    monkeypatch.setattr(window, "window_apply_torch", apply)
    window.windowed_scan.tail_launches = 0
    got = window.windowed_scan(cfg, state, xs, _never)
    tail = s_len % t_win
    assert lengths == [t_win] * (s_len // t_win) + ([tail] if tail else [])
    assert window.windowed_scan.tail_launches == int(tail > 0)
    assert (got.step_count, got.beta_count) == (want.step_count,
                                                want.beta_count)
    for f in FIELDS:
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   rtol=2e-5, atol=1e-8, msg=f)


@pytest.mark.parametrize("s_len", [16, 3])
def test_bf16_tail_keeps_the_step_body(s_len, monkeypatch):
    """With bf16 pi the tail's steps go through the step body one at a
    time, each rounding its rows before the next reads them (a window
    rounds only at its end): the whole windows, then S % T calls of the
    body, no short window; a chunk shorter than a window is the body
    chain, bit for bit."""
    case = testing.window_case(7, s_len, 9, 8, 8, 16)
    cfg = testing.window_case_config(case).replace(window=6)
    state, xs = testing.window_case_torch(case, "cpu")
    state = state._replace(pi=state.pi.to(torch.bfloat16))
    want = _steps(cfg, _fresh(state), xs)
    lengths, calls, real = [], [], window.window_apply_torch

    def apply(cfg, s, xs_t, *args):
        lengths.append(xs_t[0].nodes.shape[0])
        return real(cfg, s, xs_t, *args)

    def body(s, x):
        calls.append(x)
        return learner._hoisted_step_body(cfg, s, x)

    monkeypatch.setattr(window, "window_apply_torch", apply)
    window.windowed_scan.tail_launches = 0
    got = window.windowed_scan(cfg, state, xs, body)
    assert lengths == [6] * (s_len // 6)
    assert len(calls) == s_len % 6
    assert window.windowed_scan.tail_launches == 0
    assert got.pi.dtype == torch.bfloat16
    if s_len < 6:
        for f in FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("t_win,want", [(4, (1, 3)), (5, (0, 0))])
def test_tail_launches_one_per_chunk(t_win, want):
    """The learner on the CPU, 10-step chunks: ``run(10)`` and
    ``run_with_ppx(30, 10)`` run one short window a chunk at T = 4 (two
    tail steps), none at T = 5."""
    n, split, graph = _graph(300)
    cfg = config.Config(K=8, mini_batch_size=8, num_node_sample=4,
                        steps_per_call=10, device_sampling=True,
                        shared_neighbors=True, window=t_win).finalize(
        n, split.total_edges, graph.max_fan_out)
    lrn = learner.Learner(cfg, graph, split, "cpu")
    got = []
    for call in (lambda: lrn.run(10), lambda: lrn.run_with_ppx(30, 10)):
        window.windowed_scan.tail_launches = 0
        call()
        got.append(window.windowed_scan.tail_launches)
    assert tuple(got) == want


@pytest.mark.parametrize("t_win", [12, 4])
def test_k1024_windows_take_the_resident_mode(t_win):
    """At youtube-k1024's shape (B = 33, n = E = 32, K = 1024) a whole
    window of T = 12 and the chunk's 4-step tail both fit the resident
    mode on an H100's shared memory."""
    cluster, mode, wc = window.window_plan(t_win, 33, 32, 32, 1024)
    assert mode == "resident" and wc == 0 and 1 <= cluster <= 16


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at
    import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,layout", TAIL_LAYOUTS)
@pytest.mark.parametrize("seed", [11, 12])
def test_tail_launch_matches_steps_on_gpu(cuda_device, seed, shape, layout):
    """At each cell's tail shape on a collision-heavy case (later steps
    read rows that earlier ones wrote), a 4-step chunk at T = 12 is one
    launch of the kernel (the grid layout at K = 16384, the resident mode
    at K = 1024, counted under that layout) and ends where
    four steps of the body end from the same state on the card, within the
    window contract of the benchmark's check (ammsb_bench/check.py): the
    largest L1 distance of a row 2e-5 (the float32 cells' window_pi_gap
    limit), theta's gap over its change 3e-3 (window_theta_gap), phi_sum
    normwise rtol 1e-5."""
    case = testing.window_case(seed, *shape)
    cfg = testing.window_case_config(case).replace(window=12)
    state, xs = testing.window_case_torch(case, cuda_device)
    codes = window._correction_codes(cfg, xs[0].nodes, xs[0].node_mask,
                                     xs[1][:, 0, :])
    assert bool((codes > 0).any())
    assert window.window_plan(*shape)[1] == layout
    want = _steps(cfg, _fresh(state), xs)
    window.window_apply_cuda.launches = 0
    window.window_apply_cuda.layouts.clear()
    window.windowed_scan.tail_launches = 0
    got = window.windowed_scan(cfg, _fresh(state), xs, _never)
    assert window.window_apply_cuda.launches == 1
    assert window.window_apply_cuda.layouts == {layout: 1}
    assert window.windowed_scan.tail_launches == 1
    pi_gap = float((got.pi.float() - want.pi.float()).abs().sum(-1).max())
    theta_gap = float(torch.linalg.vector_norm(got.theta - want.theta)
                      / torch.linalg.vector_norm(want.theta - state.theta))
    sum_gap = float((got.phi_sum - want.phi_sum).abs().max())
    assert pi_gap <= 2e-5, pi_gap
    assert theta_gap <= 3e-3, theta_gap
    assert sum_gap <= 1e-8 + 1e-5 * float(want.phi_sum.abs().max()), sum_gap


@pytest.mark.cuda
@pytest.mark.parametrize("pi_dtype,want", [
    ("float32", [(84, 1), (90, 10)]), ("bfloat16", [(83, 0), (80, 0)])])
def test_chunk_launches_on_gpu(cuda_device, pi_dtype, want):
    """The learner at K = 16384, T = 12 on a card: a 1000-step chunk is
    83 whole windows and one short window of 4 steps, 84 kernel
    launches; ``run_with_ppx(1000, 100)`` runs ten chunks of 8 windows
    and a short one each, 90 launches. With bf16 pi the tails keep the
    step body: 83 and 80."""
    n, split, graph = _graph(2000)
    cfg = config.Config(K=16384, mini_batch_size=32, num_node_sample=32,
                        steps_per_call=1000, device_sampling=True,
                        shared_neighbors=True, window=12, ds_link_cap=32,
                        pi_dtype=pi_dtype).finalize(n, split.total_edges,
                                                    graph.max_fan_out)
    lrn = learner.Learner(cfg, graph, split, cuda_device)
    got = []
    for call in (lambda: lrn.run(1000),
                 lambda: lrn.run_with_ppx(1000, 100)):
        window.window_apply_cuda.launches = 0
        window.windowed_scan.tail_launches = 0
        call()
        got.append((window.window_apply_cuda.launches,
                    window.windowed_scan.tail_launches))
    assert got == want
    assert torch.isfinite(lrn.state.pi.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [s for s, _ in TAIL_LAYOUTS])
def test_tail_shape_float64_draws(cuda_device, shape):
    """chip_smoke.py's five-draw float64 check (check_window_f64_draws)
    at each cell's tail shape: on five draws the kernel's window of 4
    steps is no farther from a float64 evaluation than 2x the plain
    version, per field, on most draws."""
    import chip_smoke
    from mcmc_ammsb_tpu_torch.ops import phi as phi_ops

    assert chip_smoke.TAIL_SHAPE == TAIL_SHAPE
    chip_smoke.check_window_f64_draws(window, phi_ops, testing, shape)
