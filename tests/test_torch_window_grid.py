"""The window kernel's grid layout (csrc/window_kernel.cu,
``window_kernel_grid``): one chain's window over as many clusters of
GRID_CLUSTER CTAs as the card holds at once, its sums exchanged across
the clusters through L2. On the CPU the plan's launch-side rules
(``ops/window.launch_plan``) and the scratch it allocates; on a card
(``-m cuda``) chip_smoke.py's five-draw float64 check at the grid's
shapes, the bf16 launch against the float32 one rounded, two launches
bit for bit, its times against the node-resident layout with the plan
forced, and the chain entry, which keeps the node-resident layout. This
file imports no JAX, so its ``cuda`` tests run on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_window_grid.py``."""

import contextlib

import pytest
import torch

from mcmc_ammsb_tpu_torch import chains_flat, testing
from mcmc_ammsb_tpu_torch.ops import window

#: (T, B, n, E, K) the grid layout takes on an H100: T = 12 at K = 10240,
#: 12288 and 16384, the benchmark cells' 4-step chunk tail, and the
#: ragged K = 10242 (4-byte copies)
GRID_SHAPES = [(12, 33, 32, 32, 10240), (12, 33, 32, 32, 12288),
               (12, 33, 32, 32, 16384), (4, 33, 32, 32, 16384),
               (12, 33, 32, 32, 10242)]
#: the node-resident layout's plan at these shapes
NODES = (16, "nodes", window.NODES_TILE)
FIELDS = ("pi", "phi_sum", "theta", "beta")


@pytest.mark.parametrize("shape", GRID_SHAPES)
def test_grid_plan_at_the_main_shapes(shape):
    """At every shape of GRID_SHAPES the H100's plan is the grid layout,
    clusters of GRID_CLUSTER of slices of the grid width; with no
    co-resident clusters (the chain entry) the node-resident layout."""
    k = shape[4]
    assert window.window_plan(*shape) == (
        window.GRID_CLUSTER, "grid",
        window.window_grid_width(k, window.H100_GRID_CLUSTERS))
    assert window.window_plan(*shape, window.H100_SMEM, 0) == NODES


@contextlib.contextmanager
def _forced(plan):
    real = window.window_plan
    window.window_plan = lambda *a, **kw: plan
    try:
        yield
    finally:
        window.window_plan = real


def _fresh(state):
    return state._replace(pi=state.pi.clone(), phi_sum=state.phi_sum.clone())


def _outs(state):
    return tuple(getattr(state, f) for f in FIELDS)


def _operands(shape, seed, device):
    case = testing.window_case(seed, *shape)
    cfg = testing.window_case_config(case)
    state, xs = testing.window_case_torch(case, device)
    batch, nbrs = xs[0], xs[1][:, 0, :]
    mcode = window._correction_codes(cfg, batch.nodes, batch.node_mask, nbrs)
    keep = window._last_write_wins(batch.nodes, batch.node_mask, shape[0])
    return cfg, state, (xs, mcode, keep)


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
@pytest.mark.parametrize("shape", GRID_SHAPES)
def test_grid_float64_draws_on_gpu(cuda_device, shape):
    """The card's plan takes the grid layout at each shape, and
    chip_smoke.py's five-draw float64 check holds it: on five draws the
    kernel's window is no farther from a float64 evaluation than 2x the
    plain version, per field, on most draws."""
    import chip_smoke
    from mcmc_ammsb_tpu_torch.ops import phi as phi_ops

    assert window.launch_plan(shape, cuda_device, False)[1] == "grid"
    chip_smoke.check_window_f64_draws(window, phi_ops, testing, shape)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [GRID_SHAPES[2], GRID_SHAPES[3]])
def test_grid_bf16_is_float32_rounded_on_gpu(cuda_device, shape):
    """With bf16 pi the grid launch equals the float32 launch on the
    upcast rows, rounded to nearest-even, bit for bit (chip_smoke.py's
    bf16_agree, which also holds it against the plain version)."""
    import chip_smoke

    cfg, state, args = _operands(shape, 3, cuda_device)
    chip_smoke.bf16_agree(testing, cfg, state, args, window.window_apply_cuda,
                          window.window_apply_torch, f"grid at {shape}")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GRID_SHAPES)
def test_grid_runs_are_bit_identical_on_gpu(cuda_device, shape):
    """Two grid launches from the same state give the same bits in every
    output, whatever the order the clusters reach the exchange in, and
    are counted under the grid layout."""
    cfg, state, args = _operands(shape, 4, cuda_device)
    window.window_apply_cuda.layouts.clear()
    runs = [_outs(window.window_apply_cuda(cfg, _fresh(state), *args))
            for _ in range(3)]
    assert window.window_apply_cuda.layouts == {"grid": 3}
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [GRID_SHAPES[2], GRID_SHAPES[3]])
def test_grid_beats_nodes_on_gpu(cuda_device, shape):
    """At the -k 16384 path's window and its tail, timed in turns (grid,
    nodes, nodes, grid; the plan forced for the node-resident layout),
    the grid layout takes under 0.6x the node-resident layout's time (an
    H100 read 0.30x)."""
    import chip_smoke

    cfg, state, args = _operands(shape, 5, cuda_device)
    scratch = _fresh(state)
    grid = window.launch_plan(shape, cuda_device, False)
    t = []
    for plan in (grid, NODES, NODES, grid):
        with _forced(plan):
            t.append(chip_smoke.time_ms(
                lambda: window.window_apply_cuda(cfg, scratch, *args), 20,
                hold=True))
    assert t[0] + t[3] < 0.6 * (t[1] + t[2]), t


@pytest.mark.cuda
def test_chain_launch_keeps_nodes_on_gpu(cuda_device):
    """The chain entry at K = 16384 keeps the node-resident layout for
    every C, and one 2-chain launch equals two single-chain launches in
    that layout (the plan forced), bit for bit."""
    shape = (2, 12, 33, 32, 32, 16384)
    assert window.launch_plan(shape[1:], cuda_device, True) == NODES
    case = testing.chain_window_case(0, *shape)
    cfg = testing.chain_window_case_config(case)
    state, xw = testing.chain_window_case_torch(case, cuda_device)
    win = chains_flat.chain_windows(cfg, shape[0], xw).at(0)
    got = window.window_chain_apply_cuda(cfg, _fresh(state), win.xs_t,
                                         win.mcode, win.keep)
    n = cfg.N
    for c in range(shape[0]):
        rows = slice(c * n, (c + 1) * n)
        with _forced(NODES):
            one = window.window_apply_cuda(
                cfg, state._replace(pi=state.pi[rows].clone(),
                                    phi_sum=state.phi_sum[rows].clone(),
                                    theta=state.theta[c], beta=state.beta[c]),
                window.index_operands(win.xs_t, c), win.mcode[c],
                win.keep[c])
        part = (got.pi[rows], got.phi_sum[rows], got.theta[c], got.beta[c])
        assert all(torch.equal(a, b) for a, b in zip(_outs(one), part))
