"""The port's window engine (mcmc_ammsb_tpu_torch/ops/window.py) against
the JAX package's (mcmc_ammsb_tpu/ops/window.py) on the same seeded
operands: the bookkeeping exactly, the plain window core against the
JAX jnp core and against the Pallas kernel in interpret mode (the way
tests/test_window.py runs it on the CPU), the fused window's plain
version (gather, core, scatter) against JAX's three, and the kernel's
cluster-size rule. The CUDA kernel itself is checked against the plain
version on the card by chip_smoke.py."""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_ammsb_tpu.ops import window as jax_window
from mcmc_ammsb_tpu_torch import testing
from mcmc_ammsb_tpu_torch.ops import window

from test_torch_window_layout import LAYOUT_BYTES, LAYOUT_MODES
from torch_parity import assert_close, jax_config, jax_window_case

# (T, B, n, E, K): a collision-heavy tiny window, the odd shape
# (m, n, K, T) = (5, 7, 12, 3) and the m > n shape (13, 3, 24, 5)
SHAPES = [(4, 9, 8, 8, 16), (3, 6, 7, 5, 12), (5, 14, 3, 13, 24)]
# windows at the K where the kernel of the main path's shape runs its
# wide mode; the last takes the wide mode's step layout itself
WIDE_SHAPES = [(3, 6, 7, 5, 1536), (4, 9, 8, 8, 2048), (4, 9, 8, 8, 8192)]


def _both(seed, shape):
    case = testing.window_case(seed, *shape)
    cfg = testing.window_case_config(case)
    return case, cfg, jax_config(cfg)


@pytest.mark.parametrize("shape", SHAPES)
def test_window_bookkeeping_exact(shape):
    """_last_write_wins, _correction_codes, _window_gather and
    _window_scatter equal the JAX package's exactly, padded lanes
    (sentinel N) included."""
    case, cfg, jcfg = _both(1, shape)
    state, xs = testing.window_case_torch(case, "cpu")
    js, jxs = jax_window_case(case)
    batch, nbrs = xs[0], xs[1][:, 0, :]
    jbatch, jnbrs = jxs[0], jxs[1][:, 0, :]
    t_win = shape[0]

    keep = window._last_write_wins(batch.nodes, batch.node_mask, t_win)
    jkeep = jax_window._last_write_wins(jbatch.nodes, jbatch.node_mask,
                                        t_win)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    codes = window._correction_codes(cfg, batch.nodes, batch.node_mask,
                                     nbrs)
    jcodes = jax_window._correction_codes(jcfg, jbatch.nodes,
                                          jbatch.node_mask, jnbrs)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes)[..., 0])
    assert (codes > 0).any(), "the case must collide inside the window"

    g, sums = window._window_gather(cfg, state, batch, nbrs)
    jg, jsums = jax_window._window_gather(jcfg, js, jbatch, jnbrs)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(sums.numpy(), np.asarray(jsums))

    rng = np.random.default_rng(2)
    rows = rng.random((t_win * shape[1], shape[4]), np.float32)
    rsums = rng.random(t_win * shape[1], np.float32)
    pi, phi_sum = window._window_scatter(
        cfg, state, batch, keep, torch.from_numpy(rows),
        torch.from_numpy(rsums))
    jpi, jphi = jax_window._window_scatter(jcfg, js, jbatch, jkeep,
                                           jnp.asarray(rows),
                                           jnp.asarray(rsums))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(jpi))
    np.testing.assert_array_equal(phi_sum.numpy(), np.asarray(jphi))


@pytest.mark.parametrize("jax_core", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("shape", SHAPES)
def test_window_core_torch_matches_jax(shape, jax_core):
    """window_core_torch == _window_core_jnp / the Pallas kernel
    (interpret mode) on one collision-heavy window.

    Tolerance atol 1e-8 and rtol 5e-5, loosened from the rtol 1e-5 of
    JAX's own pallas-versus-jnp check (tests/test_window.py:125-130):
    torch's and XLA's CPU matmuls sum in different orders, and a theta
    element that comes out of the SGRLD step's abs() of a cancellation
    differs at rtol 2.07e-5 here (the largest elementwise error measured
    over seeds 3, 5, 7 x these shapes; all else stays under 4e-6)."""
    case, cfg, jcfg = _both(3, shape)
    state, xs = testing.window_case_torch(case, "cpu")
    js, jxs = jax_window_case(case)
    batch, nbrs = xs[0], xs[1][:, 0, :]
    g, sums = window._window_gather(cfg, state, batch, nbrs)
    mcode = window._correction_codes(cfg, batch.nodes, batch.node_mask,
                                     nbrs)
    got = window.window_core_torch(cfg, state, xs, g, sums, mcode)

    jmcode = jnp.asarray(mcode.numpy())[..., None]
    core = (jax_window._window_core_jnp if jax_core == "jnp"
            else jax_window._window_core_pallas)
    want = core(jcfg, js, jxs, jnp.asarray(g.numpy()),
                jnp.asarray(sums.numpy()), jmcode)
    for a, b, name in zip(got, want, ("rows", "sums", "theta", "beta")):
        assert_close(a, b, rtol=5e-5, atol=1e-8, what=name)


def _codes(cfg, xs):
    """(mcode, keep) of the window ``xs``, as iter_windows gives them."""
    batch, nbrs = xs[0], xs[1][:, 0, :]
    mcode = window._correction_codes(cfg, batch.nodes, batch.node_mask,
                                     nbrs)
    keep = window._last_write_wins(batch.nodes, batch.node_mask,
                                   batch.nodes.shape[0])
    return mcode, keep


@pytest.mark.parametrize("jax_core", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("shape", SHAPES + WIDE_SHAPES)
def test_window_apply_torch_matches_jax(shape, jax_core):
    """The fused window's plain version (gather, core, scatter in one
    call) == JAX's _window_gather -> _window_core_jnp / the Pallas kernel
    (interpret mode) -> _window_scatter on the same operands: pi,
    phi_sum, theta and beta after the window, with the in-window
    collisions, masked lanes and padded lanes of the case, at rtol 5e-5,
    atol 1e-8 (the bound of test_window_core_torch_matches_jax, for the
    same reason), also at the K where the kernel runs its wide mode
    (WIDE_SHAPES). The counters advance by T."""
    case, cfg, jcfg = _both(5, shape)
    state, xs = testing.window_case_torch(case, "cpu")
    js, jxs = jax_window_case(case)
    mcode, keep = _codes(cfg, xs)
    assert (mcode > 0).any() and not bool(xs[0].node_mask.all())
    got = window.window_apply_torch(cfg, state, xs, mcode, keep)
    assert got.pi is state.pi                        # in place
    assert got.step_count == case["step_count"] + shape[0]
    assert got.beta_count == case["beta_count"] + shape[0]

    jbatch, jnbrs = jxs[0], jxs[1][:, 0, :]
    g, sums = jax_window._window_gather(jcfg, js, jbatch, jnbrs)
    jmcode = jax_window._correction_codes(jcfg, jbatch.nodes,
                                          jbatch.node_mask, jnbrs)
    core = (jax_window._window_core_jnp if jax_core == "jnp"
            else jax_window._window_core_pallas)
    rows, rsums, theta, beta = core(jcfg, js, jxs, g, sums, jmcode)
    jkeep = jax_window._last_write_wins(jbatch.nodes, jbatch.node_mask,
                                        shape[0])
    pi, phi_sum = jax_window._window_scatter(jcfg, js, jbatch, jkeep, rows,
                                             rsums)
    for f, want in (("pi", pi), ("phi_sum", phi_sum), ("theta", theta),
                    ("beta", beta)):
        assert_close(getattr(got, f), want, rtol=5e-5, atol=1e-8, what=f)


@pytest.mark.parametrize("shape", [
    (12, 33, 32, 32, 256), (3, 6, 7, 5, 12), (12, 33, 32, 32, 100),
    (6, 33, 32, 32, 256), (4, 9, 8, 8, 16), (12, 33, 32, 32, 128),
    (5, 14, 3, 13, 24), (48, 33, 32, 32, 256), (64, 33, 32, 32, 256)])
def test_window_cluster_size_rule(shape):
    """The K split of the window kernel: the cluster size S depends on
    the per-chain shape only (no chain count enters), its column slices
    tile K exactly with none empty, and the per-CTA shared memory fits
    an H100's 232,448 B per block — at every shape chip_smoke.py runs and
    at the long windows a user's --window may ask for."""
    t_win, b_cap, n_smpl, e_cap, k = shape
    s = window.window_cluster_size(*shape)
    assert 1 <= s <= window.MAX_CLUSTER
    w = window.window_slice_width(k, s)
    cols = [c for r in range(s) for c in range(r * w, min(k, (r + 1) * w))]
    assert cols == list(range(k))
    assert all(min(k, (r + 1) * w) > r * w for r in range(s))
    assert window.window_layout_bytes(shape, (s, "resident", 0)) <= \
        window.H100_SMEM
    if k <= 16:
        assert s == 1
    if k == 256:
        assert s > 1


def test_window_cluster_size_bench_shapes():
    """S = 4 at K = 256 (an H100 runs 30 clusters of 4 at once, so 16
    chains fit in one wave; it runs only 15 of 8), 2 at K = 100 with a
    ragged last slice (52 + 48 columns), 1 at K = 12; the staged slice of
    T = 48 at K = 256 needs S = 16; a shape that fits at no S raises
    naming the shape."""
    assert window.window_cluster_size(12, 33, 32, 32, 256) == 4
    assert window.window_cluster_size(6, 33, 32, 32, 256) == 4
    assert window.window_cluster_size(12, 33, 32, 32, 100) == 2
    assert window.window_slice_width(100, 2) == 52
    assert window.window_cluster_size(3, 6, 7, 5, 12) == 1
    assert window.window_cluster_size(48, 33, 32, 32, 256) == 16
    with pytest.raises(ValueError, match=r"\(64, 33, 32, 32, 4096\)"):
        window.window_cluster_size(64, 33, 32, 32, 4096)


# (T, K, layout) of the wide mode at the main path's (B, n, E) = (33, 32,
# 32): the JAX package's max_safe_window T at each K from 1536 to 16384,
# the ragged K = 2050 (not a multiple of 4: 4-byte copies) and the CLI's
# T = 12 on the card at K = 6144-16384; the step layout (a step's rows
# in shared memory, two sets) up to K = 4096, the step layout with one set
# of rows at K = 6144-8192, the grid layout (one chain's columns over the
# clusters an H100 holds at once, a step's rows in shared memory) where the
# node-resident layout (node rows in shared memory, neighbor rows streamed
# in tiles) fits, at K = 10240-16384, the benchmark cells' 4-step chunk
# tail at K = 16384 too
WIDE_PLANS = [(12, 1536, "step"), (12, 2048, "step"), (12, 2050, "step"),
              (12, 3072, "step"), (12, 4096, "step"), (8, 6144, "step1"),
              (6, 8192, "step1"), (3, 16384, "grid"), (12, 6144, "step1"),
              (12, 8192, "step1"), (12, 10240, "grid"),
              (12, 12288, "grid"), (12, 16384, "grid"), (4, 16384, "grid")]


@pytest.mark.parametrize("shape", [
    (12, 33, 32, 32, 256), (3, 6, 7, 5, 12), (12, 33, 32, 32, 100),
    (6, 33, 32, 32, 256), (4, 9, 8, 8, 16), (12, 33, 32, 32, 128),
    (5, 14, 3, 13, 24), (48, 33, 32, 32, 256), (64, 33, 32, 32, 256),
    (12, 33, 32, 32, 1024), (8, 33, 32, 32, 1536), (3, 33, 32, 32, 2048),
    (1, 33, 32, 32, 3072)])
def test_window_plan_resident_where_it_fits(shape):
    """window_plan keeps the resident mode, at window_cluster_size's S,
    wherever that rule finds a cluster: the shapes chip_smoke.py runs in
    it and the largest T of each K up to 3072 whose resident layout
    fits an H100."""
    assert window.window_plan(*shape) == (window.window_cluster_size(*shape),
                                          "resident", 0)


@pytest.mark.parametrize("t_win,k,layout", WIDE_PLANS)
def test_window_plan_wide_covers_jax_windows(t_win, k, layout):
    """At every K from 1536 to 16384 the JAX package windows at the main
    path's shape (its max_safe_window T), and the CLI on the card at T =
    12 up to K = 16384; there the resident layout fits no cluster of an
    H100 and window_plan takes the wide mode in the layout WIDE_PLANS
    names, at S = 16: either step layout with a chunk that covers the
    slice (a multiple of 8; the one-set layout only where the two-set one
    does not fit), the node-resident one with tiles of NODES_TILE
    columns (only where neither step layout fits), or the chunked one
    with a chunk of WIDE_CHUNKS narrower than the slice (only where none
    of those fits); where the node-resident layout fits, the grid layout
    in its place, clusters of GRID_CLUSTER over the H100's 30 (the
    node-resident layout at S = 16 with no co-resident count); its layout
    fits 232,448 B, its column slices tile K with none empty; every
    shorter window runs in one mode or another."""
    shape = (t_win, 33, 32, 32, k)
    with pytest.raises(ValueError):
        window.window_cluster_size(*shape)
    s, mode, wc = window.window_plan(*shape)
    if mode == "grid":
        assert s == window.GRID_CLUSTER
        assert wc == window.window_grid_width(k, window.H100_GRID_CLUSTERS)
        assert wc % 8 == 0
        ctas = -(-k // wc)
        assert ctas % s == 0
        assert window.MIN_GRID_CTAS <= ctas <= s * window.H100_GRID_CLUSTERS
        smem = window.window_layout_bytes(shape, (s, mode, wc))
        assert smem <= window.H100_SMEM
        cols = [c for r in range(ctas)
                for c in range(r * wc, min(k, (r + 1) * wc))]
        assert cols == list(range(k))
        assert all(min(k, (r + 1) * wc) > r * wc for r in range(ctas))
        assert window.window_plan(*shape, window.H100_SMEM, 0) == (
            16, "nodes", window.NODES_TILE)
        s, mode, wc = 16, "nodes", window.NODES_TILE
    w = window.window_slice_width(k, s)
    assert (s, mode) == (16, "nodes" if layout == "grid" else layout)

    def smem(mode, wc=0):
        return window.window_layout_bytes(shape, (s, mode, wc))

    if mode in ("step", "step1"):
        assert wc == window.step_chunk(k, s) and w <= wc < w + 8
        assert wc % 8 == 0
    if mode != "step":
        assert smem("step") > window.H100_SMEM
    if mode in ("nodes", "wide"):
        assert smem("step1") > window.H100_SMEM
    if mode == "nodes":
        assert wc == window.NODES_TILE and wc % 8 == 0
    if mode == "wide":
        assert wc in window.WIDE_CHUNKS and wc < w
        assert smem("nodes", window.NODES_TILE) > window.H100_SMEM
    assert smem(mode, wc) <= window.H100_SMEM
    cols = [c for r in range(s) for c in range(r * w, min(k, (r + 1) * w))]
    assert cols == list(range(k))
    assert all(min(k, (r + 1) * w) > r * w for r in range(s))
    for t in range(1, t_win):
        window.window_plan(t, 33, 32, 32, k)


def test_window_plan_limits():
    """The plan refuses what the kernel refuses (n > 32 neighbors, T >
    64) and a limit that fits neither mode, naming the shape; with a
    smaller card the wide mode takes the step layout with one set of
    rows, then the node-resident layout (the grid layout in its place
    where the card holds enough clusters at once), then the chunked
    layout, narrower chunks and clusters; each plan's bytes fit its limit
    and 232,448 B."""
    with pytest.raises(ValueError, match="n <= 32"):
        window.window_plan(12, 33, 64, 32, 256)
    with pytest.raises(ValueError, match="<= 64 steps"):
        window.window_plan(65, 33, 32, 32, 256)
    with pytest.raises(ValueError, match=r"\(12, 33, 32, 32, 4096\)"):
        window.window_plan(12, 33, 32, 32, 4096, 50_000)
    def smem(shape, mode, wc=0, s=16):
        return window.window_layout_bytes(shape, (s, mode, wc))

    tile = window.NODES_TILE
    big = (12, 33, 32, 32, 16384)
    narrow = smem(big, "wide", 64)
    assert window.window_plan(*big, narrow) == (16, "wide", 64)
    shape = (12, 33, 32, 32, 4096)
    step = smem(shape, "step")
    assert step <= window.H100_SMEM
    assert window.window_plan(*shape, step) == (16, "step", 256)
    one_set = smem(shape, "step1")
    assert one_set < step
    assert window.window_plan(*shape, step - 1) == (16, "step1", 256)
    assert window.window_plan(*shape, one_set) == (16, "step1", 256)
    nodes = smem(shape, "nodes", tile)
    assert nodes < one_set
    assert window.window_plan(*shape, one_set - 1, 0) == (
        16, "nodes", window.NODES_TILE)
    assert window.window_plan(*shape, nodes, 0) == (16, "nodes",
                                                    window.NODES_TILE)
    grid = (window.GRID_CLUSTER, "grid", 64)
    assert window.window_plan(*shape, one_set - 1) == grid
    assert window.window_plan(*shape, nodes) == grid
    for limit in (nodes, one_set - 1, one_set, step - 1, step,
                  window.H100_SMEM):
        for clusters in (0, window.H100_GRID_CLUSTERS):
            plan = window.window_plan(*shape, limit, clusters)
            assert window.window_layout_bytes(shape, plan) <= min(
                limit, window.H100_SMEM)
    # at K = 16384: the node-resident layout one byte under the step layout
    # with one set of rows, the chunked layout one byte under the
    # node-resident layout, its narrower chunk one byte under its chunk of
    # 128
    one_set = smem(big, "step1")
    nodes = smem(big, "nodes", tile)
    wide = smem(big, "wide", 128)
    assert narrow < wide < nodes <= window.H100_SMEM < one_set
    assert window.window_plan(*big, one_set - 1, 0) == (16, "nodes",
                                                        window.NODES_TILE)
    assert window.window_plan(*big, window.H100_SMEM, 0) == (
        16, "nodes", window.NODES_TILE)
    grid = (window.GRID_CLUSTER, "grid", 152)
    assert window.window_plan(*big, one_set - 1) == grid
    assert window.window_plan(*big) == grid
    # the grid only where the node-resident layout fits: one byte under
    # it the chunked layout, though the grid's own bytes would fit
    assert smem(big, "grid", 152, window.GRID_CLUSTER) < nodes - 1
    assert window.window_plan(*big, nodes - 1) == (16, "wide", 128)
    assert window.window_plan(*big, wide - 1) == (16, "wide", 64)
    for limit in (narrow, wide - 1, wide, nodes - 1, nodes, one_set - 1):
        for clusters in (0, window.H100_GRID_CLUSTERS):
            plan = window.window_plan(*big, limit, clusters)
            assert window.window_layout_bytes(big, plan) <= min(
                limit, window.H100_SMEM)
    # the longest window the step layout holds at K = 4096 takes it; one
    # more step takes the layout with one set of rows; at K = 8192 the
    # longest window that layout holds takes it, one more step the chunked
    # layout
    longest = max(t for t in range(1, 65) if smem(
        (t, 33, 32, 32, 4096), "step") <= window.H100_SMEM)
    assert longest >= 12
    assert window.window_plan(longest, 33, 32, 32, 4096)[1] == "step"
    assert window.window_plan(longest + 1, 33, 32, 32, 4096)[1] == "step1"
    longest = max(t for t in range(1, 65) if smem(
        (t, 33, 32, 32, 8192), "step1") <= window.H100_SMEM)
    assert longest >= 12
    assert window.window_plan(longest, 33, 32, 32, 8192)[1] == "step1"
    assert window.window_plan(longest + 1, 33, 32, 32, 8192)[1] == "grid"
    assert window.window_plan(longest + 1, 33, 32, 32, 8192,
                              window.H100_SMEM, 0)[1] == "nodes"
    # at K = 16384 the longest window the node-resident layout holds takes
    # it (the grid layout in its place), one more step the chunked layout
    longest = max(t for t in range(1, 65) if smem(
        (t, 33, 32, 32, 16384), "nodes", tile) <= window.H100_SMEM)
    assert longest >= 12
    assert window.window_plan(longest, 33, 32, 32, 16384)[1] == "grid"
    assert window.window_plan(longest, 33, 32, 32, 16384,
                              window.H100_SMEM, 0)[1] == "nodes"
    assert window.window_plan(longest + 1, 33, 32, 32, 16384)[1] == "wide"


@pytest.mark.parametrize("k", [8192, 10240, 10242, 12288, 14336, 16000,
                               16384])
@pytest.mark.parametrize("clusters", [16, 20, 27, 30, 32, 40, 66])
def test_grid_slices_tile_k(k, clusters):
    """The grid layout's slices: a multiple of 8 columns, ceil(K / w) of
    them a whole number of clusters of GRID_CLUSTER, no more clusters
    than the card holds or kMaxGrid allows, at least MIN_GRID_CTAS
    slices, tiling K with none empty; the narrowest such width."""
    w = window.window_grid_width(k, clusters)
    s = window.GRID_CLUSTER
    g_max = min(clusters, window.MAX_GRID_CLUSTERS)
    fits = [x for x in range(8, k + 8, 8)
            if -(-k // x) % s == 0 and -(-k // x) // s <= g_max
            and -(-k // x) >= window.MIN_GRID_CTAS]
    if w is None:
        assert fits == []
        return
    assert w == fits[0]
    ctas = -(-k // w)
    assert w % 8 == 0 and ctas % s == 0
    assert window.MIN_GRID_CTAS <= ctas
    assert ctas // s <= min(clusters, window.MAX_GRID_CLUSTERS)
    assert (ctas - 1) * w < k <= ctas * w


def test_grid_plan_needs_the_clusters():
    """The grid layout takes the node-resident layout's place only with
    enough co-resident clusters: none (0, the chain entry) or too few for
    MIN_GRID_CTAS slices (15 of 4 at K = 16384) keep the node-resident
    layout at S = 16, with the window and its 4-step tail in the same
    layout; 16 clusters give 64 slices of 256 columns."""
    for t_win in (12, 4):
        shape = (t_win, 33, 32, 32, 16384)
        for clusters in (0, 1, 15):
            assert window.window_plan(*shape, window.H100_SMEM, clusters) == \
                (16, "nodes", window.NODES_TILE)
        assert window.window_plan(*shape, window.H100_SMEM, 16) == (
            window.GRID_CLUSTER, "grid", 256)
        assert window.window_plan(*shape) == (window.GRID_CLUSTER, "grid",
                                              152)
    assert window.window_grid_exchange_words(33, 32, 32, 16384, 152) == \
        27 * (33 * 32 + 33 + 64)


def test_launch_plan_separates_the_entries(monkeypatch):
    """launch_plan on a (faked) card: the chain entry never takes the
    grid layout, the single-chain entry takes it at the card's count of
    co-resident clusters (read at the H100's plan and again at the plan
    that count gives), and falls back to the node-resident layout when
    the card holds too few, or fewer at the final plan than it needs."""
    monkeypatch.setattr(window.kernels, "smem_limit",
                        lambda dev: window.H100_SMEM)
    dev = torch.device("cpu")
    shape = (12, 33, 32, 32, 16384)
    nodes = (16, "nodes", window.NODES_TILE)
    asked = []

    def fake(counts):
        def clusters(dev_index, shape, plan):
            asked.append(plan)
            return counts[plan[2]]
        monkeypatch.setattr(window, "_grid_clusters", clusters)

    fake({152: 30})
    assert window.launch_plan(shape, dev, True) == nodes
    assert asked == []
    assert window.launch_plan(shape, dev, False) == (4, "grid", 152)
    fake({152: 10})
    assert window.launch_plan(shape, dev, False) == nodes
    # a card that reports more clusters at the H100's plan than at the
    # narrower plan they lead to
    fake({152: 33, 128: 20})
    assert window.launch_plan(shape, dev, False) == nodes
    fake({152: 33, 128: 32})
    asked.clear()
    assert window.launch_plan(shape, dev, False) == (4, "grid", 128)
    assert [p[2] for p in asked] == [152, 128]
    # the resident mode and the step layouts ask nothing
    asked.clear()
    assert window.launch_plan((12, 33, 32, 32, 1024), dev, False)[1] == \
        "resident"
    assert window.launch_plan((12, 33, 32, 32, 4096), dev, False)[1] == "step"
    assert asked == []


@functools.cache
def _pinned_plans():
    """{(B, n, E, limit): [(T, K, grid_clusters, plan or error)]} of
    tests/fixtures/window_plans.txt."""
    table = {}
    path = Path(__file__).resolve().parent / "fixtures" / "window_plans.txt"
    for line in path.read_text().splitlines():
        if line.startswith("#"):
            continue
        key, *runs = line.split()
        b, n, e, k, limit, clusters = map(int, key.split(","))
        rows = table.setdefault((b, n, e, limit), [])
        first = 1
        for run in runs:
            last, plan = run.split(":")
            if "/" in plan:
                s, mode, wc = plan.split("/")
                plan = (int(s), mode, int(wc))
            rows += [(t, k, clusters, plan)
                     for t in range(first, int(last) + 1)]
            first = int(last) + 1
    return table


@pytest.mark.parametrize("limit", [232448, 160000, 100000])
@pytest.mark.parametrize("bne", [(33, 32, 32), (65, 32, 64), (9, 8, 8),
                                 (6, 7, 5)])
def test_window_plan_pinned(bne, limit):
    """window_plan at (B, n, E) and a card's shared memory per block, at
    every T = 1..65, K from 12 to 16384 (ragged, past the step layouts,
    between the grid's clusters) and 30, 16 or 0 co-resident grid
    clusters, gives the pinned plan, or raises the pinned error: the
    plans from before the planner read its bytes from the kernel's
    header."""
    rows = _pinned_plans()[(*bne, limit)]
    assert len(rows) == 65 * 21 * 3
    for t_win, k, clusters, want in rows:
        shape = (t_win, *bne, k)
        if want == "steps":
            with pytest.raises(ValueError, match="<= 64 steps"):
                window.window_plan(*shape, limit, clusters)
        elif want == "fits":
            with pytest.raises(ValueError,
                               match=re.escape(f"{shape} fits {limit} B")):
                window.window_plan(*shape, limit, clusters)
        else:
            assert window.window_plan(*shape, limit, clusters) == want, \
                (shape, limit, clusters)


@pytest.mark.parametrize("shape", [(12, 33, 32, 32, 4096),
                                   (3, 6, 7, 5, 12), (6, 33, 32, 32, 8192),
                                   (12, 33, 32, 32, 2050), (64, 9, 8, 8, 100),
                                   (12, 33, 32, 32, 16384)])
@pytest.mark.parametrize("s,wc", [(16, 128), (16, 64), (3, 64), (1, 128)])
def test_window_smem_bytes_mirror_the_kernel_layouts(shape, s, wc):
    """The host build of csrc/window_layout.h (window_layout_bytes) gives
    each of the kernel's six layouts (LAYOUT_MODES: the resident mode's
    Layout, StepLayout, Step1Layout, WideLayout with chunks of wc columns,
    NodesLayout with tiles of wc columns, GridLayout with slices of wc
    columns) the bytes LAYOUT_BYTES pins at (shape, S, wc); its slice
    width is ceil(K / S) rounded up to 4 where K is a multiple of 4, its
    grid exchange ceil(K / wc) / S clusters of B * n + B + 2E floats. On
    the card tests/test_torch_window_layout.py holds it against the
    kernel's build."""
    t_win, b_cap, n_smpl, e_cap, k = shape
    got = tuple(window.window_layout_bytes(shape, (s, mode, wc))
                for mode in LAYOUT_MODES)
    assert got == LAYOUT_BYTES[shape, s, wc]
    w = -(-k // s)
    assert window.window_slice_width(k, s) == (
        -(-w // 4) * 4 if k % 4 == 0 else w)
    assert window.window_grid_exchange_words(b_cap, n_smpl, e_cap, k, wc,
                                             s) == \
        -(-k // wc) // s * (b_cap * n_smpl + b_cap + 2 * e_cap)


def test_window_core_cuda_rejects_cpu_tensors():
    """The fused kernel's wrapper never runs on the CPU: on a CPU tensor
    it raises (windowed_scan picks the plain version by device)."""
    case, cfg, _ = _both(4, SHAPES[0])
    state, xs = testing.window_case_torch(case, "cpu")
    mcode, keep = _codes(cfg, xs)
    with pytest.raises(ValueError, match="CUDA"):
        window.window_apply_cuda(cfg, state, xs, mcode, keep)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at
    import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(12, 33, 32, 32, 256),
                                   (12, 33, 32, 32, 4096),
                                   (6, 33, 32, 32, 8192),
                                   (3, 33, 32, 32, 16384),
                                   (12, 33, 32, 32, 12288)])
def test_window_core_cuda_matches_plain_on_gpu(cuda_device, shape):
    """On a GPU: the fused kernel against its plain version at the bench
    shape (resident mode) and at the K = 4096, 8192, 16384 and 12288
    windows (the wide mode's step layout, its step layout with one set of
    rows and, the last two, its grid layout), each on its own copy of the
    state
    (the kernel writes pi in place): rtol 1e-5, atol 1e-8 normwise, as
    chip_smoke.py checks it."""
    case = testing.window_case(0, *shape)
    cfg = testing.window_case_config(case)
    state, xs = testing.window_case_torch(case, "cuda")
    mcode, keep = _codes(cfg, xs)
    clone = state._replace(pi=state.pi.clone(), phi_sum=state.phi_sum.clone())
    got = window.window_apply_cuda(cfg, state, xs, mcode, keep)
    want = window.window_apply_torch(cfg, clone, xs, mcode, keep)
    for f in ("pi", "phi_sum", "theta", "beta"):
        a, b = getattr(got, f), getattr(want, f)
        err = float((a - b).abs().max())
        assert err <= 1e-8 + 1e-5 * float(b.abs().max()), f


@pytest.mark.parametrize("n_nodes", [12, 40, 200_000])
def test_dirty_windows_match_jax(n_nodes):
    """_dirty_windows on 32 windows of the bench's (T, B, n) with ids
    drawn from n_nodes rows (few rows: every window collides; many: few
    do), masked lanes holding the sentinel: exactly JAX's."""
    rng = np.random.default_rng(n_nodes)
    nodes = rng.integers(0, n_nodes, (32, 12, 33)).astype(np.int32)
    mask = rng.random((32, 12, 33)) < 0.8
    nodes = np.where(mask, nodes, n_nodes).astype(np.int32)
    nbrs = rng.integers(0, n_nodes, (32, 12, 32)).astype(np.int32)
    got = window._dirty_windows(torch.as_tensor(nodes), torch.as_tensor(mask),
                                torch.as_tensor(nbrs), 12)
    want = jax_window._dirty_windows(jnp.asarray(nodes), jnp.asarray(mask),
                                     jnp.asarray(nbrs), 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() if n_nodes < 100 else not got.all()


@pytest.mark.parametrize("impl", ["pallas", "jnp"])
def test_auto_correction_equals_always(impl, monkeypatch):
    """window_correction='auto' runs as 'always' (JAX skips the codes of
    clean windows, which are all zero anyway), so a run equals the
    'always' run bit for bit, on both versions of the window (the plain
    one here), with both clean and dirty windows (counted by
    _dirty_windows on the operands of each call)."""
    from mcmc_ammsb_tpu_torch import config, data, learner

    n, u, v = data.synthetic_edges(3000, 6, seed=4)
    split = data.generate_sets(n, u, v, heldout_ratio=0.05, seed=5)
    graph = data.Graph.from_edges(n, split.training_u, split.training_v)
    found = []
    real = window.iter_windows

    def counted(cfg, xs, nbrs):
        t = cfg.window
        s_len = nbrs.shape[0] // t * t
        found.append(int(window._dirty_windows(
            *(a[:s_len].reshape(s_len // t, t, -1)
              for a in (xs[0].nodes, xs[0].node_mask, nbrs)), t).sum()))
        return real(cfg, xs, nbrs)

    monkeypatch.setattr(window, "iter_windows", counted)
    states = []
    for corr in ("always", "auto"):
        cfg = config.Config(
            K=8, mini_batch_size=8, num_node_sample=8, device_sampling=True,
            shared_neighbors=True, window=4, window_correction=corr,
            window_impl=impl, steps_per_call=48).finalize(
            n, split.total_edges, graph.max_fan_out)
        lrn = learner.Learner(cfg, graph, split, "cpu")
        found.clear()
        lrn.run(96)
        states.append(lrn.state)
    assert 0 < sum(found) < 24
    a, b = states
    for f in ("pi", "phi_sum", "theta", "beta"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
