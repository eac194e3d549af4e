"""The port's window engine (mcmc_ammsb_tpu_torch/ops/window.py) against
the JAX package's (mcmc_ammsb_tpu/ops/window.py) on the same seeded
operands: the bookkeeping exactly, the plain window core against the
JAX jnp core and against the Pallas kernel in interpret mode (the way
tests/test_window.py runs it on the CPU), the fused window's plain
version (gather, core, scatter) against JAX's three, and the kernel's
cluster-size rule. The CUDA kernel itself is checked against the plain
version on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_ammsb_tpu.ops import window as jax_window
from mcmc_ammsb_tpu_torch import testing
from mcmc_ammsb_tpu_torch.ops import window

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
    assert window.window_smem_bytes(*shape, s) <= window.H100_SMEM
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
# and the ragged K = 2050 (not a multiple of 4: 4-byte copies); the step
# layout (a step's rows in shared memory) up to K = 4096, the chunked one
# past it
WIDE_PLANS = [(12, 1536, "step"), (12, 2048, "step"), (12, 2050, "step"),
              (12, 3072, "step"), (12, 4096, "step"), (8, 6144, "wide"),
              (6, 8192, "wide"), (3, 16384, "wide")]


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
    path's shape (its max_safe_window T), the resident layout fits no
    cluster of an H100 and window_plan takes the wide mode in the layout
    WIDE_PLANS names, at S = 16: the step layout with a chunk that covers
    the slice (a multiple of 8), or the chunked one with a chunk of
    WIDE_CHUNKS narrower than the slice; its layout fits 232,448 B, its
    column slices tile K with none empty; every shorter window runs in
    one mode or another."""
    shape = (t_win, 33, 32, 32, k)
    with pytest.raises(ValueError):
        window.window_cluster_size(*shape)
    s, mode, wc = window.window_plan(*shape)
    w = window.window_slice_width(k, s)
    assert (s, mode) == (16, layout)
    if mode == "step":
        assert wc == window.step_chunk(k, s) and w <= wc < w + 8
        assert wc % 8 == 0
        smem = window.window_step_smem_bytes(*shape, s)
    else:
        assert wc in window.WIDE_CHUNKS and wc < w
        assert window.window_step_smem_bytes(*shape, s) > window.H100_SMEM
        smem = window.window_wide_smem_bytes(*shape, s, wc)
    assert smem <= window.H100_SMEM
    assert window.plan_smem_bytes(shape, (s, mode, wc)) == smem
    cols = [c for r in range(s) for c in range(r * w, min(k, (r + 1) * w))]
    assert cols == list(range(k))
    assert all(min(k, (r + 1) * w) > r * w for r in range(s))
    for t in range(1, t_win):
        window.window_plan(t, 33, 32, 32, k)


def test_window_plan_limits():
    """The plan refuses what the kernel refuses (n > 32 neighbors, T >
    64) and a limit that fits neither mode, naming the shape; with a
    smaller card the wide mode takes the chunked layout, narrower chunks
    and clusters; each plan's bytes fit its limit and 232,448 B."""
    with pytest.raises(ValueError, match="n <= 32"):
        window.window_plan(12, 33, 64, 32, 256)
    with pytest.raises(ValueError, match="<= 64 steps"):
        window.window_plan(65, 33, 32, 32, 256)
    with pytest.raises(ValueError, match=r"\(12, 33, 32, 32, 4096\)"):
        window.window_plan(12, 33, 32, 32, 4096, 50_000)
    narrow = window.window_wide_smem_bytes(12, 33, 32, 32, 4096, 16, 64)
    assert window.window_plan(12, 33, 32, 32, 4096, narrow) == (16, "wide",
                                                                 64)
    shape = (12, 33, 32, 32, 4096)
    step = window.window_step_smem_bytes(*shape, 16)
    assert step <= window.H100_SMEM
    assert window.window_plan(*shape, step) == (16, "step", 256)
    assert window.window_plan(*shape, step - 1) == (16, "wide", 128)
    for limit in (narrow, step - 1, step, window.H100_SMEM):
        plan = window.window_plan(*shape, limit)
        assert window.plan_smem_bytes(shape, plan) <= min(limit,
                                                          window.H100_SMEM)
    # the longest window the step layout holds at K = 4096 takes it; one
    # more step falls back to the chunked layout
    longest = max(t for t in range(1, 65) if window.window_step_smem_bytes(
        t, 33, 32, 32, 4096, 16) <= window.H100_SMEM)
    assert longest >= 12
    assert window.window_plan(longest, 33, 32, 32, 4096)[1] == "step"
    assert window.window_plan(longest + 1, 33, 32, 32, 4096)[1] == "wide"


def _cu_layout_words(fn: str, **dims) -> int:
    """The word count of csrc/window_kernel.cu's ``fn`` (``layout``,
    ``layout_wide`` or ``layout_step``) at ``dims``, evaluated from the
    source text: each ``o += <expr>;`` of the function, its casts dropped
    and its integer divisions made Python's (the helpers it calls written
    out again here)."""
    import re
    from pathlib import Path

    src = (Path(window.__file__).resolve().parent.parent / "csrc"
           / "window_kernel.cu").read_text()
    body = re.search(rf"inline \w+ {fn}\(.*?\n}}\n", src, re.S).group(0)
    env = dict(dims, kWarps=16,
               up4=lambda x: -(-x // 4) * 4, larger=max,
               q_splits=lambda b: (1 if -(-b // 11) >= 16
                                   else 16 // -(-b // 11)),
               fan_groups=lambda kw: 512 // kw if kw <= 512 else 1,
               words_of_bits=lambda x: -(-x // 32),
               row_stride=lambda w: 4 * (-(-w // 4) + 1 + (-(-w // 4)) % 2))

    def py(expr):
        return re.sub(r"\(size_t\)", "", expr).replace("/", "//")

    for name, expr in re.findall(r"const size_t (\w+) = ([^,;]+)", body):
        env[name] = eval(py(expr), {}, env)
    for decl in re.findall(r"const size_t ([^;]+);", body):
        for name, expr in re.findall(r"(\w+) = ([^,]+)", decl):
            env[name] = eval(py(expr), {}, env)
    return sum(eval(py(e), {}, env)
               for e in re.findall(r"o \+= ([^;]+);", body))


@pytest.mark.parametrize("shape", [(12, 33, 32, 32, 4096),
                                   (3, 6, 7, 5, 12), (6, 33, 32, 32, 8192),
                                   (12, 33, 32, 32, 2050), (64, 9, 8, 8, 100)])
@pytest.mark.parametrize("s,wc", [(16, 128), (16, 64), (3, 64), (1, 128)])
def test_window_smem_bytes_mirror_the_kernel_layouts(shape, s, wc):
    """window_wide_smem_bytes is struct WideLayout's layout_wide,
    window_step_smem_bytes struct StepLayout's layout_step and
    window_smem_bytes struct Layout's layout, term by term: each equals
    the sum of csrc/window_kernel.cu's own expressions, read from the
    source (on the card chip_smoke.py also holds them against the built
    kernel's window_kernel_smem_bytes)."""
    t_win, b_cap, n_smpl, e_cap, k = shape
    kw = window.window_slice_width(k, s)
    dims = dict(T=t_win, B=b_cap, n=n_smpl, E=e_cap, kw=kw, S=s)
    assert 4 * _cu_layout_words("layout_wide", wc=wc, **dims) == \
        window.window_wide_smem_bytes(*shape, s, wc)
    assert 4 * _cu_layout_words("layout", **dims) == \
        window.window_smem_bytes(*shape, s)
    assert 4 * _cu_layout_words("layout_step", **dims) == \
        window.window_step_smem_bytes(*shape, s)


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
                                   (6, 33, 32, 32, 8192)])
def test_window_core_cuda_matches_plain_on_gpu(cuda_device, shape):
    """On a GPU: the fused kernel against its plain version at the bench
    shape (resident mode) and at the K = 4096 and 8192 windows (the wide
    mode's step and chunked layouts), each on its own copy of the state
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
