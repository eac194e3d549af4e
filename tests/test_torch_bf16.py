"""bfloat16 pi storage in the port (``Config.pi_dtype``), held against the
JAX package's (tests/test_bf16_pi.py) on the CPU.

The contract is JAX's: only pi's rows are stored in bf16; phi_sum, theta,
beta and the perplexity state stay float32 and all compute is float32;
gathered rows are upcast, written rows are rounded to nearest-even at the
write-back, and inside a window a redirected read sees the earlier step's
float32 value. Two evaluations of the same float32 steps may round a
stored value to neighbouring bf16 values, so rows are compared by
``testing.bf16_gaps``: each version's bf16 result is its own float32
result rounded, bit for bit, and the two versions' stored values are
equal or one ulp apart, farther only as far as their float32 values
differ.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from functools import partial

from mcmc_ammsb_tpu import learner as jax_learner
from mcmc_ammsb_tpu.chains_flat import _windowed_chain_scan as jax_chain_scan
from mcmc_ammsb_tpu.ops import phi as jax_phi
from mcmc_ammsb_tpu.ops.window import windowed_scan as jax_windowed_scan
from mcmc_ammsb_tpu_torch import chains, chains_flat, checkpoint, testing
from mcmc_ammsb_tpu_torch.config import Config, PhiImpl, RngBackend
from mcmc_ammsb_tpu_torch.data import (Graph, generate_sets,
                                       synthetic_sbm_edges)
from mcmc_ammsb_tpu_torch.learner import Learner
from mcmc_ammsb_tpu_torch.models import mmsb
from mcmc_ammsb_tpu_torch.ops import window
from mcmc_ammsb_tpu_torch.parallel.dryrun import spawn

import torch_dist_workers as W
from torch_parity import assert_close, jax_chain_window, jax_config, \
    jax_window_case

BF16 = torch.bfloat16
# (T, B, n, E, K) of the window checks: a collision-heavy tiny window,
# the odd shape and one with m > n (tests/test_torch_window.py's)
SHAPES = [(4, 9, 8, 8, 16), (3, 6, 7, 5, 12), (5, 14, 3, 13, 24)]
CHAIN_SHAPES = [(3, 4, 9, 8, 8, 16), (2, 3, 6, 7, 5, 12)]


def _setup(seed=8, **kw):
    """JAX's bf16 test problem (tests/test_bf16_pi.py:_setup): a planted
    4-block graph of 400 nodes, K=8, m=n=8, chunks of 10."""
    n, u, v = synthetic_sbm_edges(400, 4, p_in=0.12, p_out=0.005, seed=seed)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=seed + 1)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=8,
                 steps_per_call=10, device_sampling=True, **kw)
    return cfg.finalize(n, split.total_edges, graph.max_fan_out), graph, split


@pytest.fixture(scope="module")
def problem():
    return _setup(pi_dtype="bfloat16")


def _make(kind, cfg, graph, split):
    if kind.startswith("flat-chains"):
        return chains_flat.FlatChainLearner(cfg, graph, split, 2, "cpu")
    return Learner(cfg, graph, split, "cpu", prefetch=False)


WINDOWED = dict(shared_neighbors=True, window=5)
KINDS = {"learner": {}, "learner-windowed": WINDOWED, "flat-chains": {},
         "flat-chains-windowed": WINDOWED}


@pytest.mark.parametrize("kind", ["learner", "flat-chains"])
def test_state_dtypes(problem, kind):
    """pi is bf16; phi_sum, theta, beta and the running averages float32
    (JAX's pi_storage_dtype); the rows sum to one within bf16 rounding."""
    cfg, graph, split = problem
    lrn = _make(kind, cfg, graph, split)
    st = lrn.state
    assert st.pi.dtype == BF16
    for f in ("phi_sum", "theta", "beta", "ppx_per_edge"):
        assert getattr(st, f).dtype == torch.float32, f
    np.testing.assert_allclose(st.pi.float().sum(-1).numpy(), 1.0,
                               atol=0.05)


@pytest.mark.parametrize("kind", ["learner", "flat-chains"])
def test_init_is_normalize_then_cast(problem, kind):
    """The bf16 init is the float32 init's rows rounded to nearest-even,
    bit for bit (JAX's chunked_pi_rows: normalize each block in float32,
    then cast), from the same device draws; phi_sum and theta are the
    float32 init's exactly."""
    cfg, graph, split = problem
    a = _make(kind, cfg, graph, split).state
    b = _make(kind, cfg.replace(pi_dtype="float32"), graph, split).state
    assert torch.equal(a.pi, b.pi.to(BF16))
    assert torch.equal(a.phi_sum, b.phi_sum)
    assert torch.equal(a.theta, b.theta)
    if kind == "learner":
        # and the same law written out: the blocks of the device law (one
        # here), divided by their row sums in float32, then rounded
        from mcmc_ammsb_tpu_torch import learner as lrn
        assert lrn.pi_block_rows(cfg.K) >= cfg.N
        g = lrn.pi_gamma_block(cfg, 0, cfg.N, "cpu")
        assert torch.equal(a.pi, (g / g.sum(-1, keepdim=True)).to(BF16))


def _gaps_small(gaps, values):
    """The rounding rule's counts: nothing unexplained, and at most 1% of
    the written values (at least 2) off the other version's."""
    assert gaps["unexplained"] == 0, gaps
    assert gaps["one_ulp"] + gaps["more_ulps"] <= max(2, values // 100), gaps


def _jax_bf16(state):
    return state._replace(pi=state.pi.astype(jnp.bfloat16))


@pytest.mark.parametrize("shape", SHAPES)
def test_window_matches_jax_windowed_scan(shape):
    """One window of injected operands through the port's windowed_scan
    (the plain window: gather upcast, float32 steps, scatter rounded) and
    JAX's windowed_scan (jnp core) at bf16: each stores its own float32
    result rounded; the two agree by testing.bf16_gaps; phi_sum, theta
    and beta at test_torch_window's bound (rtol 5e-5, atol 1e-8)."""
    case = testing.window_case(5, *shape)
    cfg = testing.window_case_config(case).replace(pi_dtype="bfloat16",
                                                   window_impl="jnp")
    jcfg = jax_config(cfg)
    js, jxs = jax_window_case(case)
    out = {}
    for bits in ("16", "32"):
        state, xs = testing.window_case_torch(case, "cpu")
        pi16 = state.pi.to(BF16)
        state = state._replace(pi=pi16 if bits == "16" else pi16.float())
        out["port" + bits] = window.windowed_scan(cfg, state, xs, None)
        jstate = _jax_bf16(js) if bits == "16" else js._replace(
            pi=_jax_bf16(js).pi.astype(jnp.float32))
        out["jax" + bits] = jax_windowed_scan(jcfg, jstate, jxs, None)
    port, jx = out["port16"], out["jax16"]
    assert port.pi.dtype == BF16 and jx.pi.dtype == jnp.bfloat16
    assert torch.equal(port.pi, out["port32"].pi.to(BF16))
    jpi = torch.tensor(np.asarray(jx.pi.astype(jnp.float32)))
    assert torch.equal(jpi.to(BF16), torch.tensor(
        np.asarray(out["jax32"].pi)).to(BF16))
    gaps = testing.bf16_gaps(port.pi, jpi.to(BF16), out["port32"].pi,
                             torch.tensor(np.asarray(out["jax32"].pi)))
    written = int(np.asarray(case["node_mask"]).sum()) * shape[4]
    _gaps_small(gaps, written)
    for f in ("phi_sum", "theta", "beta"):
        assert_close(getattr(port, f), getattr(jx, f), 5e-5, 1e-8, f)


def test_step_matches_jax():
    """One unwindowed step (``_hoisted_step_body``, shared draws) on the
    injected operands of a window case, the port against JAX's at bf16:
    the rows by testing.bf16_gaps against each version's float32 step on
    the upcast table (one step: the next would read rounded rows),
    phi_sum, theta, beta at rtol 5e-5."""
    from mcmc_ammsb_tpu_torch import learner

    case = testing.window_case(7, 1, 9, 8, 8, 16)
    cfg = testing.window_case_config(case).replace(pi_dtype="bfloat16",
                                                   window=0)
    jcfg = jax_config(cfg)
    body = partial(jax_learner._hoisted_step_body, jcfg,
                   jax_phi.phi_update_core)
    out = {}
    for bits in ("16", "32"):
        state, xs = testing.window_case_torch(case, "cpu")
        pi16 = state.pi.to(BF16)
        state = state._replace(pi=pi16 if bits == "16" else pi16.float())
        out["port" + bits] = learner.run_hoisted(cfg, state, xs)
        js, jxs = jax_window_case(case)
        js = _jax_bf16(js)
        if bits == "32":
            js = js._replace(pi=js.pi.astype(jnp.float32))
        js, _ = body(js, tuple(
            type(a)(*(f[0] for f in a)) if hasattr(a, "_fields") else a[0]
            for a in jxs))
        out["jax" + bits] = js
    port, jx = out["port16"], out["jax16"]
    assert port.pi.dtype == BF16
    assert port.step_count == case["step_count"] + 1
    jpi = torch.tensor(np.asarray(jx.pi.astype(jnp.float32))).to(BF16)
    assert torch.equal(port.pi, out["port32"].pi.to(BF16))
    gaps = testing.bf16_gaps(port.pi, jpi, out["port32"].pi,
                             torch.tensor(np.asarray(out["jax32"].pi)))
    _gaps_small(gaps, int(np.asarray(case["node_mask"]).sum()) * 16)
    for f in ("phi_sum", "theta", "beta"):
        assert_close(getattr(port, f), getattr(jx, f), 5e-5, 1e-8, f)


@pytest.mark.parametrize("shape", CHAIN_SHAPES)
def test_flat_chain_window_matches_jax(shape):
    """One window of C chains through the port's windowed_chain_scan and
    JAX's _windowed_chain_scan (jnp core) at bf16, compared as the single
    window is."""
    c = shape[0]
    case = testing.chain_window_case(1, *shape)
    cfg = testing.chain_window_case_config(case).replace(
        pi_dtype="bfloat16", window_impl="jnp")
    jcfg = jax_config(cfg)
    jxs = tuple(jnp.asarray(case[f]) for f in testing.CHAIN_FIELDS)
    out = {}
    for bits in ("16", "32"):
        state, xw = testing.chain_window_case_torch(case, "cpu")
        pi16 = state.pi.to(BF16)
        state = state._replace(pi=pi16 if bits == "16" else pi16.float())
        out["port" + bits] = chains_flat.windowed_chain_scan(cfg, c, state,
                                                             xw, None)
        js = jax_chain_window(jcfg, c, case)["state"]
        js = _jax_bf16(js)
        if bits == "32":
            js = js._replace(pi=js.pi.astype(jnp.float32))
        out["jax" + bits] = jax_chain_scan(jcfg, c, js, jxs, None)
    port, jx = out["port16"], out["jax16"]
    assert port.pi.dtype == BF16 and jx.pi.dtype == jnp.bfloat16
    assert torch.equal(port.pi, out["port32"].pi.to(BF16))
    jpi = torch.tensor(np.asarray(jx.pi.astype(jnp.float32))).to(BF16)
    gaps = testing.bf16_gaps(port.pi, jpi, out["port32"].pi,
                             torch.tensor(np.asarray(out["jax32"].pi)))
    _gaps_small(gaps, int(np.asarray(case["node_mask"]).sum()) * shape[-1])
    for f in ("phi_sum", "theta", "beta"):
        assert_close(getattr(port, f), getattr(jx, f), 5e-5, 1e-8, f)


@pytest.mark.parametrize("kind", list(KINDS))
def test_bf16_tracks_fp32_ppx(kind):
    """JAX's convergence contract (test_bf16_tracks_fp32_ppx and its
    windowed and flat-chain twins): 300 steps from the same seeds, the
    bf16 run's held-out perplexity falls and stays within 5% of the
    float32 run's (every chain's)."""
    cfg, graph, split = _setup(pi_dtype="bfloat16", **KINDS[kind])
    a = _make(kind, cfg, graph, split)
    b = _make(kind, cfg.replace(pi_dtype="float32"), graph, split)
    p0 = a.heldout_perplexity()
    b.heldout_perplexity()
    a.run(300)
    b.run(300)
    pa, pb = a.heldout_perplexity(), b.heldout_perplexity()
    assert np.all(np.isfinite(pa)) and np.all(pa < p0)
    np.testing.assert_array_less(np.abs(pa - pb) / pb, 0.05)
    assert a.state.pi.dtype == BF16
    np.testing.assert_allclose(a.state.pi.float().sum(-1).numpy(), 1.0,
                               atol=0.05)


@pytest.mark.parametrize("backend", ["npz", "orbax"])
@pytest.mark.parametrize("kind", ["learner-windowed", "flat-chains"])
def test_bf16_resume_bit_exact(tmp_path, kind, backend):
    """Run 20, save, run 30 == restore, run 30, bit for bit, in both
    checkpoint backends: the npz stores bf16 rows as float32 (lossless),
    the directory as bf16; the restored pi is bf16."""
    cfg, graph, split = _setup(pi_dtype="bfloat16", **KINDS[kind])
    path = str(tmp_path / f"bf16_{backend}")
    a = _make(kind, cfg, graph, split)
    a.run(20)
    checkpoint.save_checkpoint(path, a, backend=backend)
    a.run(30)
    b = _make(kind, cfg, graph, split)
    checkpoint.load_checkpoint(path, b)
    assert b.state.pi.dtype == BF16
    b.run(30)
    for f in ("pi", "phi_sum", "theta", "beta"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
    if backend == "npz":
        with np.load(path) as z:
            assert z["leaf_0"].dtype == np.float32


@pytest.mark.parametrize("change, engine, match", [
    (dict(phi_impl=PhiImpl.PALLAS), "learner", "pi_dtype"),
    (dict(rng_backend=RngBackend.REFERENCE, device_sampling=False),
     "learner", "pi_dtype|fp32"),
    ({}, "vmap", "fp32"),
    ({}, "mmsb", "keeps pi in fp32"),
    ({}, "mmsb-chains", "keep pi in fp32"),
    (dict(pi_dtype="float16"), "learner", "unknown pi_dtype"),
])
def test_refusals_with_jax_wording(problem, change, engine, match):
    """The engines that the JAX package runs in float32 only refuse bf16
    with its words (tests/test_bf16_pi.py::
    test_bf16_unsupported_engines_raise, test_unknown_pi_dtype_raises):
    --phi-impl pallas, the reference RNG, the vmap chain engine, the full
    MMSB and MMSB chains; an unknown dtype too."""
    cfg, graph, split = problem
    cfg = cfg.replace(**change)
    make = {"learner": lambda: Learner(cfg, graph, split, "cpu"),
            "vmap": lambda: chains.MultiChainLearner(cfg, graph, split, 2,
                                                     "cpu"),
            "mmsb": lambda: mmsb.FullMMSBLearner(cfg, graph, split, "cpu"),
            "mmsb-chains": lambda: mmsb.MMSBChainLearner(cfg, graph, split,
                                                         2, "cpu")}[engine]
    with pytest.raises(ValueError, match=match):
        make()


def test_bf16_gaps_rule():
    """testing.bf16_gaps: equal values, one ulp apart, several ulps apart
    where the float32 values are that far apart (explained), and several
    ulps apart from equal float32 values (unexplained)."""
    f32 = torch.tensor([0.5, 0.5, 1.0, 1.0])
    got = torch.tensor([0.5, 0.5, 1.0, 1.0]).to(BF16)
    want = torch.tensor([0.5, 0.50390625, 1.0625, 1.0625]).to(BF16)
    got32 = f32.clone()
    want32 = torch.tensor([0.5, 0.502, 1.0625, 1.0])
    gaps = testing.bf16_gaps(got, want, got32, want32)
    assert gaps == {"one_ulp": 1, "more_ulps": 2, "max_ulps": 8,
                    "unexplained": 1}


def test_sharded_bf16_matches_learner(tmp_path):
    """Two gloo ranks: a (1, 2) mesh with bf16 pi (the fetch upcasts the
    local rows before the all-reduce, the write-back rounds) against the
    single-GPU bf16 Learner from the same seeds, unwindowed and at window
    4: the globals within the sharded engine's tolerance
    (test_torch_sharded.py::test_model_axis_is_invisible: rtol 2e-4,
    atol 1e-7; measured bit-equal), pi bf16 on the ranks; and run, save,
    run == restore, run on the mesh in both backends."""
    out = spawn(W.suite, 2, ([("bf", "bf16_runs",
                               (5, 1, 2, str(tmp_path)))],), timeout=150)
    r = out[0]["bf"]
    cfg, graph, split = W.graph_case(5, device_sampling=True,
                                     shared_neighbors=True,
                                     steps_per_call=24, pi_dtype="bfloat16")
    for w in (0, 4):
        single = Learner(cfg.replace(window=w), graph, split, "cpu")
        p0 = single.heldout_perplexity()
        single.run(24)
        single.run(24)
        got = r[f"w{w}"]
        assert got["dtype"] == "torch.bfloat16"
        np.testing.assert_allclose(got["pi"], single.state.pi.float().numpy(),
                                   rtol=2e-4, atol=1e-7)
        np.testing.assert_allclose(got["theta"], single.state.theta.numpy(),
                                   rtol=2e-4, atol=1e-7)
        np.testing.assert_allclose(got["ppx"], (p0,
                                                single.heldout_perplexity()),
                                   rtol=1e-4)
        assert got["ppx"][1] < got["ppx"][0]
    for backend in ("npz", "orbax"):
        a, b, dtype = r[f"resume_{backend}"]
        assert dtype == "torch.bfloat16" and a["step"] == b["step"] == 49
        for f in ("pi", "phi", "theta", "beta"):
            np.testing.assert_array_equal(a[f], b[f])


@pytest.mark.cuda
def test_bf16_kernel_matches_plain_on_gpu():
    """On a GPU: the window kernel's bf16 mode against its float32 mode
    on the upcast rows (bit for bit once rounded) and the plain version
    at bf16 (chip_smoke.bf16_agree)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    case = testing.window_case(0, 12, 33, 32, 32, 256)
    cfg = testing.window_case_config(case)
    state, xs = testing.window_case_torch(case, "cuda")
    batch, nbrs = xs[0], xs[1][:, 0, :]
    mcode = window._correction_codes(cfg, batch.nodes, batch.node_mask, nbrs)
    keep = window._last_write_wins(batch.nodes, batch.node_mask, 12)
    gaps, _ = chip_smoke.bf16_agree(testing, cfg, state, (xs, mcode, keep),
                                    window.window_apply_cuda,
                                    window.window_apply_torch, "bf16")
    assert gaps["unexplained"] == 0
