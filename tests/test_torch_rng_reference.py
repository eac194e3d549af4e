"""The port's bit-exact reference RNG (mcmc_ammsb_tpu_torch/rng/) against
the JAX package's, on the CPU, where ``rng/refblock.py`` runs its plain
version (``rng/reference.py``).

The contract, as measured on torch 2.13 (CPU) against jax 0.9 (XLA CPU):

* integer streams are bit-equal: ``make_seeds``, ``rand_u64``,
  ``uniform``, ``randint`` and ``sample_neighbors_reference`` give the
  same words, values and seeds over 1000 lanes x 64 draws, masked and
  unmasked;
* ``randn``: the seeds after every call are bit-equal, and the values
  too, except tail draws (|x| > R = 3.444), whose log and exp may round
  one ulp apart between the two libraries; they are counted;
* ``rand_gamma``: the seeds after every call are bit-equal; the values
  are not, because XLA's CPU compiler contracts ``1 + c*x`` into a fused
  multiply-add where the port (and its CUDA kernel) rounds the product and
  the sum apart. The values are held within the bound that contraction
  leaves, stated below;
* a whole ``--rng reference`` run of the port's ``Learner`` matches the
  JAX ``Learner`` (20 host-sampled steps, N = 300, K = 16): the chunk's
  neighbor draws exact, its noise by the randn contract, the seeds exact
  after the run, the state normwise rtol 5e-5 atol 1e-8, the next
  perplexity rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_ammsb_tpu import learner as jax_learner
from mcmc_ammsb_tpu.data import DataSplit as JaxDataSplit
from mcmc_ammsb_tpu.data import Graph as JaxGraph
from mcmc_ammsb_tpu.rng import refblock as jax_refblock
from mcmc_ammsb_tpu.rng import reference as J
from mcmc_ammsb_tpu_torch import cli, config, learner
from mcmc_ammsb_tpu_torch.data import Graph, generate_sets, synthetic_edges
from mcmc_ammsb_tpu_torch.rng import reference as T
from mcmc_ammsb_tpu_torch.rng import refblock

from torch_parity import assert_normwise, jax_config, require_native

LANES = 1000
DRAWS = 64
REF = config.RngBackend.REFERENCE


def _lane_mask(masked: bool):
    if not masked:
        return None, None
    m = np.random.default_rng(3).random(LANES) < 0.7
    return jnp.asarray(m), torch.as_tensor(m)


def _seeds(pair=(12345, 67890), lanes=LANES):
    js, ts = J.make_seeds(pair, lanes), T.make_seeds(pair, lanes)
    np.testing.assert_array_equal(np.asarray(js).astype(np.int64),
                                  ts.numpy())
    return js, ts


def _same_seeds(js, ts):
    np.testing.assert_array_equal(np.asarray(js).astype(np.int64),
                                  ts.numpy())


def randn_ulps(got, want):
    """Per-value ulp distance of two float32 arrays of the same signs."""
    a = np.asarray(got, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(want, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def assert_randn_contract(got, want):
    """Bit-equal but tail draws, which may be one ulp apart; returns
    their count."""
    got, want = np.asarray(got), np.asarray(want)
    ulps = randn_ulps(got, want)
    off = ulps > 0
    assert ulps.max(initial=0) <= 1
    assert (np.abs(want[off]) > T.PARAM_R).all()
    return int(off.sum())


def test_tables_and_seeds_equal_jax():
    y, k, w = T.build_ziggurat_tables()
    np.testing.assert_array_equal(y, np.asarray(J._YTAB))
    np.testing.assert_array_equal(k, np.asarray(J._KTAB))
    np.testing.assert_array_equal(w, np.asarray(J._WTAB))
    for pair in [(0, 0), (42, 43), (2 ** 64 - 3, 2 ** 32 - 1)]:
        _seeds(pair, 300)


@pytest.mark.parametrize("masked", [False, True])
def test_integer_streams_bit_equal(masked):
    """rand_u64, uniform and randint: words, values and seeds after every
    draw, 1000 lanes x 64 draws of each."""
    jm, tm = _lane_mask(masked)
    js, ts = _seeds()
    rand_u64, uniform = jax.jit(J.rand_u64), jax.jit(J.uniform)
    randint = jax.jit(J.randint, static_argnums=(1, 2))
    for d in range(DRAWS):
        jh, jl, js = rand_u64(js, jm)
        th, tl, ts = T.rand_u64(ts, tm)
        np.testing.assert_array_equal(np.asarray(jh).astype(np.int64),
                                      th.numpy())
        np.testing.assert_array_equal(np.asarray(jl).astype(np.int64),
                                      tl.numpy())
        ju, js = uniform(js, jm)
        tu, ts = T.uniform(ts, tm)
        np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
        jr, js = randint(js, 3, 317_082, jm)
        tr, ts = T.randint(ts, 3, 317_082, tm)
        np.testing.assert_array_equal(np.asarray(jr).astype(np.int64),
                                      tr.numpy())
        _same_seeds(js, ts)


@pytest.mark.parametrize("masked", [False, True])
def test_neighbors_bit_equal(masked):
    """sample_neighbors_reference: 3 successive draws of 32 distinct ids
    per lane (slot order), the node itself excluded, seeds equal; the
    chunk form neighbors_lanes equals the per-step calls."""
    jm, tm = _lane_mask(masked)
    js, ts = _seeds((7, 11))
    nodes = np.random.default_rng(1).integers(0, 300, (3, LANES),
                                              dtype=np.int32)
    want = []
    for s in range(3):
        jn, js = J.sample_neighbors_reference(js, jnp.asarray(nodes[s]), 300,
                                              32, jm)
        want.append(np.asarray(jn).astype(np.int64))
    mask = (torch.ones(3, LANES, dtype=torch.bool) if tm is None
            else tm.expand(3, LANES))
    got, ts = T.neighbors_lanes(T.make_seeds((7, 11), LANES),
                                torch.as_tensor(nodes), mask, 300, 32)
    np.testing.assert_array_equal(got.numpy(), np.stack(want))
    _same_seeds(js, ts)
    assert (got.numpy() != nodes[..., None]).all()


@pytest.mark.parametrize("masked", [False, True])
def test_randn_contract(masked):
    """64 N(0,1) per lane as one chunk step (randn_lanes) against JAX's
    block decoder (the same bits as its faithful loop,
    tests/test_refblock.py): the seeds bit-equal, the values bit-equal
    but tail draws, <= 1 ulp; masked lanes give zeros and keep their
    seeds."""
    jm, tm = _lane_mask(masked)
    js, ts = _seeds((99, 5))
    want, js = jax_refblock.randn_block(js, DRAWS, jm)
    mask = (torch.ones(1, LANES, dtype=torch.bool) if tm is None
            else tm[None])
    got, ts = refblock.randn_lanes(ts, DRAWS, mask)
    _same_seeds(js, ts)
    tails = assert_randn_contract(got[0].numpy(), want)
    assert tails <= 10        # 64,000 draws, ~0.03% of them tail draws
    if tm is not None:
        assert not got[0][~tm].any()
        np.testing.assert_array_equal(ts[~tm].numpy(),
                                      T.make_seeds((99, 5), LANES)[~tm])


def test_gamma_contract():
    """Gamma(1, 1) from 3000 streams, then Gamma(0.5, 2) (the a < 1 boost)
    from the same ones: the seeds bit-equal after each call (every
    accept/reject decision agrees); the values equal JAX's up to its
    fused multiply-add in v = 1 + c*x, whose rounding the cube v^3
    carries: measured at most 38 ulp, 3.1e-6 relative, on 18% of the
    draws. Held normwise at rtol 1e-5 and by count."""
    js, ts = _seeds((5, 7), 3000)
    for a, b in [(1.0, 1.0), (0.5, 2.0)]:
        jg, js = J.rand_gamma(js, a, b)
        tg, ts = refblock.gamma_lanes(ts, a, b,
                                      torch.ones(1, 3000, dtype=torch.bool))
        _same_seeds(js, ts)
        tg = tg[0].numpy()
        assert_normwise(tg, np.asarray(jg), 1e-5, 0.0, f"gamma({a})")
        assert np.mean(tg != np.asarray(jg)) < 0.3
        assert (tg > 0).all()


# ---------------------------------------------------------------------------
# The learner
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dataset():
    n, u, v = synthetic_edges(300, 8, seed=9)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=10)
    return n, split, Graph.from_edges(n, split.training_u, split.training_v)


def _cfg(dataset, **kw):
    n, split, graph = dataset
    kw = dict(dict(K=16, mini_batch_size=16, num_node_sample=8,
                   steps_per_call=10, host_sampler="numpy",
                   rng_backend=REF), **kw)
    return config.Config(**kw).finalize(n, split.total_edges,
                                        graph.max_fan_out)


def _jax_learner(dataset, cfg):
    n, split, graph = dataset
    return jax_learner.Learner(
        jax_config(cfg), JaxGraph.from_edges(n, split.training_u,
                                             split.training_v),
        JaxDataSplit(**dataclasses.asdict(split)), prefetch=False)


def test_init_matches_jax(dataset):
    """The reference init: the seeds of the three stream families exact;
    theta and pi within the gamma contract (normwise rtol 1e-5)."""
    n, split, graph = dataset
    cfg = _cfg(dataset)
    jstate = jax_learner.init_state(jax_config(cfg), 5)
    state = learner.init_state(cfg, 5, "cpu")
    for f in learner.RefRngState._fields:
        _same_seeds(getattr(jstate.ref_seeds, f),
                    getattr(state.ref_seeds, f))
    for f in ("theta", "beta", "pi", "phi_sum"):
        assert_normwise(getattr(state, f), np.asarray(getattr(jstate, f)),
                        1e-5, 0.0, f)


def test_whole_run_matches_jax(dataset):
    """20 host-sampled steps in chunks of 10 with --rng reference, both
    packages from the same seeds and the same host batches: the first
    chunk's neighbor draws exact and its noise by the randn contract
    (against JAX's per-step draws), the seeds exact after the run, the
    state normwise rtol 5e-5 atol 1e-8, the next held-out perplexity
    rtol 1e-5."""
    n, split, graph = dataset
    cfg = _cfg(dataset)
    jl = _jax_learner(dataset, cfg)
    tl = learner.Learner(cfg, graph, split, "cpu", prefetch=False)

    # the first chunk's draws, from a sampler of the same seeds
    from mcmc_ammsb_tpu_torch.sampling import MiniBatchSampler
    chunk = MiniBatchSampler(cfg, graph, split).sample_many(10)
    batches = learner.DeviceBatch.from_stacked(chunk, "cpu")
    nbrs, phi_noise, beta_noise, _ = learner.reference_operands(
        cfg, batches, tl.state.ref_seeds)
    seeds = jl.state.ref_seeds
    neighbors_block = jax.jit(jax_refblock.sample_neighbors_block,
                              static_argnums=(2, 3))
    randn_block = jax.jit(jax_refblock.randn_block, static_argnums=1)
    tails = 0
    for s in range(10):
        nodes, mask = jnp.asarray(chunk.nodes[s]), jnp.asarray(
            chunk.node_mask[s])
        jn, nb = neighbors_block(seeds.neighbor, nodes, cfg.N,
                                 cfg.num_node_sample, mask)
        jp, ph = randn_block(seeds.phi, cfg.K, mask)
        jb, be = randn_block(seeds.beta, 2)
        seeds = seeds._replace(neighbor=nb, phi=ph, beta=be)
        np.testing.assert_array_equal(
            nbrs[s].numpy(), np.minimum(np.asarray(jn), cfg.N - 1))
        tails += assert_randn_contract(phi_noise[s].numpy(), jp)
        tails += assert_randn_contract(beta_noise[s].numpy(), jb)
    assert tails <= 3

    jl.run(20)
    tl.run(20)
    for f in learner.RefRngState._fields:
        _same_seeds(getattr(jl.state.ref_seeds, f),
                    getattr(tl.state.ref_seeds, f))
    for f in ("pi", "phi_sum", "theta", "beta"):
        assert_normwise(getattr(tl.state, f), np.asarray(getattr(jl.state, f)),
                        5e-5, 1e-8, f)
    assert tl.state.step_count == int(jl.state.step_count) == 21
    np.testing.assert_allclose(tl.heldout_perplexity(),
                               jl.heldout_perplexity(), rtol=1e-5)
    jl.close()
    tl.close()


@pytest.mark.parametrize("spc, phi", [(5, config.PhiImpl.JNP),
                                      (1, config.PhiImpl.PALLAS)])
def test_no_ref_rng_block_is_identical(dataset, spc, phi):
    """--no-ref-rng-block (the plain version on any device) gives the
    default's trajectory bit for bit: scanned chunks and one step at a
    time; and chunks of one equal the step-at-a-time run."""
    n, split, graph = dataset
    runs = []
    for block in (True, False):
        lrn = learner.Learner(
            _cfg(dataset, steps_per_call=spc, phi_impl=phi,
                 ref_rng_block=block), graph, split, "cpu", prefetch=False)
        lrn.run(12)
        runs.append(lrn.state)
        lrn.close()
    a, b = runs
    for f in ("pi", "phi_sum", "theta", "beta"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for f in learner.RefRngState._fields:
        assert torch.equal(getattr(a.ref_seeds, f), getattr(b.ref_seeds, f))


def test_theta_init_libstdcxx_equals_jax(dataset):
    """--theta-init libstdc++: the reference's own std::mt19937 +
    std::gamma_distribution stream through the native library, equal to
    the JAX package's theta, with either RNG."""
    require_native()
    from mcmc_ammsb_tpu import native as jax_native
    if not jax_native.available():
        pytest.skip("the JAX package's native library is not built")
    for backend in (config.RngBackend.NATIVE, REF):
        cfg = _cfg(dataset, rng_backend=backend, theta_init="libstdc++")
        jstate = jax_learner.init_state(jax_config(cfg), 5)
        state = learner.init_state(cfg, 5, "cpu")
        np.testing.assert_array_equal(state.theta.numpy(),
                                      np.asarray(jstate.theta))
        np.testing.assert_array_equal(state.beta.numpy(),
                                      np.asarray(jstate.beta))


@pytest.mark.parametrize("flags", [
    ["--rng", "reference"],
    ["--rng", "reference", "--no-ref-rng-block", "--theta-init",
     "libstdc++"],
    ["--rng", "reference", "--phi-impl", "pallas", "--steps-per-call", "1"],
    ["--rng", "reference", "-s", "BFLink", "--device-sampling"],
])
def test_cli_reference_rng(flags, caplog):
    """The CLI's --rng reference runs (host-sampled by the JAX CLI's rule,
    or device-sampled when asked), names the RNG version in the log and
    gives a finite, falling ppx series."""
    import logging
    import re

    if "libstdc++" in flags:
        require_native()
    args = ["--synthetic", "300,8", "-k", "8", "-m", "8", "-n", "8", "-x",
            "60", "-i", "20", "--device", "cpu"] + flags
    with caplog.at_level(logging.INFO, logger="mcmc_ammsb_tpu_torch"):
        assert cli.main(args) == 0
    msgs = [r.getMessage() for r in caplog.records]
    ppx = {int(m.group(1)): float(m.group(2)) for m in
           (re.fullmatch(r"ppx\[(\d+)\] = (\S+)", x) for x in msgs) if m}
    assert sorted(ppx) == [0, 20, 40, 60] and ppx[60] < ppx[0]
    block = "--no-ref-rng-block" not in flags
    assert any(x.startswith("reference RNG: the plain PyTorch version") and
               ("--no-ref-rng-block" in x) != block for x in msgs)


@pytest.mark.cuda
def test_kernel_matches_plain_on_gpu():
    """On a GPU: the three entries of csrc/ref_rng_kernel.cu against the
    plain version on the same CUDA seeds, bit for bit (values and
    seeds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev = "cuda"
    g = torch.Generator().manual_seed(0)
    mask = (torch.rand(20, 64, generator=g) < 0.6).to(dev)
    nodes = torch.randint(0, 5000, (20, 64), generator=g,
                          dtype=torch.int32).to(dev)
    seeds = T.make_seeds((42, 43), 64, dev)
    for got, want in [
            (refblock.randn_lanes(seeds, 256, mask),
             T.randn_lanes(seeds, 256, mask)),
            (refblock.neighbors_lanes(seeds, nodes, mask, 5000, 32),
             T.neighbors_lanes(seeds, nodes, mask, 5000, 32)),
            (refblock.gamma_lanes(seeds, 1.0, 1.0, mask),
             T.gamma_lanes(seeds, 1.0, 1.0, mask))]:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
