"""The port's pi init drawn on the device in blocks (learner.gamma_rows,
the counterpart of the JAX package's chunked_pi_rows): deterministic per
seed, the Gamma(eta0, eta1) law by its moments, the same rows for every
engine (a chain of the flat chain engine, a rank's shard, the MMSB
learner), bf16 as the float32 init rounded, and theta still the host
stream's. On the CPU the draws come from the CPU generator."""

import numpy as np
import pytest
import torch

from mcmc_ammsb_tpu_torch import chains_flat, learner, rng
from mcmc_ammsb_tpu_torch.config import Config
from mcmc_ammsb_tpu_torch.models import mmsb
from mcmc_ammsb_tpu_torch.parallel import sharded

N, K = 211, 12
#: rows per block in the tests that patch the block size: 5 blocks, the
#: last ragged, so rank boundaries fall inside blocks
BLOCK = 47


def _cfg(**kw):
    return Config(K=K, mini_batch_size=8, num_node_sample=8, **kw).finalize(
        N, 900, 20)


@pytest.fixture
def small_blocks(monkeypatch):
    monkeypatch.setattr(learner, "pi_block_rows", lambda k: BLOCK)


def test_block_rows_is_jax_rule():
    """2^24 values a block, at least one row (chunked_pi_rows)."""
    assert learner.pi_block_rows(4096) == 4096
    assert learner.pi_block_rows(1024) == 16384
    assert learner.pi_block_rows(1 << 25) == 1


def test_init_is_deterministic_per_seed(small_blocks):
    """The same seed gives the same pi bit for bit; seeds that differ
    (also by 2, which a seed kept to its low 32 bits would merge) give
    other rows; blocks differ from each other."""
    a = learner.gamma_rows(_cfg(), "cpu")
    b = learner.gamma_rows(_cfg(), "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for other in (1, 2, 1 << 32):
        c = learner.gamma_rows(_cfg(init_seed=_cfg().init_seed + other),
                               "cpu")
        assert not torch.allclose(a[0], c[0])
    assert not torch.allclose(a[0][:BLOCK], a[0][BLOCK:2 * BLOCK])
    seeds = {rng.block_seed(s, i) & 0xFFFFFFFF
             for s in range(100, 108) for i in range(8)}
    assert len(seeds) == 64


@pytest.mark.parametrize("eta0,eta1", [(1.0, 1.0), (2.5, 0.4), (0.3, 3.0)])
def test_block_moments_match_gamma(eta0, eta1):
    """One block's draws: the sample mean and variance within 5 standard
    errors of Gamma(eta0, eta1)'s (shape eta0, scale eta1: mean
    eta0 eta1, variance eta0 eta1^2, fourth central moment 3 eta0 (eta0 +
    2) eta1^4)."""
    cfg = _cfg(eta0=eta0, eta1=eta1)
    g = learner.pi_gamma_block(cfg, 3, 20_000, "cpu").double().ravel()
    n = g.numel()
    mean, var = eta0 * eta1, eta0 * eta1 ** 2
    mu4 = 3 * eta0 * (eta0 + 2) * eta1 ** 4
    assert abs(float(g.mean()) - mean) < 5 * (var / n) ** 0.5
    assert abs(float(g.var()) - var) < 5 * ((mu4 - var ** 2) / n) ** 0.5
    assert float(g.min()) > 0.0


def test_rows_are_normalized_blocks(small_blocks):
    """pi is each block's draws over their row sums, phi_sum the sums."""
    cfg = _cfg()
    pi, phi_sum = learner.gamma_rows(cfg, "cpu")
    for i, start in enumerate(range(0, N, BLOCK)):
        g = learner.pi_gamma_block(cfg, i, min(BLOCK, N - start), "cpu")
        s = g.sum(-1)
        assert torch.equal(pi[start:start + BLOCK], g / s[:, None])
        assert torch.equal(phi_sum[start:start + BLOCK], s)


def test_bf16_is_float32_init_rounded(small_blocks):
    """bf16 pi is the float32 init rounded to nearest-even, bit for bit,
    over several blocks; phi_sum and theta are the float32 init's."""
    a = learner.init_state(_cfg(pi_dtype="bfloat16"), 5, "cpu")
    b = learner.init_state(_cfg(), 5, "cpu")
    assert a.pi.dtype == torch.bfloat16
    assert torch.equal(a.pi, b.pi.to(torch.bfloat16))
    assert torch.equal(a.phi_sum, b.phi_sum)
    assert torch.equal(a.theta, b.theta)


def test_theta_keeps_the_host_stream():
    """theta is still the first 2K draws of the host stream."""
    cfg = _cfg()
    st = learner.init_state(cfg, 5, "cpu")
    want = rng.host_gamma_rng(cfg).standard_gamma(
        cfg.eta0, (K, 2), dtype=np.float32) * np.float32(cfg.eta1)
    assert torch.equal(st.theta, torch.from_numpy(want))


def test_chain_c_is_learner_with_seed_plus_c(small_blocks):
    """Chain c of the flat chain engine is init_state at init_seed + c:
    pi, phi_sum and theta bit for bit."""
    cfg = _cfg()
    st = chains_flat.init_chain_state(cfg, 3, 5, "cpu")
    for c in range(3):
        one = learner.init_state(cfg.replace(init_seed=cfg.init_seed + c), 5,
                                 "cpu")
        assert torch.equal(st.pi[c * N:(c + 1) * N], one.pi)
        assert torch.equal(st.phi_sum[c * N:(c + 1) * N], one.phi_sum)
        assert torch.equal(st.theta[c], one.theta)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rank_shards_are_single_gpu_rows(small_blocks, dtype):
    """Two ranks' init_local_state (rows [0, 106) and [106, 212), the
    last padded past N) hold exactly the single learner's rows, each
    drawing only the blocks that overlap its rows; padded rows are 1/K
    with phi_sum 1."""
    cfg = _cfg(pi_dtype=dtype)
    one = learner.init_state(cfg, 5, "cpu")
    drawn = []
    real = learner.pi_gamma_block

    def spy(cfg_, i, rows, device):
        drawn[-1].append(i)
        return real(cfg_, i, rows, device)

    learner.pi_gamma_block = spy
    try:
        shards = []
        for lo, hi in ((0, 106), (106, 212)):
            drawn.append([])
            shards.append(sharded.init_local_state(cfg, lo, hi, 212, 5, 0,
                                                   "cpu"))
    finally:
        learner.pi_gamma_block = real
    assert drawn == [[0, 1, 2], [2, 3, 4]]
    pi = torch.cat([s.pi for s in shards])
    phi_sum = torch.cat([s.phi_sum for s in shards])
    assert torch.equal(pi[:N], one.pi) and torch.equal(phi_sum[:N],
                                                       one.phi_sum)
    assert torch.equal(pi[N:].float(), torch.full((1, K), 1.0 / K)
                       .to(pi.dtype).float())
    assert torch.equal(phi_sum[N:], torch.ones(1))
    assert all(torch.equal(s.theta, one.theta) for s in shards)


def test_mmsb_pi_is_the_same_law(small_blocks):
    """The full MMSB's pi rows are learner.gamma_rows's."""
    cfg = _cfg()
    st = mmsb.init_mmsb_state(cfg, 5, "cpu")
    pi, phi_sum = learner.gamma_rows(cfg, "cpu")
    assert torch.equal(st.pi, pi) and torch.equal(st.phi_sum, phi_sum)


@pytest.mark.cuda
def test_card_init_differs_from_cpu_init():
    """On the card the blocks come from the card's generator: the same
    law and seed, other numbers than the CPU's, still deterministic."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    cfg = _cfg()
    a = learner.gamma_rows(cfg, "cuda")
    b = learner.gamma_rows(cfg, "cuda")
    c = learner.gamma_rows(cfg, "cpu")
    assert torch.equal(a[0], b[0])
    assert not torch.allclose(a[0].cpu(), c[0])
