"""Native RNG streams for the port (counterpart of
``mcmc_ammsb_tpu/rng/native.py``).

The JAX package derives one threefry key per purpose and folds the step
counter into it. Here each purpose owns one ``torch.Generator`` on the
compute device (Philox on CUDA), seeded from the same ``Config`` seed
pairs. The two packages therefore draw different numbers from the same
seeds: the tests hand both the same numpy-made operands instead.

theta's init draws come from a seeded numpy ``Generator`` on the host
(``host_gamma_rng``); pi's are drawn on the compute device in blocks, each
by a generator of that device (``learner.pi_gamma_block``), so they depend
on the device's kind.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mcmc_ammsb_tpu_torch.config import Config


def seed_from_pair(seed_pair) -> int:
    """One 62-bit seed from the reference's (x, y) ulong2 pair."""
    x, y = seed_pair
    return ((int(x) & 0x7FFFFFFF) << 31) | (int(y) & 0x7FFFFFFF)


def block_seed(seed: int, i: int) -> int:
    """A 63-bit seed for block ``i`` of the stream seeded ``seed``: the
    splitmix64 finalizer of ``seed + (i + 1) * golden``, so distinct
    pairs differ in the low 32 bits too (all that a CPU generator's
    mt19937 keeps of its seed)."""
    m = (1 << 64) - 1
    z = (seed + (i + 1) * 0x9E3779B97F4A7C15) & m
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & m
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m
    return (z ^ (z >> 31)) >> 1


def generator(seed_pair, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed_from_pair(seed_pair))
    return g


class Streams(NamedTuple):
    """One generator per random purpose of the training loop."""

    phi: torch.Generator        # phi noise [S, B, K]
    beta: torch.Generator       # theta noise [S, K, 2]
    neighbor: torch.Generator   # shared neighbor draws
    sample: torch.Generator     # device minibatch sampling


def make_streams(cfg: Config, device) -> Streams:
    return Streams(
        phi=generator(cfg.phi_seed, device),
        beta=generator(cfg.beta_seed, device),
        neighbor=generator(cfg.neighbor_seed, device),
        sample=generator((cfg.sample_seed, 0x5A), device),
    )


def randn(gen: torch.Generator, shape, device,
          dtype=torch.float32) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device, dtype=dtype)


def randint(gen: torch.Generator, high: int, shape,
            device) -> torch.Tensor:
    """Uniform int32 draws in [0, high)."""
    return torch.randint(0, high, shape, generator=gen, device=device,
                         dtype=torch.int32)


def host_gamma_rng(cfg: Config) -> np.random.Generator:
    """theta's init stream: its Gamma(eta0, eta1) draws (and the MMSB's
    theta_b)."""
    return np.random.default_rng(cfg.init_seed)
