"""Native RNG streams for the port (counterpart of
``mcmc_ammsb_tpu/rng/native.py``).

The JAX package derives one threefry key per purpose and folds the step
counter into it. Here each purpose owns one ``torch.Generator`` on the
compute device (Philox on CUDA), seeded from the same ``Config`` seed
pairs (``stream_seed``). The two packages therefore draw different
numbers from the same seeds: the tests hand both the same numpy-made
operands instead.

A CUDA generator (Philox) takes the pair's 62-bit seed whole. A CPU
generator is an mt19937 that keeps only the low 32 bits of its seed, so
it takes the low 32 bits of a splitmix64 fold of all 62: the plain
``(x << 31) | y`` would keep only x's lowest bit, and chains whose
sample seeds differ by 2 would draw one stream. A run restored from a
checkpoint whose generator states cannot be set here (another device
kind, or the JAX package's keys) re-seeds its streams with the restored
step folded in (``seed_streams``), so it does not replay step 1's draws.

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


def stream_seed(seed_pair, device, step: int = 0) -> int:
    """The seed of a generator of ``device``'s kind for the stream of
    ``seed_pair`` (module docstring): ``seed_from_pair`` on CUDA, a 32-bit
    fold of it on the CPU; a ``step`` past 0 (a re-seeded restore) is
    folded in first on either kind."""
    seed = seed_from_pair(seed_pair)
    if step:
        seed = block_seed(seed, step)
    if torch.device(device).type != "cuda":
        seed = block_seed(seed, -1) & 0xFFFFFFFF
    return seed


def generator(seed_pair, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed_pair, device))
    return g


class Streams(NamedTuple):
    """One generator per random purpose of the training loop."""

    phi: torch.Generator        # phi noise [S, B, K]
    beta: torch.Generator       # theta noise [S, K, 2]
    neighbor: torch.Generator   # shared neighbor draws
    sample: torch.Generator     # device minibatch sampling


def stream_pairs(cfg: Config) -> Streams:
    """The seed pair of each stream of ``make_streams``."""
    return Streams(phi=tuple(cfg.phi_seed), beta=tuple(cfg.beta_seed),
                   neighbor=tuple(cfg.neighbor_seed),
                   sample=(cfg.sample_seed, 0x5A))


def make_streams(cfg: Config, device) -> Streams:
    return Streams(*(generator(p, device) for p in stream_pairs(cfg)))


def seed_streams(gens, pairs, step: int) -> None:
    """Seed the generators ``gens`` in place from their seed ``pairs``
    with ``step`` folded in (``stream_seed``): the streams of a restore
    whose generator states do not fit them."""
    for g, pair in zip(gens, pairs):
        g.manual_seed(stream_seed(pair, g.device, step))


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
