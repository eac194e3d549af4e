"""Between-chain convergence statistics (counterpart of the numpy part of
``mcmc_ammsb_tpu/chains.py``): the Gelman-Rubin R-hat, which one chain
cannot give. The vmap chain engine of that module is not ported
(ROADMAP queue 1 item 12); ``chains_flat.FlatChainLearner`` is the
port's chain engine."""

from __future__ import annotations

import numpy as np


def rhat(samples: np.ndarray) -> np.ndarray:
    """Gelman-Rubin potential scale reduction factor.

    samples: [C, T, ...] — C chains, T kept draws per chain. Values
    near 1 indicate between-chain agreement. Computed elementwise over
    trailing dims.
    """
    c, t = samples.shape[:2]
    assert c >= 2 and t >= 2, (c, t)
    chain_means = samples.mean(axis=1)                    # [C, ...]
    chain_vars = samples.var(axis=1, ddof=1)              # [C, ...]
    w = chain_vars.mean(axis=0)                           # within
    b = t * chain_means.var(axis=0, ddof=1)               # between
    var_plus = (t - 1) / t * w + b / t
    return np.sqrt(var_plus / np.maximum(w, 1e-30))


def beta_rhat_series(engine, draws: int = 10) -> np.ndarray:
    """R-hat over beta across a chain engine exposing ``run``, ``cfg``
    and ``state.beta [C, K]``: runs ``draws`` chunks of steps_per_call
    steps keeping beta after each, returns the per-community PSRF [K]."""
    assert draws >= 2, draws
    kept = []
    for _ in range(draws):
        engine.run(max(1, engine.cfg.steps_per_call))
        kept.append(engine.state.beta.cpu().numpy())      # [C, K]
    return rhat(np.stack(kept, axis=1))                   # [C, T, K]
