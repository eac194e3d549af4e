"""Between-chain convergence statistics and the independent-states chain
engine (counterpart of ``mcmc_ammsb_tpu/chains.py``).

``rhat`` is the Gelman-Rubin statistic, which one chain cannot give.
``MultiChainLearner`` (``--chain-engine vmap``) keeps C whole
``TrainState``s and C sets of random streams and advances them one after
the other, each through the single-chain device-sampled loop: the JAX
package vmaps that loop over a chain axis and says of the result
"measured slower; kept for cross-checks". In-place scatters and stateful
generators do not go through ``torch.func.vmap``, and a cross-check wants
the single-chain code itself, so the port loops over the chains in
Python. ``chains_flat.FlatChainLearner`` is the fast chain engine.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from mcmc_ammsb_tpu_torch import learner as lrn
from mcmc_ammsb_tpu_torch import rng
from mcmc_ammsb_tpu_torch.config import Config


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


def chain_config(cfg: Config, c: int) -> Config:
    """The single-chain config of chain ``c``: ``init_seed + c`` and the
    chain index folded into every stream's seed pair (chain 0 is ``cfg``
    itself). A ``Learner`` built from it runs chain c's trajectory."""
    def fold(pair):
        return (int(pair[0]), int(pair[1]) + c)

    return cfg.replace(init_seed=cfg.init_seed + c,
                       phi_seed=fold(cfg.phi_seed),
                       beta_seed=fold(cfg.beta_seed),
                       neighbor_seed=fold(cfg.neighbor_seed),
                       sample_seed=cfg.sample_seed + c)


class MultiChainLearner:
    """C independent single-chain samplers over one graph, advanced one
    after the other (module docstring). The chains' states are
    ``states``, a list of C ``learner.TrainState`` (the JAX class keeps a
    stacked ``states`` too); their streams are ``chain_streams``.
    ``step_count`` is the lockstep step counter. Perplexity is a [C]
    array. Device sampling is forced on; it has no ``run_with_ppx`` (the
    CLI evaluates between chunks) and no windows.
    """

    keeps_train_ppx = False    # never evaluated here, as in the JAX class

    def __init__(self, cfg: Config, graph, split, num_chains: int,
                 device="cuda"):
        if num_chains < 1:
            raise ValueError(f"num_chains must be >= 1, got {num_chains}")
        if len(split.heldout_edges_u) == 0:
            raise ValueError("no held-out edges: heldout_ratio too small "
                             "for this graph")
        if cfg.pi_dtype != "float32":
            raise ValueError(
                "the vmap chain engine keeps pi in fp32 (it is the slow "
                "golden cross-check); use the flat/sharded chain engines "
                "for pi_dtype=bfloat16")
        cfg = cfg.replace(device_sampling=True)
        lrn.check_learner_config(cfg)
        self.device = lrn.resolve_device(device)
        self.cfg = cfg
        self.num_chains = num_chains
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        # the data-dependent structures are the single-chain learner's
        lrn.Learner._build_graph_structures(self, graph, split)
        h = len(split.heldout_edges_u)
        self.states: List = []
        self.chain_streams: List[rng.Streams] = []
        for c in range(num_chains):
            cfg_c = chain_config(cfg, c)
            self.states.append(lrn.init_state(cfg_c, h, self.device))
            self.chain_streams.append(rng.make_streams(cfg_c, self.device))
        self.sampler = None            # no host sampling on this engine

    @property
    def step_count(self) -> int:
        """The 1-based number of the next step (the chains advance in
        lockstep)."""
        return self.states[0].step_count

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, max_iters: int) -> None:
        """``max_iters`` steps of every chain, chunk by chunk, the chains
        one after the other within a chunk."""
        spc = max(1, self.cfg.steps_per_call)
        with self.timers.stage("total"):
            done = 0
            while done < max_iters:
                take = min(spc, max_iters - done)
                with self.timers.stage("device_step"):
                    for c in range(self.num_chains):
                        self.states[c] = lrn.train_steps_fused(
                            self.cfg, self.training_set, self.heldout_set,
                            self.states[c], take, self.adjacency,
                            self.chain_streams[c])
                done += take
            self._sync()

    def heldout_perplexity(self) -> np.ndarray:
        """Per-chain perplexities [C]."""
        with self.timers.stage("ppx"):
            negs = []
            for c in range(self.num_chains):
                self.states[c], res = lrn.heldout_perplexity_step(
                    self.cfg, self.heldout_set, self.heldout_u,
                    self.heldout_v, self.states[c])
                negs.append(res.neg_avg_log)
            return np.exp(torch.stack(negs).cpu().numpy())

    def beta_rhat(self, draws: int = 10) -> np.ndarray:
        """R-hat over beta across the chains: ``draws`` more chunks of
        steps_per_call steps, beta kept after each; the per-community
        PSRF [K]."""
        assert draws >= 2, draws
        kept = []
        for _ in range(draws):
            self.run(max(1, self.cfg.steps_per_call))
            kept.append(torch.stack([s.beta for s in self.states])
                        .cpu().numpy())                   # [C, K]
        return rhat(np.stack(kept, axis=1))               # [C, T, K]

    def print_stats(self, log=print) -> None:
        self.timers.print_table(log)

    def close(self) -> None:
        pass
