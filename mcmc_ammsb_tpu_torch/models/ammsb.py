"""The assortative Mixed-Membership Stochastic Blockmodel as a
model-family object (counterpart of ``mcmc_ammsb_tpu/models/ammsb.py``).

    beta_k ~ Beta(eta0, eta1)                    community link strength
    pi_a   ~ Dirichlet(alpha * 1_K)              node memberships
    for each node pair (a, b):
        z_ab ~ Categorical(pi_a), z_ba ~ Categorical(pi_b)
        y_ab ~ Bernoulli(beta_k)   if z_ab = z_ba = k
        y_ab ~ Bernoulli(epsilon)  otherwise

``AMMSB`` owns the static model data (config, edge sets, the held-out
population) on one device and exposes the functional surface (init /
step / steps / eval) that the orchestrators drive. The JAX package's
state carries its RNG keys; here the random streams are stateful
generators, so ``step`` and ``steps`` take the ``rng.Streams`` they draw
from, and the device is explicit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mcmc_ammsb_tpu_torch import rng
from mcmc_ammsb_tpu_torch.config import Config
from mcmc_ammsb_tpu_torch.data import DataSplit, Graph
from mcmc_ammsb_tpu_torch.learner import (DeviceBatch, TrainState,
                                          heldout_perplexity_step, init_state,
                                          resolve_device, step_operands,
                                          train_step, train_steps_scan)
from mcmc_ammsb_tpu_torch.ops import perplexity as ppx_ops
from mcmc_ammsb_tpu_torch.ops.edgeset import EdgeSet, build_edge_set


class AMMSB:
    """Model-family object: static data + the functional surface."""

    def __init__(self, cfg: Config, graph: Graph, split: DataSplit,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.graph = graph
        self.split = split
        self.training_set: EdgeSet = build_edge_set(
            cfg.edgeset_backend, cfg.N, graph.edges_u, graph.edges_v,
            self.device)
        self.heldout_set: EdgeSet = build_edge_set(
            cfg.edgeset_backend, cfg.N, split.heldout_u, split.heldout_v,
            self.device)
        self.heldout_u = torch.as_tensor(split.heldout_edges_u,
                                         device=self.device)
        self.heldout_v = torch.as_tensor(split.heldout_edges_v,
                                         device=self.device)

    def streams(self) -> rng.Streams:
        """Fresh random streams from the config's seeds, on the device."""
        return rng.make_streams(self.cfg, self.device)

    def init(self) -> TrainState:
        """Draw the initial posterior sample."""
        return init_state(self.cfg, len(self.split.heldout_edges_u),
                          self.device)

    def step(self, state: TrainState, batch: DeviceBatch,
             streams: rng.Streams) -> TrainState:
        """One SGRLD transition on one minibatch; its neighbor draws and
        noise come from ``streams`` (with the reference RNG, from the
        state's streams). Updates ``state.pi`` in place."""
        ops, state = step_operands(self.cfg, streams, state, batch)
        return train_step(self.cfg, self.training_set, state, batch, *ops)

    def steps(self, state: TrainState, batches: DeviceBatch,
              streams: rng.Streams) -> TrainState:
        """The transitions of S stacked pre-sampled minibatches, hoisted
        (windowed when ``cfg.window > 1``)."""
        return train_steps_scan(self.cfg, self.training_set, state, batches,
                                streams)

    def eval(self, state: TrainState
             ) -> Tuple[TrainState, ppx_ops.PpxResult]:
        """Held-out perplexity evaluation (running-average semantics)."""
        return heldout_perplexity_step(self.cfg, self.heldout_set,
                                       self.heldout_u, self.heldout_v, state)
