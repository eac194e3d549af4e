"""Driver entry point of the port (counterpart of ``__graft_entry__.entry``):
one single-chip a-MMSB SGRLD train step and its example arguments, on the
JAX entry's tiny problem (N = 256 synthetic, K = 16, m = n = 8), built
from the port's own ``data`` and ``config``.

The multi-chip twin of ``__graft_entry__.dryrun_multichip`` is
``parallel/dryrun.py``.
"""

from __future__ import annotations

from mcmc_ammsb_tpu_torch import rng
from mcmc_ammsb_tpu_torch.config import Config
from mcmc_ammsb_tpu_torch.data import Graph, generate_sets, synthetic_edges
from mcmc_ammsb_tpu_torch.learner import (DeviceBatch, init_state,
                                          resolve_device, step_operands,
                                          train_step)
from mcmc_ammsb_tpu_torch.ops.edgeset import build_edge_set
from mcmc_ammsb_tpu_torch.sampling import MiniBatchSampler


def tiny_problem(seed: int = 0):
    """(cfg, graph, split) of the JAX entry's ``_tiny_problem``: the same
    arrays, from the port's copies of its data functions."""
    n, u, v = synthetic_edges(num_nodes=256, avg_degree=8, seed=seed)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=seed + 1)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = Config(K=16, mini_batch_size=8, num_node_sample=8)
    return cfg.finalize(n, split.total_edges, graph.max_fan_out), graph, split


def entry(device=None):
    """Returns ``(fn, example_args)``: ``fn(edge_set, state, batch)`` is
    one SGRLD train step of the a-MMSB (``learner.train_step``, its
    neighbors and noise drawn from the port's streams for the step), and
    ``example_args`` the training edge set, the initial state and one
    host-sampled minibatch on ``device`` (the card unless the caller asks
    for the CPU)."""
    device = resolve_device(device or "cuda")
    cfg, graph, split = tiny_problem()
    edge_set = build_edge_set(cfg.edgeset_backend, cfg.N, graph.edges_u,
                              graph.edges_v, device)
    state = init_state(cfg, len(split.heldout_edges_u), device)
    batch = DeviceBatch.from_host(
        MiniBatchSampler(cfg, graph, split).sample(), device)
    streams = rng.make_streams(cfg, device)

    def fn(edge_set, state, batch):
        ops, state = step_operands(cfg, streams, state, batch)
        return train_step(cfg, edge_set, state, batch, *ops)

    return fn, (edge_set, state, batch)
