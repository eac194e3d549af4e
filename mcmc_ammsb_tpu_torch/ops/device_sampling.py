"""On-device minibatch sampling, Node family (counterpart of
``mcmc_ammsb_tpu/ops/device_sampling.py``).

  NodeLink    — one random non-isolated node, all of its training
                edges, weight N (degree-capped with a Horvitz-Thompson
                reweight under ``ds_link_cap``)
  NodeNonLink — m distinct non-links at one random node, excluding
                training and held-out edges, weight 2E/m_eff
  Node        — a fair coin per step between the two ("random"), or
                strict alternation ("alternate")

Everything is batched over the step axis with a fixed number of masked
redraw rounds, as in the JAX package. The breadth-first family is not
ported yet (ROADMAP queue 1 item 9).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mcmc_ammsb_tpu_torch import rng
from mcmc_ammsb_tpu_torch.config import Config, SampleStrategy
from mcmc_ammsb_tpu_torch.ops.edgeset import EdgeSet


class DeviceSamples(NamedTuple):
    """A stacked batch of S device-sampled minibatches."""

    edges_u: torch.Tensor    # [S, E_cap] int32
    edges_v: torch.Tensor
    edge_mask: torch.Tensor  # [S, E_cap] bool
    nodes: torch.Tensor      # [S, B_cap] int32 (deduped; padded with N)
    node_mask: torch.Tensor  # [S, B_cap] bool
    weight: torch.Tensor     # [S] f32


class Adjacency(NamedTuple):
    """Training CSR (offsets [N+1], cols [2E]) on the device."""

    offsets: torch.Tensor
    cols: torch.Tensor

    def degree(self, u: torch.Tensor) -> torch.Tensor:
        u = u.long()
        return (self.offsets[u + 1] - self.offsets[u]).to(torch.int32)

    def row_gather(self, u: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
        idx = self.offsets[u.long()][..., None] + off
        return self.cols[idx.clamp(0, self.cols.shape[0] - 1)]


def _pad_last(x: torch.Tensor, pad: int, value) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, pad), value=value)


def _structural_nodes(cfg: Config, eu, ev, mask, pivot):
    """Deduped node list of a Node-family draw without sorting: lane 0 =
    pivot, lane 1+i = edge lane i's other endpoint; masked lanes hold
    the sentinel N."""
    partners = eu + ev - pivot[..., None]
    nodes = torch.cat([pivot[..., None], partners], dim=-1)
    nmask = torch.cat([torch.ones_like(mask[..., :1]), mask], dim=-1)
    nodes = torch.where(nmask, nodes, torch.full_like(nodes, cfg.N))
    b_cap = cfg.max_batch_nodes
    if nodes.shape[-1] < b_cap:
        pad = b_cap - nodes.shape[-1]
        nodes = _pad_last(nodes, pad, cfg.N)
        nmask = _pad_last(nmask, pad, False)
    else:
        nodes = nodes[..., :b_cap]
        nmask = nmask[..., :b_cap]
    return nodes, nmask


def _sample_node_link_batch(cfg: Config, adj: Adjacency,
                            gen: torch.Generator, s_len: int,
                            rounds: int | None = None):
    """[S] NodeLink draws: random non-isolated pivots (masked redraw
    rounds) + their CSR rows; with ``ds_link_cap`` hub rows are
    subsampled with replacement, keep-first deduped and reweighted by
    N / (1 - (1 - 1/d)^e_cap)."""
    if rounds is None:
        rounds = cfg.ds_link_rounds
    dev = adj.cols.device
    e_cap = cfg.max_batch_edges
    u = rng.randint(gen, cfg.N, (s_len,), dev)
    for _ in range(rounds):
        redraw = rng.randint(gen, cfg.N, (s_len,), dev)
        u = torch.where(adj.degree(u) == 0, redraw, u)
    deg = adj.degree(u)                                       # [S]
    lane = torch.arange(e_cap, dtype=torch.int32, device=dev)
    in_row = lane.expand(s_len, e_cap)
    valid = lane < deg[:, None]
    weight = torch.full((s_len,), float(cfg.N), dtype=torch.float32,
                        device=dev)
    if cfg.ds_link_cap and cfg.max_fan_out > e_cap:
        take_all = deg <= e_cap
        degf = deg.float().clamp(min=1.0)
        uni = torch.rand((s_len, e_cap), generator=gen, device=dev)
        off = torch.floor(uni * degf[:, None]).to(torch.int32)
        off = torch.minimum(off, deg[:, None] - 1)
        earlier = torch.ones(e_cap, e_cap, dtype=torch.bool,
                             device=dev).tril(-1)
        dup = torch.any((off[:, :, None] == off[:, None, :]) & earlier,
                        dim=-1)
        in_row = torch.where(take_all[:, None], in_row, off)
        valid = torch.where(take_all[:, None], valid,
                            (deg[:, None] > 0) & ~dup)
        p_inc = 1.0 - (1.0 - 1.0 / degf) ** e_cap
        weight = torch.where(take_all, weight,
                             cfg.N / p_inc.clamp(min=1e-30))
    v = adj.row_gather(u, in_row)
    eu = torch.minimum(u[:, None], v)
    ev = torch.maximum(u[:, None], v)
    return eu, ev, valid, weight, u


def _sample_node_non_link_batch(cfg: Config, training_set: EdgeSet,
                                heldout_set: EdgeSet,
                                gen: torch.Generator, s_len: int,
                                rounds: int | None = None):
    """[S] NodeNonLink draws; residual bad lanes after the redraw rounds
    are masked and the 2E/m_eff weight keeps the estimator unbiased
    (weight * m_eff == 2E exactly)."""
    if rounds is None:
        rounds = cfg.ds_nonlink_rounds
    dev = training_set.device
    m = cfg.mini_batch_size
    e_cap = cfg.max_batch_edges
    u = rng.randint(gen, cfg.N, (s_len,), dev)
    v = rng.randint(gen, cfg.N, (s_len, m), dev)
    earlier = torch.ones(m, m, dtype=torch.bool, device=dev).tril(-1)

    def bad_lanes(v):
        a = torch.minimum(u[:, None], v)
        b = torch.maximum(u[:, None], v)
        hit = training_set.has_edges(a, b) | heldout_set.has_edges(a, b)
        dup = torch.any((v[:, :, None] == v[:, None, :]) & earlier, dim=-1)
        return (v == u[:, None]) | hit | dup

    for _ in range(rounds):
        redraw = rng.randint(gen, cfg.N, (s_len, m), dev)
        v = torch.where(bad_lanes(v), redraw, v)
    ok = ~bad_lanes(v)
    eu = torch.minimum(u[:, None], v)
    ev = torch.maximum(u[:, None], v)
    pad = e_cap - m
    if pad:
        eu = _pad_last(eu, pad, 0)
        ev = _pad_last(ev, pad, 0)
        ok = _pad_last(ok, pad, False)
    m_eff = ok.sum(-1).float()
    weight = 2.0 * cfg.E / m_eff.clamp(min=1.0)
    return eu, ev, ok, weight, u


def _interleave_steps(link, non, n_link: int, n_non: int, period: int):
    """Merge two per-step draw blocks so steps 0,2,4,... take the
    ``link`` rows and 1,3,5,... the ``non`` rows (``period`` draws per
    step)."""
    def mix(a, b):
        tail = a.shape[1:]
        a2 = a.reshape(n_link, period, *tail)
        b2 = b.reshape(n_non, period, *tail)
        out = torch.stack([a2[:n_non], b2], dim=1).reshape(
            2 * n_non * period, *tail)
        if n_link > n_non:     # odd step count: trailing link step
            out = torch.cat([out, a2[n_non:].reshape(period, *tail)])
        return out

    return tuple(mix(a, b) for a, b in zip(link, non))


def sample_minibatches_device(cfg: Config, training_set: EdgeSet,
                              heldout_set: EdgeSet, gen: torch.Generator,
                              s_len: int, adjacency: Adjacency,
                              alt_period: int = 1) -> DeviceSamples:
    """Draw ``s_len`` Node-family minibatches (one per step) in one
    block. ``adjacency`` is the training CSR on the device."""
    if cfg.strategy not in (SampleStrategy.NODE, SampleStrategy.NODE_LINK,
                            SampleStrategy.NODE_NON_LINK):
        raise NotImplementedError(
            f"device sampling strategy {cfg.strategy.value!r} is not "
            "ported yet (ROADMAP queue 1 item 9: device BF family)")
    if (cfg.strategy != SampleStrategy.NODE_NON_LINK
            and not cfg.ds_link_cap
            and cfg.max_batch_edges < cfg.max_fan_out):
        raise ValueError(
            f"batch edge capacity {cfg.max_batch_edges} cannot hold the "
            f"max fan-out {cfg.max_fan_out}; NodeLink batches would be "
            "silently truncated")

    if cfg.strategy == SampleStrategy.NODE_LINK:
        eu, ev, mask, weight, pivot = _sample_node_link_batch(
            cfg, adjacency, gen, s_len)
    elif cfg.strategy == SampleStrategy.NODE_NON_LINK:
        eu, ev, mask, weight, pivot = _sample_node_non_link_batch(
            cfg, training_set, heldout_set, gen, s_len)
    elif cfg.node_coin == "alternate":
        if s_len % alt_period:
            raise ValueError(f"s_len={s_len} must be a multiple of "
                             f"alt_period={alt_period}")
        n_steps = s_len // alt_period
        n_link, n_non = (n_steps + 1) // 2, n_steps // 2
        link = _sample_node_link_batch(cfg, adjacency, gen,
                                       n_link * alt_period)
        if n_non == 0:
            eu, ev, mask, weight, pivot = link
        else:
            non = _sample_node_non_link_batch(
                cfg, training_set, heldout_set, gen, n_non * alt_period)
            eu, ev, mask, weight, pivot = _interleave_steps(
                link, non, n_link, n_non, alt_period)
    else:
        # per-step fair coin: both vectorized draws, then a row select
        link = _sample_node_link_batch(cfg, adjacency, gen, s_len)
        non = _sample_node_non_link_batch(cfg, training_set, heldout_set,
                                          gen, s_len)
        coin = torch.rand((s_len,), generator=gen,
                          device=adjacency.cols.device) < 0.5
        eu, ev, mask, weight, pivot = (
            torch.where(coin.view(-1, *([1] * (a.dim() - 1))), a, b)
            for a, b in zip(link, non))
    nodes, node_mask = _structural_nodes(cfg, eu, ev, mask, pivot)
    return DeviceSamples(eu, ev, mask, nodes, node_mask, weight)
