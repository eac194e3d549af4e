"""Held-out perplexity estimator (counterpart of
``mcmc_ammsb_tpu/ops/perplexity.py``):

  link edge:     L = sum_k pi_uk pi_vk beta_k
  non-link edge: L = sum_k pi_uk pi_vk (1 - beta_k)
                     + (1 - sum_k pi_uk pi_vk)(1 - eps)
  floored at 1e-30, folded into a per-edge running average across calls
  ppx_e <- (ppx_e (c - 1) + L) / c, c = call count;
  result = -mean_e log(ppx_e), which the caller exponentiates.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mcmc_ammsb_tpu_torch.config import Config
from mcmc_ammsb_tpu_torch.ops.edgeset import EdgeSet


class PpxResult(NamedTuple):
    ppx_per_edge: torch.Tensor   # [H] updated running averages
    neg_avg_log: torch.Tensor    # scalar; exp() of it is the perplexity
    link_likelihood: torch.Tensor
    non_link_likelihood: torch.Tensor
    link_count: torch.Tensor
    non_link_count: torch.Tensor


_EMPTY = "empty held-out population: heldout_ratio too small for this graph"

#: Bytes of one block's [rows, K] float32 temporary in the blocked
#: evaluations: the population's rows are gathered, upcast and reduced one
#: block at a time, so the transient memory is bounded whatever H x K is
#: (at N = 4M, K = 4096 one [H, K] float32 gather is ~5.6 GB).
EVAL_BLOCK_BYTES = 256 << 20


def eval_block_rows(k: int, lead: int = 1) -> int:
    """Population rows per block of the blocked evaluations: the rows
    whose [lead, rows, K] float32 temporary fits ``EVAL_BLOCK_BYTES``."""
    return max(1, EVAL_BLOCK_BYTES // (4 * max(k, 1) * max(lead, 1)))


def edge_likelihood(cfg: Config, pi_u: torch.Tensor, pi_v: torch.Tensor,
                    y: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Each pair's likelihood from its endpoint rows [..., K] (the link or
    non-link formula by ``y``), floored at 1e-30."""
    eps = cfg.epsilon
    pp = pi_u * pi_v
    pi_sum = torch.sum(pp, dim=-1)
    s_link = torch.sum(pp * beta, dim=-1)
    s_non = (torch.sum(pp * (1.0 - beta), dim=-1)
             + (1.0 - pi_sum) * (1.0 - eps))
    return torch.clamp(torch.where(y, s_link, s_non), min=1e-30)


def blocked_likelihood(cfg: Config, pi: torch.Tensor, beta: torch.Tensor,
                       edges_u: torch.Tensor, edges_v: torch.Tensor,
                       y: torch.Tensor, lead: int = 1) -> torch.Tensor:
    """``edge_likelihood`` of the pairs (edges_u, edges_v) over pi's rows
    in blocks of ``eval_block_rows``: [H], or [lead, H] where the rows of
    ``lead`` chains sit at offsets of N in pi (the chain engine's flat
    layout, ``beta`` [lead, 1, K], ``y`` [lead or 1, H]). Each pair's
    value comes from its own rows alone, as the unblocked gather gives
    it."""
    h = edges_u.shape[0]
    block = eval_block_rows(cfg.K, lead)
    offsets = (torch.arange(lead, device=edges_u.device) * cfg.N)[:, None]
    parts = []
    for a in range(0, h, block):
        u, v = edges_u[a:a + block].long(), edges_v[a:a + block].long()
        if lead == 1:
            rows_u, rows_v = pi[u], pi[v]
        else:
            rows_u = pi[(u[None, :] + offsets).reshape(-1)].reshape(
                lead, -1, cfg.K)
            rows_v = pi[(v[None, :] + offsets).reshape(-1)].reshape(
                lead, -1, cfg.K)
        parts.append(edge_likelihood(cfg, rows_u.to(beta.dtype),
                                     rows_v.to(beta.dtype),
                                     y[..., a:a + block], beta))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def perplexity_step(cfg: Config, pi: torch.Tensor, beta: torch.Tensor,
                    heldout_set: EdgeSet, edges_u: torch.Tensor,
                    edges_v: torch.Tensor, ppx_per_edge: torch.Tensor,
                    avg_count: int) -> PpxResult:
    """One evaluation over the population (edges_u, edges_v): the
    likelihoods in blocks of rows (``blocked_likelihood``), then the
    running averages and the sums of ``fold_likelihood`` over all of
    them."""
    if edges_u.shape[0] == 0:
        raise ValueError(_EMPTY)
    y = heldout_set.has_edges(edges_u, edges_v)
    lik = blocked_likelihood(cfg, pi, beta, edges_u, edges_v, y)
    return fold_likelihood(lik, y, torch.ones_like(y), ppx_per_edge,
                           avg_count)


def perplexity_core(cfg: Config, pi_u: torch.Tensor, pi_v: torch.Tensor,
                    y: torch.Tensor, mask: torch.Tensor,
                    beta: torch.Tensor, ppx_per_edge: torch.Tensor,
                    avg_count: int) -> PpxResult:
    """Likelihood math on gathered rows; masked lanes are excluded from
    every sum and keep their running average."""
    if pi_u.shape[-2] == 0:
        raise ValueError(_EMPTY)
    return fold_likelihood(edge_likelihood(cfg, pi_u, pi_v, y, beta), y,
                           mask, ppx_per_edge, avg_count)


def fold_likelihood(lik: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                    ppx_per_edge: torch.Tensor, avg_count: int) -> PpxResult:
    """Fold each pair's likelihood into its running average and sum the
    link and non-link log averages and counts over the unmasked pairs."""
    c = torch.tensor(float(avg_count), dtype=lik.dtype, device=lik.device)
    ppx_new = (ppx_per_edge * (c - 1.0) + lik) / c
    ppx_new = torch.where(mask, ppx_new, ppx_per_edge)
    # select, not a multiply: log of a zero padding lane is -inf
    lg = torch.where(mask, torch.log(torch.clamp(ppx_new, min=1e-30)),
                     torch.zeros_like(ppx_new))
    mf = mask.to(lik.dtype)
    yf = y.to(lik.dtype) * mf
    link_lik = torch.sum(lg * yf)
    non_link_lik = torch.sum(lg * (mf - yf))
    link_count = torch.sum(y & mask)
    non_link_count = torch.sum(mask) - link_count
    neg_avg = -(link_lik + non_link_lik) / (link_count
                                            + non_link_count).to(lik.dtype)
    return PpxResult(ppx_new, neg_avg, link_lik, non_link_lik,
                     link_count, non_link_count)
