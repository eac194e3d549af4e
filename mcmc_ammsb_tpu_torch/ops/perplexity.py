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


def perplexity_step(cfg: Config, pi: torch.Tensor, beta: torch.Tensor,
                    heldout_set: EdgeSet, edges_u: torch.Tensor,
                    edges_v: torch.Tensor, ppx_per_edge: torch.Tensor,
                    avg_count: int) -> PpxResult:
    y = heldout_set.has_edges(edges_u, edges_v)
    mask = torch.ones_like(y)
    return perplexity_core(cfg, pi[edges_u.long()].to(beta.dtype),
                           pi[edges_v.long()].to(beta.dtype), y, mask,
                           beta, ppx_per_edge, avg_count)


def perplexity_core(cfg: Config, pi_u: torch.Tensor, pi_v: torch.Tensor,
                    y: torch.Tensor, mask: torch.Tensor,
                    beta: torch.Tensor, ppx_per_edge: torch.Tensor,
                    avg_count: int) -> PpxResult:
    """Likelihood math on gathered rows; masked lanes are excluded from
    every sum and keep their running average."""
    if pi_u.shape[-2] == 0:
        raise ValueError("empty held-out population: heldout_ratio too "
                         "small for this graph")
    eps = cfg.epsilon
    pp = pi_u * pi_v
    pi_sum = torch.sum(pp, dim=-1)
    s_link = torch.sum(pp * beta, dim=-1)
    s_non = (torch.sum(pp * (1.0 - beta), dim=-1)
             + (1.0 - pi_sum) * (1.0 - eps))
    lik = torch.clamp(torch.where(y, s_link, s_non), min=1e-30)

    c = torch.tensor(float(avg_count), dtype=pi_u.dtype,
                     device=pi_u.device)
    ppx_new = (ppx_per_edge * (c - 1.0) + lik) / c
    ppx_new = torch.where(mask, ppx_new, ppx_per_edge)
    # select, not a multiply: log of a zero padding lane is -inf
    lg = torch.where(mask, torch.log(torch.clamp(ppx_new, min=1e-30)),
                     torch.zeros_like(ppx_new))
    mf = mask.to(pi_u.dtype)
    yf = y.to(pi_u.dtype) * mf
    link_lik = torch.sum(lg * yf)
    non_link_lik = torch.sum(lg * (mf - yf))
    link_count = torch.sum(y & mask)
    non_link_count = torch.sum(mask) - link_count
    neg_avg = -(link_lik + non_link_lik) / (link_count
                                            + non_link_count).to(pi_u.dtype)
    return PpxResult(ppx_new, neg_avg, link_lik, non_link_lik,
                     link_count, non_link_count)
