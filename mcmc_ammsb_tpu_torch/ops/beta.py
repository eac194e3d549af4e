"""The theta/beta SGRLD update (counterpart of
``mcmc_ammsb_tpu/ops/beta.py``):

  per minibatch edge (u, v) with label y:
    pp_k    = pi_uk pi_vk
    f_k     = (y ? beta_k : 1 - beta_k) pp_k
              / (sum_k' ... + (y ? eps : 1 - eps)(1 - sum_k pp_k))
    grad_k0 += f_k ((1 - y)/theta_k0 - 1/theta_sum_k)
    grad_k1 += f_k (y/theta_k1 - 1/theta_sum_k)
  theta'  = max(1e-24, | theta + eps_t/2 (eta - theta + scale grad)
                         + sqrt(eps_t theta) xi |)
  beta_k  = theta'_k1 / (theta'_k0 + theta'_k1)
"""

from __future__ import annotations

from typing import Tuple

import torch

from mcmc_ammsb_tpu_torch.config import Config
from mcmc_ammsb_tpu_torch.ops.phi import step_size
from mcmc_ammsb_tpu_torch.utils.profiling import stage

_THETA_FLOOR = 1e-24


def beta_gradients(cfg: Config, theta: torch.Tensor, beta: torch.Tensor,
                   pi: torch.Tensor, edge_set, edges_u: torch.Tensor,
                   edges_v: torch.Tensor, edge_mask: torch.Tensor
                   ) -> torch.Tensor:
    """``beta_gradients_core`` on the endpoint rows read from pi [N, K],
    with the labels queried from ``edge_set`` (padded edge lanes hold a
    valid id and a false mask)."""
    y = edge_set.has_edges(edges_u, edges_v)
    cdt = theta.dtype
    return beta_gradients_core(cfg, theta, beta, pi[edges_u.long()].to(cdt),
                               pi[edges_v.long()].to(cdt), y, edge_mask)


def beta_gradients_core(cfg: Config, theta: torch.Tensor,
                        beta: torch.Tensor, pi_u: torch.Tensor,
                        pi_v: torch.Tensor, y: torch.Tensor,
                        edge_mask: torch.Tensor) -> torch.Tensor:
    """Masked gradient fan-in over the edges of one minibatch: theta
    [K, 2], pi_u/pi_v [E, K], y/edge_mask [E] bool. Returns [K, 2]."""
    eps = cfg.epsilon
    theta_sum = theta[:, 0] + theta[:, 1]
    yf = y.to(pi_u.dtype)
    pp = pi_u * pi_v
    pi_sum = torch.sum(pp, dim=-1)
    probs = torch.where(y[:, None], beta, 1.0 - beta) * pp
    prob_0 = torch.where(y, eps, 1.0 - eps) * (1.0 - pi_sum)
    probs_sum = torch.sum(probs, dim=-1) + prob_0
    f = probs / probs_sum[:, None]
    inv_ts = 1.0 / theta_sum
    g0 = f * ((1.0 - yf)[:, None] / theta[:, 0] - inv_ts)
    g1 = f * (yf[:, None] / theta[:, 1] - inv_ts)
    m = edge_mask.to(pi_u.dtype)[:, None]
    return torch.stack([torch.sum(g0 * m, dim=0),
                        torch.sum(g1 * m, dim=0)], dim=-1)


def theta_step(cfg: Config, theta: torch.Tensor, grads: torch.Tensor,
               scale: torch.Tensor, count_calls, noise: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SGRLD step on theta [K, 2] + pairwise normalization into beta.
    ``count_calls`` is the beta updater's own (1-based) step counter."""
    eps_t = step_size(cfg, count_calls, theta.device)
    with stage("device_wait"):
        # a copy from pageable memory: the host waits for the card
        eta = torch.tensor([cfg.eta0, cfg.eta1], dtype=theta.dtype,
                           device=theta.device)
    theta_new = torch.abs(
        theta
        + eps_t / 2.0 * (eta - theta + scale * grads)
        + torch.sqrt(eps_t * theta) * noise)
    theta_new = torch.clamp(theta_new, min=_THETA_FLOOR)
    beta_new = theta_new[..., 1] / (theta_new[..., 0] + theta_new[..., 1])
    return theta_new, beta_new


def update_beta(cfg: Config, theta: torch.Tensor, beta: torch.Tensor,
                pi: torch.Tensor, edge_set, edges_u: torch.Tensor,
                edges_v: torch.Tensor, edge_mask: torch.Tensor,
                scale: torch.Tensor, count_calls, noise: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole beta stage of a step: gradients from pi, the SGRLD step,
    the normalization."""
    grads = beta_gradients(cfg, theta, beta, pi, edge_set, edges_u, edges_v,
                           edge_mask)
    return theta_step(cfg, theta, grads, scale, count_calls, noise)
