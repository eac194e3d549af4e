"""The phi/pi SGRLD update (counterpart of ``mcmc_ammsb_tpu/ops/phi.py``).

Per minibatch node a with neighbors b_1..b_n, with the factorized
contraction of the JAX package:

    q_bn   = (pi_b * (beta - eps)) . pinb_n
    p_bn   = s_bn q_bn + e_bn               s = +/-1, e in {eps, 1-eps}
    grads  = ((beta - eps) sum_n (s/p) pinb_n + sum_n e/p - n_valid) / phi
    phi'   = max(1e-24, | phi_k + eps_t/2 (alpha - phi_k + N/n_valid grads)
                         + sqrt(eps_t phi_k) xi |)
    pi'    = phi' / sum(phi')
"""

from __future__ import annotations

from typing import Tuple

import torch

from mcmc_ammsb_tpu_torch.config import Config
from mcmc_ammsb_tpu_torch.ops.rowops import row_normalize
from mcmc_ammsb_tpu_torch.utils.profiling import stage

_PHI_FLOOR = 1e-24


def step_size(cfg: Config, steps, device) -> torch.Tensor:
    """eps_t = a (1 + t/b)^(-c) in float32, from int32 step counters —
    the dtype path the JAX package takes with its int32 counters. A host
    counter's copy to a card leaves from pageable memory, so the host
    waits there for the card's queue to drain: a ``device_wait`` span."""
    if isinstance(steps, torch.Tensor):
        return cfg.eps_t(steps.to(device=device, dtype=torch.int32))
    with stage("device_wait"):
        t = torch.as_tensor(steps, dtype=torch.int32, device=device)
    return cfg.eps_t(t)


def phi_update_core(
    cfg: Config,
    pi_n: torch.Tensor,      # [B, K] gathered pi rows of the nodes
    phis: torch.Tensor,      # [B] gathered phi sums
    pi_nb: torch.Tensor,     # [B, n, K], or [1, n, K] shared
    y: torch.Tensor,         # [B, n] bool edge labels
    beta: torch.Tensor,      # [K], or [B, K] per node
    step_count,              # int or int32 scalar tensor
    noise: torch.Tensor,     # [B, K]
    nbr_mask: torch.Tensor = None,  # [B, n] bool; False lanes excluded
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Staged phi' for the minibatch rows: (pi_rows [B, K], sums [B]).

    With shared neighbors, leading axes batch independent minibatches
    (the chain engine: pi_n [C, B, K], pi_nb [C, 1, n, K], beta
    [C, 1, K])."""
    eps = cfg.epsilon
    shared = pi_nb.shape[-3] == 1 and pi_n.shape[-2] != 1
    sgn = torch.where(y, 1.0, -1.0).to(pi_n.dtype)          # [B, n]
    e = torch.where(y, eps, 1.0 - eps).to(pi_n.dtype)       # [B, n]
    w = pi_n * (beta - eps)                                 # [B, K]
    if shared:
        nb = pi_nb[..., 0, :, :]                            # [n, K]
        q = w @ nb.transpose(-1, -2)                        # [B, n]
    else:
        q = torch.einsum("bk,bnk->bn", w, pi_nb)
    p = sgn * q + e
    inv_p = 1.0 / p
    a = sgn * inv_p
    if nbr_mask is None:
        n_valid = float(cfg.num_node_sample)
        scale_n = cfg.N / cfg.num_node_sample
        ce = torch.sum(e * inv_p, dim=-1, keepdim=True)     # [B, 1]
    else:
        mf = nbr_mask.to(pi_n.dtype)
        a = a * mf
        ce = torch.sum(e * inv_p * mf, dim=-1, keepdim=True)
        n_valid = torch.sum(mf, dim=-1, keepdim=True)       # [B, 1]
        scale_n = cfg.N / n_valid
    if shared:
        contrib = a @ nb                                    # [B, K]
    else:
        contrib = torch.einsum("bn,bnk->bk", a, pi_nb)
    s_contrib = (beta - eps) * contrib + ce
    grads = (s_contrib - n_valid) * (1.0 / phis[..., None])

    eps_t = step_size(cfg, step_count, pi_n.device)
    phi_k = pi_n * phis[..., None]
    phi_new = torch.abs(
        phi_k
        + eps_t / 2.0 * (cfg.alpha_value - phi_k + scale_n * grads)
        + torch.sqrt(eps_t * phi_k) * noise)
    phi_new = torch.clamp(phi_new, min=_PHI_FLOOR)
    return row_normalize(phi_new)


def phi_update_rows(cfg: Config, pi: torch.Tensor, phi_sum: torch.Tensor,
                    beta: torch.Tensor, edge_set, nodes: torch.Tensor,
                    neighbors: torch.Tensor, step_count,
                    noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather + membership + ``phi_update_core`` for one step with private
    neighbor draws: pi [N, K], phi_sum [N], nodes [B], neighbors [B, n].
    Padded node lanes (the sentinel N, or id 0 with a false mask) are
    clamped into the table as JAX's gather clamps them; their rows are the
    caller's to drop."""
    idx = nodes.long().clamp(0, pi.shape[0] - 1)
    cdt = phi_sum.dtype                  # compute type, as in JAX
    y = edge_set.has_edges(nodes[:, None], neighbors)
    return phi_update_core(cfg, pi[idx].to(cdt), phi_sum[idx],
                           pi[neighbors.long()].to(cdt), y, beta,
                           step_count, noise)


def scatter_rows(pi: torch.Tensor, phi_sum: torch.Tensor,
                 nodes: torch.Tensor, node_mask: torch.Tensor,
                 pi_rows: torch.Tensor, sums: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write the staged rows of the unmasked lanes back, in place.

    JAX drops masked lanes through an out-of-range index (mode="drop"),
    which torch would fault on; selecting the unmasked lanes with a
    boolean mask would make the host wait for the device on every call.
    Instead every masked lane is pointed at the first unmasked lane and
    carries that lane's row, so a repeated index only ever repeats the
    same bytes and the result does not depend on the write order. The
    unmasked indices themselves are unique (deduplicated node lists,
    last-write-wins windows). The ids of masked lanes are never used:
    they may be the sentinel N or 0. With no lane unmasked every lane is
    pointed at row 0 and carries that row's present contents, so the
    write changes nothing, as in JAX."""
    # one reduction gives both "is any lane unmasked" and such a lane;
    # 1-element tensors: a 0-d tensor index would be read on the host
    any_lane, anchor = node_mask.max(dim=0, keepdim=True)
    target = torch.where(any_lane, nodes[anchor], 0)
    idx = torch.where(node_mask, nodes, target).long()
    row_a = torch.where(any_lane[:, None], pi_rows[anchor].to(pi.dtype),
                        pi[:1])
    sum_a = torch.where(any_lane, sums[anchor].to(phi_sum.dtype),
                        phi_sum[:1])
    pi.index_copy_(0, idx, torch.where(node_mask[:, None],
                                       pi_rows.to(pi.dtype), row_a))
    phi_sum.index_copy_(0, idx, torch.where(node_mask,
                                            sums.to(phi_sum.dtype), sum_a))
    return pi, phi_sum
