"""Full (non-assortative) Mixed-Membership Stochastic Blockmodel
(counterpart of ``mcmc_ammsb_tpu/models/mmsb.py``, single chain).

The community interaction is a full, symmetric matrix B in [0,1]^{K x K}
(theta_b [K, K, 2], B = theta_b[..., 1] / theta_b.sum(-1)) instead of the
a-MMSB's diagonal beta with an epsilon background:

    phi:    grads_k = sum_j [ (probs_jk / p_j) / phi_ak - 1 / phi_a ],
            p_j = pi_a^T F pi_j, F = B if linked else 1 - B
    theta:  r_kl = pi_ak pi_bl F_kl / p, symmetrized 0.5 (g + g^T)
    ppx:    link L = pi_a^T B pi_b, non-link 1 - L

One training chunk samples S minibatches on the device, hoists the
state-independent operands (``mmsb_hoist_operands``: the JAX package's
operand tuple) and runs the steps (``mmsb_run_hoisted``): in windows of
``cfg.window`` through ``ops/window_mmsb`` when the draws are shared,
else one ``_mmsb_step_body`` per step. ``mmsb_prior_diag`` and
``mmsb_noise_scale`` are the identifiability knobs of the JAX package.
"""

from __future__ import annotations

import logging
import math
from functools import partial
from typing import NamedTuple

import torch

from mcmc_ammsb_tpu_torch import learner, rng
from mcmc_ammsb_tpu_torch.config import Config
from mcmc_ammsb_tpu_torch.ops import phi as phi_ops
from mcmc_ammsb_tpu_torch.ops.device_sampling import (
    sample_minibatches_device)
from mcmc_ammsb_tpu_torch.ops.phi import step_size
from mcmc_ammsb_tpu_torch.ops.rowops import row_normalize
from mcmc_ammsb_tpu_torch.ops.window import index_operands

log = logging.getLogger("mcmc_ammsb_tpu_torch")

_FLOOR = 1e-24


class MMSBState(NamedTuple):
    """Sampler state; ``pi`` and ``phi_sum`` are updated in place, the
    counters are host integers."""

    pi: torch.Tensor            # [N, K]
    phi_sum: torch.Tensor       # [N]
    theta_b: torch.Tensor       # [K, K, 2], symmetric in (k, l)
    b: torch.Tensor             # [K, K]
    step_count: int             # starts at 1
    theta_count: int            # starts at 0
    ppx_per_edge: torch.Tensor  # [H]
    ppx_count: int


def init_mmsb_state(cfg: Config, heldout_size: int, device,
                    dtype=torch.float32) -> MMSBState:
    """theta_b ~ Gamma(eta0, eta1), symmetrized, with the 1 + 2 I tilt of
    its link component; pi rows as ``learner.gamma_rows`` draws them."""
    draws = rng.host_gamma_rng(cfg)
    theta_b = learner.gamma_draws(cfg, draws, (cfg.K, cfg.K, 2),
                                  device).to(dtype)
    # undirected graphs: B is symmetric, and stays so (symmetrized
    # gradients and noise)
    theta_b = 0.5 * (theta_b + theta_b.transpose(0, 1))
    # break the label-symmetry saddle with a diagonal tilt at init
    diag_boost = 1.0 + 2.0 * torch.eye(cfg.K, dtype=dtype, device=device)
    theta_b[..., 1] *= diag_boost
    pi, phi_sum = learner.gamma_rows(cfg, draws, device, dtype)
    return MMSBState(
        pi=pi, phi_sum=phi_sum, theta_b=theta_b,
        b=theta_b[..., 1] / theta_b.sum(-1), step_count=1, theta_count=0,
        ppx_per_edge=torch.zeros(heldout_size, dtype=dtype, device=device),
        ppx_count=0)


# ---------------------------------------------------------------------------
# Step math on pre-gathered rows
# ---------------------------------------------------------------------------

def _phi_update(cfg: Config, pi_n, phis, grads, n_nb, step_count, noise):
    """The SGRLD mirror step, the floor and the row normalization."""
    eps_t = step_size(cfg, step_count, pi_n.device)
    phi_k = pi_n * phis[:, None]
    phi_new = torch.abs(
        phi_k
        + eps_t / 2.0 * (cfg.alpha_value - phi_k + (cfg.N / n_nb) * grads)
        + torch.sqrt(eps_t * phi_k) * noise)
    return row_normalize(torch.clamp(phi_new, min=_FLOOR))


def _phi_rows_core(cfg: Config, pi_n, phis, b, pi_nb, y, step_count,
                   noise):
    """Private draws: pi_n [B, K], phis [B], pi_nb [B, n, K], y [B, n]."""
    n_nb = cfg.num_node_sample
    flat_nb = pi_nb.reshape(-1, cfg.K)
    g_link = flat_nb @ b.T
    # (1-B) pi_b = rowsum(pi_b) - B pi_b (rows are normalized)
    g_non = flat_nb.sum(-1, keepdim=True) - g_link
    g = torch.where(y.reshape(-1, 1), g_link, g_non).reshape(pi_nb.shape)
    probs = pi_n[:, None, :] * g                       # [B, n, K]
    p = probs.sum(-1, keepdim=True)
    inv_phi = 1.0 / phis[:, None]
    grads = (probs / p).sum(1) / pi_n * inv_phi - n_nb * inv_phi
    return _phi_update(cfg, pi_n, phis, grads, n_nb, step_count, noise)


def _phi_rows_core_shared(cfg: Config, pi_n, phis, b, pi_nb, y, nbr_mask,
                          step_count, noise):
    """One shared draw pi_nb [n, K] for the whole minibatch, factorized
    so no [B, n, K] tensor exists; self-collision lanes (nbr_mask False)
    are excluded with the count-aware N/n_valid scale."""
    g_link = pi_nb @ b.T                               # [n, K]
    g_non = pi_nb.sum(-1, keepdim=True) - g_link
    p = torch.where(y, pi_n @ g_link.T, pi_n @ g_non.T)   # [B, n]
    inv_p = 1.0 / p
    yf = y.to(pi_n.dtype)
    mf = nbr_mask.to(pi_n.dtype)
    w_link = yf * inv_p * mf
    w_non = (1.0 - yf) * inv_p * mf
    s = w_link @ g_link + w_non @ g_non                # [B, K]
    n_valid = mf.sum(-1, keepdim=True)                 # [B, 1]
    grads = (s - n_valid) * (1.0 / phis[:, None])
    return _phi_update(cfg, pi_n, phis, grads, n_valid, step_count, noise)


def _theta_grads_core(cfg: Config, theta_b, b, pi_u, pi_v, y, mask):
    """Responsibility fan-in over the edges: pi_u/pi_v [E, K], y/mask
    [E] bool. Returns the symmetrized gradient [K, K, 2]."""
    f = torch.where(y[:, None, None], b, 1.0 - b)      # [E, K, K]
    num = pi_u[:, :, None] * pi_v[:, None, :] * f
    r = num / num.sum(dim=(1, 2), keepdim=True)
    inv_ts = 1.0 / theta_b.sum(-1)
    yf = y.to(pi_u.dtype)[:, None, None]
    g0 = r * ((1.0 - yf) / theta_b[..., 0] - inv_ts)
    g1 = r * (yf / theta_b[..., 1] - inv_ts)
    m = mask.to(pi_u.dtype)[:, None, None]
    g = torch.stack([(g0 * m).sum(0), (g1 * m).sum(0)], dim=-1)
    # undirected graphs: averaging with the transpose is processing
    # each edge in both orientations
    return 0.5 * (g + g.transpose(0, 1))


def mmsb_eta(cfg: Config, dtype, device) -> torch.Tensor:
    """The theta prior per cell, [K, K, 2] broadcastable: (eta0, eta1),
    with ``mmsb_prior_diag`` (a scalar or an (eta0, eta1) pair) on the
    diagonal cells."""
    eta = torch.tensor([cfg.eta0, cfg.eta1], dtype=dtype, device=device)
    if cfg.mmsb_prior_diag is None:
        return eta
    eye = torch.eye(cfg.K, dtype=torch.bool, device=device)[..., None]
    diag = torch.as_tensor(cfg.mmsb_prior_diag, dtype=dtype, device=device)
    return torch.where(eye, diag, eta)


def mmsb_theta_step(cfg: Config, theta_b, grads, scale, count, noise):
    """SGRLD step on theta_b [K, K, 2] and B; ``count`` is the theta
    updater's own (1-based) step counter."""
    eps_t = step_size(cfg, count, theta_b.device)
    eta = mmsb_eta(cfg, theta_b.dtype, theta_b.device)
    theta_new = torch.abs(
        theta_b + eps_t / 2.0 * (eta - theta_b + scale * grads)
        + torch.sqrt(eps_t * theta_b) * noise)
    theta_new = torch.clamp(theta_new, min=_FLOOR)
    return theta_new, theta_new[..., 1] / theta_new.sum(-1)


def mmsb_noise_scale(cfg: Config, noise):
    """The SGRLD noise temperature (``mmsb_noise_scale``; 1 = exact
    posterior sampling)."""
    if cfg.mmsb_noise_scale == 1.0:
        return noise
    return noise * cfg.mmsb_noise_scale


def _symmetrize_noise(cfg: Config, t_noise):
    """[..., K, K, 2] theta noise made symmetric in (k, l): off-diagonal
    pairs tied as (xi + xi^T) / sqrt(2) (unit variance), diagonal cells
    keep their own draw."""
    sym = (t_noise + t_noise.transpose(-3, -2)) / math.sqrt(2.0)
    eye = torch.eye(cfg.K, dtype=torch.bool, device=t_noise.device)[..., None]
    return torch.where(eye, t_noise, sym)


def mmsb_perplexity(cfg: Config, heldout_set, eu, ev, state: MMSBState):
    """One held-out evaluation: (state, -mean log running-averaged
    likelihood as a device scalar)."""
    count = state.ppx_count + 1
    y = heldout_set.has_edges(eu, ev)
    pi_u = state.pi[eu.long()]
    pi_v = state.pi[ev.long()]
    link = torch.einsum("ek,kl,el->e", pi_u, state.b, pi_v)
    # pi rows normalized: sum_kl pi_u (1-B) pi_v = 1 - link
    lik = torch.clamp(torch.where(y, link, 1.0 - link), min=1e-30)
    c = float(count)
    ppx_new = (state.ppx_per_edge * (c - 1.0) + lik) / c
    neg_avg = -torch.mean(torch.log(ppx_new))
    return state._replace(ppx_per_edge=ppx_new, ppx_count=count), neg_avg


# ---------------------------------------------------------------------------
# The hoisted training loop
# ---------------------------------------------------------------------------

def mmsb_hoist_operands(cfg: Config, edge_set, batches, streams):
    """The operand tuple of the JAX package's mmsb_steps_scan:
    (batches, neighbors [S, n] shared or [S, B, n] private, y_phi [S,B,n],
     phi_noise [S, B, K], t_noise [S, K, K, 2] symmetrized, y_edges [S, E],
     lanes_u, lanes_v)."""
    neighbors, y_phi, y_edges, lanes_u, lanes_v, phi_noise = (
        learner.hoist_common(cfg, edge_set, batches, streams))
    if cfg.shared_neighbors:
        neighbors = neighbors[:, 0]
    s_len = batches.nodes.shape[0]
    t_noise = _symmetrize_noise(cfg, rng.randn(
        streams.beta, (s_len, cfg.K, cfg.K, 2), batches.nodes.device))
    return (batches, neighbors, y_phi, mmsb_noise_scale(cfg, phi_noise),
            mmsb_noise_scale(cfg, t_noise), y_edges, lanes_u, lanes_v)


def _mmsb_step_body(cfg: Config, s: MMSBState, x) -> MMSBState:
    """One sequential SGRLD step on its hoisted operands."""
    batch, nbrs, y_n, n_phi, n_theta, y_e, _lu, _lv = x
    # padded lanes carry the sentinel N: clamp as JAX's gather does
    nodes = batch.nodes.long().clamp(max=cfg.N - 1)
    pi_n, phis = s.pi[nodes], s.phi_sum[nodes]
    pi_nb = s.pi[nbrs.long()]
    if cfg.shared_neighbors:
        nm = nbrs[None, :] != batch.nodes[:, None]
        rows, sums = _phi_rows_core_shared(cfg, pi_n, phis, s.b, pi_nb, y_n,
                                           nm, s.step_count, n_phi)
    else:
        rows, sums = _phi_rows_core(cfg, pi_n, phis, s.b, pi_nb, y_n,
                                    s.step_count, n_phi)
    pi, phi_sum = phi_ops.scatter_rows(s.pi, s.phi_sum, batch.nodes,
                                       batch.node_mask, rows, sums)
    count = s.theta_count + 1
    grads = _theta_grads_core(
        cfg, s.theta_b, s.b, pi[batch.edges_u.long().clamp(max=cfg.N - 1)],
        pi[batch.edges_v.long().clamp(max=cfg.N - 1)], y_e,
        batch.edge_mask)
    theta_b, b = mmsb_theta_step(cfg, s.theta_b, grads, batch.weight,
                                 count, n_theta)
    return s._replace(pi=pi, phi_sum=phi_sum, theta_b=theta_b, b=b,
                      step_count=s.step_count + 1, theta_count=count)


def mmsb_run_hoisted(cfg: Config, state: MMSBState, xs) -> MMSBState:
    """Run the hoisted steps ``xs``: in windows when ``cfg.window > 1``
    and the draws are shared, else step by step."""
    body = partial(_mmsb_step_body, cfg)
    if cfg.window > 1 and cfg.shared_neighbors:
        from mcmc_ammsb_tpu_torch.ops.window_mmsb import mmsb_windowed_scan

        return mmsb_windowed_scan(cfg, state, xs, body)
    for i in range(xs[1].shape[0]):
        state = body(state, index_operands(xs, i))
    return state


def mmsb_steps_scan(cfg: Config, edge_set, state: MMSBState, batches,
                    streams) -> MMSBState:
    """Hoist, then run, S steps of the given minibatches."""
    return mmsb_run_hoisted(
        cfg, state, mmsb_hoist_operands(cfg, edge_set, batches, streams))


def mmsb_steps_fused(cfg: Config, edge_set, heldout_set, state: MMSBState,
                     num_steps: int, adjacency, streams) -> MMSBState:
    """``num_steps`` device-sampled steps (the sampler is the a-MMSB's)."""
    ds = sample_minibatches_device(cfg, edge_set, heldout_set,
                                   streams.sample, num_steps, adjacency)
    return mmsb_steps_scan(cfg, edge_set, state, learner.DeviceBatch(*ds),
                           streams)


class FullMMSBLearner(learner.Learner):
    """The full-B MMSB on one device (the a-MMSB Learner's surface:
    ``run``, ``run_with_ppx`` — the JAX package's mmsb_steps_fused_ppx
    is its loop of chunks and evaluations — ``heldout_perplexity`` and
    ``print_stats``).

    With a CUDA device, ``cfg.window > 1`` and shared draws, the
    constructor decides once whether the window kernel fits the card's
    shared memory per block; when it does not, the run takes the
    sequential scan (as the JAX package does when its TPU envelope is
    exceeded) and the decision is logged with its numbers."""

    def __init__(self, cfg: Config, graph, split, device="cuda"):
        device = learner.resolve_device(device)
        if (cfg.window > 1 and cfg.shared_neighbors
                and device.type == "cuda"):
            from mcmc_ammsb_tpu_torch.ops import window_mmsb

            fits, why = window_mmsb.window_fits(cfg, device)
            log.info("MMSB window %d %s", cfg.window,
                     "runs the window kernel" if fits else
                     "falls back to the sequential scan")
            log.info("  %s", why)
            if not fits:
                cfg = cfg.replace(window=0)
        super().__init__(cfg, graph, split, device)

    @staticmethod
    def _check(cfg: Config) -> None:
        if not cfg.device_sampling:
            raise NotImplementedError(
                "host-sampled full-MMSB training is not ported yet "
                "(ROADMAP queue 1 item 11)")
        if cfg.pi_dtype != "float32":
            raise ValueError("the full-MMSB family keeps pi in fp32; "
                             "pi_dtype=bfloat16 is a-MMSB only")

    def _init_state(self, heldout_size: int) -> MMSBState:
        return init_mmsb_state(self.cfg, heldout_size, self.device)

    def _train_chunk(self, state, num_steps: int):
        return mmsb_steps_fused(self.cfg, self.training_set,
                                self.heldout_set, state, num_steps,
                                self.adjacency, self.streams)

    def _evaluate(self, state):
        return mmsb_perplexity(self.cfg, self.heldout_set, self.heldout_u,
                               self.heldout_v, state)

    @staticmethod
    def _read_stats(neg_avg) -> dict:
        return {"ppx": float(torch.exp(neg_avg))}
