"""Full (non-assortative) Mixed-Membership Stochastic Blockmodel
(counterpart of ``mcmc_ammsb_tpu/models/mmsb.py``).

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
else one ``_mmsb_step_body`` per step. Host-sampled
(``cfg.device_sampling`` off) the chunk's minibatches come from the host
sampler through ``learner.HostSamplingPipeline`` and go through the same
hoisted scan. ``mmsb_prior_diag`` and ``mmsb_noise_scale`` are the
identifiability knobs of the JAX package.

``MMSBChainLearner`` runs C independent chains in one flat row space
(pi [C*N, K], chain c's node u at row c*N + u, as ``chains_flat``): the
step cores below take an optional leading chain axis where the JAX
package vmaps them. The chain engine has no windowed mode in the JAX
package and none here: every step is torch ops.
"""

from __future__ import annotations

import logging
import math
from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from mcmc_ammsb_tpu_torch import learner, rng
from mcmc_ammsb_tpu_torch.config import Config, PhiImpl, RngBackend
from mcmc_ammsb_tpu_torch.ops import phi as phi_ops
from mcmc_ammsb_tpu_torch.ops.device_sampling import (
    sample_minibatches_device)
from mcmc_ammsb_tpu_torch.ops.neighbor import sample_neighbors
from mcmc_ammsb_tpu_torch.ops.phi import step_size
from mcmc_ammsb_tpu_torch.ops.rowops import row_normalize
from mcmc_ammsb_tpu_torch.ops.window import _chain_flat_ids, index_operands

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
    theta_b = learner.gamma_draws(cfg, rng.host_gamma_rng(cfg),
                                  (cfg.K, cfg.K, 2), device).to(dtype)
    # undirected graphs: B is symmetric, and stays so (symmetrized
    # gradients and noise)
    theta_b = 0.5 * (theta_b + theta_b.transpose(0, 1))
    # break the label-symmetry saddle with a diagonal tilt at init
    diag_boost = 1.0 + 2.0 * torch.eye(cfg.K, dtype=dtype, device=device)
    theta_b[..., 1] *= diag_boost
    pi, phi_sum = learner.gamma_rows(cfg, device, dtype)
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
    phi_k = pi_n * phis[..., None]
    phi_new = torch.abs(
        phi_k
        + eps_t / 2.0 * (cfg.alpha_value - phi_k + (cfg.N / n_nb) * grads)
        + torch.sqrt(eps_t * phi_k) * noise)
    return row_normalize(torch.clamp(phi_new, min=_FLOOR))


def _phi_rows_core(cfg: Config, pi_n, phis, b, pi_nb, y, step_count,
                   noise):
    """Private draws: pi_n [B, K], phis [B], b [K, K], pi_nb [B, n, K],
    y [B, n]; every operand may carry a leading chain axis."""
    n_nb = cfg.num_node_sample
    bt = b.transpose(-1, -2)
    g_link = pi_nb @ (bt if b.dim() == 2 else bt[..., None, :, :])
    # (1-B) pi_b = rowsum(pi_b) - B pi_b (rows are normalized)
    g_non = pi_nb.sum(-1, keepdim=True) - g_link
    g = torch.where(y[..., None], g_link, g_non)       # [B, n, K]
    probs = pi_n[..., None, :] * g
    p = probs.sum(-1, keepdim=True)
    inv_phi = 1.0 / phis[..., None]
    grads = (probs / p).sum(-2) / pi_n * inv_phi - n_nb * inv_phi
    return _phi_update(cfg, pi_n, phis, grads, n_nb, step_count, noise)


def _phi_rows_core_shared(cfg: Config, pi_n, phis, b, pi_nb, y, nbr_mask,
                          step_count, noise):
    """One shared draw pi_nb [n, K] for the whole minibatch, factorized
    so no [B, n, K] tensor exists; self-collision lanes (nbr_mask False)
    are excluded with the count-aware N/n_valid scale. Every operand
    may carry a leading chain axis (pi_nb [C, n, K], b [C, K, K])."""
    g_link = pi_nb @ b.transpose(-1, -2)               # [n, K]
    g_non = pi_nb.sum(-1, keepdim=True) - g_link
    p = torch.where(y, pi_n @ g_link.transpose(-1, -2),
                    pi_n @ g_non.transpose(-1, -2))    # [B, n]
    inv_p = 1.0 / p
    yf = y.to(pi_n.dtype)
    mf = nbr_mask.to(pi_n.dtype)
    w_link = yf * inv_p * mf
    w_non = (1.0 - yf) * inv_p * mf
    s = w_link @ g_link + w_non @ g_non                # [B, K]
    n_valid = mf.sum(-1, keepdim=True)                 # [B, 1]
    grads = (s - n_valid) * (1.0 / phis[..., None])
    return _phi_update(cfg, pi_n, phis, grads, n_valid, step_count, noise)


def _theta_grads_core(cfg: Config, theta_b, b, pi_u, pi_v, y, mask):
    """Responsibility fan-in over the edges: pi_u/pi_v [E, K], y/mask
    [E] bool. Returns the symmetrized gradient [K, K, 2]. Every operand
    may carry a leading chain axis (theta_b [C, K, K, 2], b [C, K, K])."""
    b_e = b[..., None, :, :]                           # one B for E edges
    f = torch.where(y[..., None, None], b_e, 1.0 - b_e)   # [E, K, K]
    num = pi_u[..., :, None] * pi_v[..., None, :] * f
    r = num / num.sum(dim=(-2, -1), keepdim=True)
    inv_ts = (1.0 / theta_b.sum(-1))[..., None, :, :]
    yf = y.to(pi_u.dtype)[..., None, None]
    g0 = r * ((1.0 - yf) / theta_b[..., None, :, :, 0] - inv_ts)
    g1 = r * (yf / theta_b[..., None, :, :, 1] - inv_ts)
    m = mask.to(pi_u.dtype)[..., None, None]
    g = torch.stack([(g0 * m).sum(-3), (g1 * m).sum(-3)], dim=-1)
    # undirected graphs: averaging with the transpose is processing
    # each edge in both orientations
    return 0.5 * (g + g.transpose(-3, -2))


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
    updater's own (1-based) step counter. With a leading chain axis on
    theta_b, grads and noise, ``scale`` is [C, 1, 1, 1]."""
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


def mmsb_phi_noise(cfg: Config, phi_noise):
    """The phi noise operand at the noise temperature; the ones of the
    noise-free mode (``learner.phi_noise_operand``) stay ones, as in the
    JAX package."""
    return phi_noise if cfg.phi_disable_noise else mmsb_noise_scale(
        cfg, phi_noise)


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
     phi_noise [S, B, K] (ones with ``cfg.phi_disable_noise``),
     t_noise [S, K, K, 2] symmetrized, y_edges [S, E], lanes_u, lanes_v)."""
    neighbors, y_phi, y_edges, lanes_u, lanes_v, phi_noise = (
        learner.hoist_common(cfg, edge_set, batches, streams))
    if cfg.shared_neighbors:
        neighbors = neighbors[:, 0]
    s_len = batches.nodes.shape[0]
    t_noise = _symmetrize_noise(cfg, rng.randn(
        streams.beta, (s_len, cfg.K, cfg.K, 2), batches.nodes.device))
    return (batches, neighbors, y_phi, mmsb_phi_noise(cfg, phi_noise),
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


def mmsb_draw_step_operands(cfg: Config, streams, batch):
    """One step's random operands from the streams, (neighbors [B, n]
    private draws around the batch nodes, phi_noise [B, K], t_noise
    [K, K, 2] symmetrized), both noises at the noise temperature; the
    phi noise is ones with ``cfg.phi_disable_noise``."""
    dev = batch.nodes.device
    neighbors = sample_neighbors(streams.neighbor, batch.nodes, cfg.N,
                                 cfg.num_node_sample)
    phi_noise = mmsb_phi_noise(cfg, learner.phi_noise_operand(
        cfg, streams.phi, (batch.nodes.shape[0], cfg.K), dev))
    t_noise = mmsb_noise_scale(cfg, _symmetrize_noise(cfg, rng.randn(
        streams.beta, (cfg.K, cfg.K, 2), dev)))
    return neighbors, phi_noise, t_noise


def mmsb_train_step(cfg: Config, edge_set, state: MMSBState, batch,
                    neighbors, phi_noise, t_noise) -> MMSBState:
    """One SGRLD step on one minibatch (the JAX package's
    ``mmsb_train_step``) with its random operands given
    (``mmsb_draw_step_operands`` draws them): private neighbor draws
    [B, n]; the phi update gathers its rows and queries membership, the
    theta stage re-reads the endpoint rows from the new pi and queries
    the edge labels."""
    nodes = batch.nodes.long().clamp(0, cfg.N - 1)
    y = edge_set.has_edges(batch.nodes[:, None], neighbors)
    rows, sums = _phi_rows_core(cfg, state.pi[nodes], state.phi_sum[nodes],
                                state.b, state.pi[neighbors.long()], y,
                                state.step_count, phi_noise)
    pi, phi_sum = phi_ops.scatter_rows(state.pi, state.phi_sum, batch.nodes,
                                       batch.node_mask, rows, sums)
    count = state.theta_count + 1
    eu = batch.edges_u.long().clamp(max=cfg.N - 1)
    ev = batch.edges_v.long().clamp(max=cfg.N - 1)
    grads = _theta_grads_core(
        cfg, state.theta_b, state.b, pi[eu], pi[ev],
        edge_set.has_edges(batch.edges_u, batch.edges_v), batch.edge_mask)
    theta_b, b = mmsb_theta_step(cfg, state.theta_b, grads, batch.weight,
                                 count, t_noise)
    return state._replace(pi=pi, phi_sum=phi_sum, theta_b=theta_b, b=b,
                          step_count=state.step_count + 1, theta_count=count)


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

    keeps_train_ppx = False

    def __init__(self, cfg: Config, graph, split, device="cuda",
                 prefetch: bool = True):
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
        super().__init__(cfg, graph, split, device, prefetch)

    @staticmethod
    def _check(cfg: Config) -> None:
        if cfg.pi_dtype != "float32":
            raise ValueError("the full-MMSB family keeps pi in fp32; "
                             "pi_dtype=bfloat16 is a-MMSB single-chip "
                             "only")

    def _init_state(self, heldout_size: int) -> MMSBState:
        return init_mmsb_state(self.cfg, heldout_size, self.device)

    def _train_chunk(self, state, num_steps: int):
        return mmsb_steps_fused(self.cfg, self.training_set,
                                self.heldout_set, state, num_steps,
                                self.adjacency, self.streams)

    def _scan_chunk(self, state, batches):
        return mmsb_steps_scan(self.cfg, self.training_set, state, batches,
                               self.streams)

    def run(self, max_iters: int) -> None:
        """``max_iters`` steps in chunks of steps_per_call: device-sampled,
        or host-sampled through the scanned loop at every steps_per_call
        (the JAX learner's ``sample_many`` then ``mmsb_steps_scan``; it
        has no step-at-a-time loop)."""
        spc = max(1, self.cfg.steps_per_call)
        with self.timers.stage("total"):
            if self.cfg.device_sampling:
                self._run_fused(max_iters)
            else:
                self._run_scanned(max_iters, spc)

    def _evaluate(self, state):
        return mmsb_perplexity(self.cfg, self.heldout_set, self.heldout_u,
                               self.heldout_v, state)

    @staticmethod
    def _read_stats(neg_avg) -> dict:
        return {"ppx": float(torch.exp(neg_avg))}


# ---------------------------------------------------------------------------
# Multi-chain engine: C independent full-MMSB chains, flat row layout
# ---------------------------------------------------------------------------

class MMSBChainState(NamedTuple):
    """C chains' state; ``pi`` and ``phi_sum`` are updated in place, the
    counters are host integers shared by the chains (lockstep)."""

    pi: torch.Tensor            # [C*N, K]
    phi_sum: torch.Tensor       # [C*N]
    theta_b: torch.Tensor       # [C, K, K, 2]
    b: torch.Tensor             # [C, K, K]
    step_count: int             # starts at 1
    theta_count: int            # starts at 0
    ppx_per_edge: torch.Tensor  # [C, H]
    ppx_count: int


def init_mmsb_chain_state(cfg: Config, num_chains: int, heldout_size: int,
                          device, dtype=torch.float32) -> MMSBChainState:
    """Chain c is ``init_mmsb_state`` with ``init_seed + c``."""
    states = [init_mmsb_state(cfg.replace(init_seed=cfg.init_seed + c), 0,
                              device, dtype) for c in range(num_chains)]
    return MMSBChainState(
        pi=torch.cat([s.pi for s in states]),
        phi_sum=torch.cat([s.phi_sum for s in states]),
        theta_b=torch.stack([s.theta_b for s in states]),
        b=torch.stack([s.b for s in states]),
        step_count=1, theta_count=0,
        ppx_per_edge=torch.zeros(num_chains, heldout_size, dtype=dtype,
                                 device=device),
        ppx_count=0)


def mmsb_hoist_chain_operands(cfg: Config, num_chains: int, edge_set,
                              heldout_set, adjacency, streams,
                              num_steps: int):
    """Draw S*C minibatches and everything state-independent for S steps
    of C chains: the scan operands of the JAX package's
    ``_mmsb_chains_chunk``, in its order and layouts,
    (nodes [S,C,B] (sentinel N), node_mask, edges_u [S,C,E], edges_v,
     edge_mask, weight [S,C], neighbors [S,C,n] shared (one draw per step
     and chain) or [S,C*B,n] private, y_phi [S,C,B,n], phi_noise
     [S,C,B,K] (ones with ``cfg.phi_disable_noise``), t_noise
     [S,C,K,K,2] symmetrized per chain, y_edges [S,C,E])."""
    c, s_len, k = num_chains, num_steps, cfg.K
    ds = sample_minibatches_device(cfg, edge_set, heldout_set, streams.sample,
                                   s_len * c, adjacency, alt_period=c)

    def r(x):
        return x.reshape(s_len, c, *x.shape[1:])

    nodes, node_mask = r(ds.nodes), r(ds.node_mask)
    eu, ev, emask = r(ds.edges_u), r(ds.edges_v), r(ds.edge_mask)
    weight = ds.weight.reshape(s_len, c)
    dev = nodes.device
    b_cap = nodes.shape[-1]
    if cfg.shared_neighbors:
        sentinel = torch.full((s_len, c), cfg.N, dtype=torch.int32,
                              device=dev)
        neighbors = sample_neighbors(streams.neighbor, sentinel, cfg.N,
                                     cfg.num_node_sample)       # [S, C, n]
        y_phi = edge_set.has_edges(nodes[..., None],
                                   neighbors[:, :, None, :])
    else:
        flat_nodes = nodes.reshape(s_len, c * b_cap)
        neighbors = sample_neighbors(streams.neighbor, flat_nodes, cfg.N,
                                     cfg.num_node_sample)   # [S, C*B, n]
        y_phi = edge_set.has_edges(flat_nodes[:, :, None],
                                   neighbors).reshape(s_len, c, b_cap, -1)
    phi_noise = mmsb_phi_noise(cfg, learner.phi_noise_operand(
        cfg, streams.phi, (s_len, c, b_cap, k), dev))
    t_noise = mmsb_noise_scale(cfg, _symmetrize_noise(cfg, rng.randn(
        streams.beta, (s_len, c, k, k, 2), dev)))
    y_edges = edge_set.has_edges(eu, ev)
    return (nodes, node_mask, eu, ev, emask, weight, neighbors, y_phi,
            phi_noise, t_noise, y_edges)


def _mmsb_chain_step_body(cfg: Config, c: int, st: MMSBChainState,
                          x) -> MMSBChainState:
    """One SGRLD step of all C chains on its hoisted operands, the cores
    batched over the chain axis (the body of the JAX package's
    ``_mmsb_chains_chunk``). The sentinel N maps to the flat sentinel
    C*N, whose gather is clamped to C*N - 1 as JAX clamps it; masked
    lanes never reach pi (``scatter_rows`` goes by the mask)."""
    (nodes, nmask, eu, ev, emask, w, nbrs, y_n, n_phi, n_theta, y_e) = x
    n_rows, k = cfg.N, cfg.K
    b_cap = nodes.shape[-1]
    offsets = (torch.arange(c, dtype=torch.int32, device=nodes.device)
               * n_rows)[:, None]                               # [C, 1]
    flat_nodes = _chain_flat_ids(nodes, n_rows).reshape(-1)    # [C*B]
    gidx = flat_nodes.long().clamp(max=c * n_rows - 1)
    pi_n = st.pi[gidx].reshape(c, b_cap, k)
    phis = st.phi_sum[gidx].reshape(c, b_cap)
    if cfg.shared_neighbors:
        pi_nb = st.pi[(nbrs + offsets).long()]                 # [C, n, K]
        nm = nbrs[:, None, :] != nodes[..., None]              # [C, B, n]
        rows, sums = _phi_rows_core_shared(cfg, pi_n, phis, st.b, pi_nb,
                                           y_n, nm, st.step_count, n_phi)
    else:
        flat_nbrs = nbrs.reshape(c, b_cap, -1) + offsets[:, :, None]
        rows, sums = _phi_rows_core(cfg, pi_n, phis, st.b,
                                    st.pi[flat_nbrs.long()], y_n,
                                    st.step_count, n_phi)
    pi, phi_sum = phi_ops.scatter_rows(st.pi, st.phi_sum, flat_nodes,
                                       nmask.reshape(-1),
                                       rows.reshape(c * b_cap, k),
                                       sums.reshape(-1))
    count = st.theta_count + 1
    pi_u = pi[(eu + offsets).reshape(-1).long()].reshape(c, -1, k)
    pi_v = pi[(ev + offsets).reshape(-1).long()].reshape(c, -1, k)
    grads = _theta_grads_core(cfg, st.theta_b, st.b, pi_u, pi_v, y_e, emask)
    theta_b, b = mmsb_theta_step(cfg, st.theta_b, grads,
                                 w[:, None, None, None], count, n_theta)
    return st._replace(pi=pi, phi_sum=phi_sum, theta_b=theta_b, b=b,
                       step_count=st.step_count + 1, theta_count=count)


def mmsb_run_chain_hoisted(cfg: Config, c: int, state: MMSBChainState,
                           xs) -> MMSBChainState:
    """Run the hoisted chain steps ``xs`` from ``state``, one batched
    step at a time."""
    for i in range(xs[0].shape[0]):
        state = _mmsb_chain_step_body(cfg, c, state, tuple(a[i] for a in xs))
    return state


def _mmsb_chains_chunk(cfg: Config, num_chains: int, edge_set, heldout_set,
                       adjacency, state: MMSBChainState, num_steps: int,
                       streams) -> MMSBChainState:
    """Advance all chains ``num_steps`` device-sampled steps: sample,
    hoist, run."""
    return mmsb_run_chain_hoisted(
        cfg, num_chains, state, mmsb_hoist_chain_operands(
            cfg, num_chains, edge_set, heldout_set, adjacency, streams,
            num_steps))


def _mmsb_chains_ppx(cfg: Config, num_chains: int, heldout_set, eu, ev,
                     state: MMSBChainState):
    """Per-chain held-out perplexity over the shared held-out population:
    (state, -mean log running-averaged likelihood [C] on the device)."""
    c, h, k = num_chains, eu.shape[0], cfg.K
    count = state.ppx_count + 1
    y = heldout_set.has_edges(eu, ev)                          # [H]
    offsets = (torch.arange(c, device=eu.device) * cfg.N)[:, None]
    pi_u = state.pi[(eu.long()[None, :] + offsets).reshape(-1)].reshape(
        c, h, k)
    pi_v = state.pi[(ev.long()[None, :] + offsets).reshape(-1)].reshape(
        c, h, k)
    link = torch.einsum("chk,ckl,chl->ch", pi_u, state.b, pi_v)
    # pi rows normalized: pi_u (1-B) pi_v = 1 - link
    lik = torch.clamp(torch.where(y[None, :], link, 1.0 - link), min=1e-30)
    cnt = float(count)
    ppx_new = (state.ppx_per_edge * (cnt - 1.0) + lik) / cnt   # [C, H]
    neg_avg = -torch.mean(torch.log(ppx_new), dim=-1)          # [C]
    return state._replace(ppx_per_edge=ppx_new, ppx_count=count), neg_avg


class MMSBChainLearner(learner.Learner):
    """C independent full-MMSB chains in one flat row space, on
    ``Learner``'s surface (``run``, ``run_with_ppx``,
    ``heldout_perplexity``, ``print_stats``) with a [C] perplexity per
    evaluation: ``chains_flat.FlatChainLearner`` for ``--model mmsb``.
    Device sampling is forced on, as in the JAX package; ``cfg.window`` is
    not read (the engine has no windowed mode)."""

    keeps_train_ppx = False

    def __init__(self, cfg: Config, graph, split, num_chains: int,
                 device="cuda"):
        if num_chains < 1:
            raise ValueError(f"num_chains must be >= 1, got {num_chains}")
        if len(split.heldout_edges_u) == 0:
            raise ValueError("no held-out edges: heldout_ratio too small "
                             "for this graph")
        self.num_chains = num_chains
        super().__init__(cfg.replace(device_sampling=True), graph, split,
                         device)

    @staticmethod
    def _check(cfg: Config) -> None:
        """The JAX MMSBChainLearner's guards (models/mmsb.py:760-767)."""
        if cfg.rng_backend != RngBackend.NATIVE:
            raise ValueError("MMSBChainLearner supports the native RNG "
                             "backend only")
        if cfg.phi_impl != PhiImpl.JNP:
            raise ValueError("MMSBChainLearner supports phi_impl=jnp only")
        if cfg.pi_dtype != "float32":
            raise ValueError("chain engines keep pi in fp32")

    def _init_state(self, heldout_size: int) -> MMSBChainState:
        return init_mmsb_chain_state(self.cfg, self.num_chains, heldout_size,
                                     self.device)

    def _train_chunk(self, state, num_steps: int):
        return _mmsb_chains_chunk(self.cfg, self.num_chains,
                                  self.training_set, self.heldout_set,
                                  self.adjacency, state, num_steps,
                                  self.streams)

    def _evaluate(self, state):
        return _mmsb_chains_ppx(self.cfg, self.num_chains, self.heldout_set,
                                self.heldout_u, self.heldout_v, state)

    @staticmethod
    def _read_stats(neg_avg) -> dict:
        return {"ppx": np.exp(neg_avg.cpu().numpy())}
