"""Flat multi-chain engine (counterpart of ``mcmc_ammsb_tpu/chains_flat.py``).

C independent SGRLD chains share ONE row space: pi [C*N, K] with chain
c's node u at row c*N + u, so every gather and scatter stays a plain
1-D-index operation. Padded node lanes carry the chain-local sentinel N,
which becomes the flat sentinel C*N (never another chain's row).

One training chunk is

  1. ``sample_minibatches_device`` draws S*C minibatches in one block
     (``alt_period=C``: with the alternate coin every chain of a step
     takes the same kind of draw);
  2. ``hoist_chain_operands`` computes the state-independent operands in
     the JAX package's tuple order and layouts ([S, C, ...]);
  3. ``run_chain_hoisted`` runs the S steps: in windows of ``cfg.window``
     through ``windowed_chain_scan`` — each window of all C chains ONE
     launch of the window kernel, which gathers, runs the T steps on one
     thread-block cluster per chain and scatters
     (``ops/window.window_chain_apply_cuda``; on CPU tensors the plain
     ``window_chain_apply_torch``: a bulk gather, the steps, a
     last-write-wins scatter) — and the remaining steps through
     ``_chain_step_body``, batched over chains.

The chains advance in lockstep, so the step counters are shared host
integers; every chain has its own theta [K, 2], beta [K], held-out
running average and init draw (``init_seed + c``).
"""

from __future__ import annotations

import time
from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from mcmc_ammsb_tpu_torch import rng
from mcmc_ammsb_tpu_torch.chains import beta_rhat_series
from mcmc_ammsb_tpu_torch.config import Config, PhiImpl, RngBackend
from mcmc_ammsb_tpu_torch.learner import (DeviceBatch, Learner, gamma_draws,
                                          gamma_rows, pi_storage_dtype)
from mcmc_ammsb_tpu_torch.ops import beta as beta_ops
from mcmc_ammsb_tpu_torch.ops import perplexity as ppx_ops
from mcmc_ammsb_tpu_torch.ops import phi as phi_ops
from mcmc_ammsb_tpu_torch.ops.device_sampling import sample_minibatches_device
from mcmc_ammsb_tpu_torch.ops.neighbor import sample_neighbors
from mcmc_ammsb_tpu_torch.ops.window import (_WINDOWS_PER_BATCH,
                                             _chain_flat_ids,
                                             _correction_codes,
                                             _last_write_wins,
                                             index_operands, plain_or,
                                             window_chain_apply_cuda,
                                             window_chain_apply_torch)


class ChainState(NamedTuple):
    """C chains' state; ``pi`` and ``phi_sum`` are updated in place, the
    counters are host integers shared by the chains (lockstep)."""

    pi: torch.Tensor            # [C*N, K]
    phi_sum: torch.Tensor       # [C*N]
    theta: torch.Tensor         # [C, K, 2]
    beta: torch.Tensor          # [C, K]
    step_count: int             # starts at 1
    beta_count: int             # starts at 0
    ppx_per_edge: torch.Tensor  # [C, H]
    ppx_count: int


def init_chain_state(cfg: Config, num_chains: int, heldout_size: int,
                     device, dtype=torch.float32) -> ChainState:
    """Chain c is ``learner.init_state`` with ``init_seed + c`` (theta
    from its host stream, its pi rows drawn on ``device`` in blocks),
    written straight into its block of the flat buffers; pi in its
    storage dtype."""
    n, k = cfg.N, cfg.K
    pi = torch.empty(num_chains * n, k, dtype=pi_storage_dtype(cfg),
                     device=device)
    phi_sum = torch.empty(num_chains * n, dtype=dtype, device=device)
    thetas = []
    for c in range(num_chains):
        cfg_c = cfg.replace(init_seed=cfg.init_seed + c)
        thetas.append(gamma_draws(cfg_c, rng.host_gamma_rng(cfg_c), (k, 2),
                                  device).to(dtype))
        gamma_rows(cfg_c, device, dtype,
                   out=(pi[c * n:(c + 1) * n], phi_sum[c * n:(c + 1) * n]))
    theta = torch.stack(thetas)
    return ChainState(
        pi=pi, phi_sum=phi_sum, theta=theta,
        beta=theta[..., 1] / (theta[..., 0] + theta[..., 1]),
        step_count=1, beta_count=0,
        ppx_per_edge=torch.zeros(num_chains, heldout_size, dtype=dtype,
                                 device=device),
        ppx_count=0)


# ---------------------------------------------------------------------------
# Hoisted operands and the sequential chain step
# ---------------------------------------------------------------------------

def _lanes(edges, nodes):
    """Each edge endpoint's lane in its chain's node list (argmax over
    int: ties go to the first lane, an all-false row gives 0, as in
    JAX)."""
    return torch.argmax((edges[..., None] == nodes[..., None, :])
                        .to(torch.int32), dim=-1).to(torch.int32)


def hoist_chain_operands(cfg: Config, num_chains: int, edge_set, heldout_set,
                         adjacency, streams: rng.Streams, num_steps: int):
    """Draw S*C minibatches and everything state-independent for S steps
    of C chains: the tuple of the JAX package's ``_chunk``
    (chains_flat.py:226-227), in its order and layouts,
    (nodes [S,C,B], node_mask, edges_u [S,C,E], edges_v, edge_mask,
     weight [S,C], neighbors [S,C,n] shared or [S,C*B,n] private,
     y_phi [S,C,B,n] or [S,C*B,n], phi_noise [S,C*B,K],
     beta_noise [S,C,K,2], y_edges [S,C,E], nbr_mask [S,C,B,n],
     lanes_u [S,C,E], lanes_v); with private draws nbr_mask and the lanes
    are [S] placeholders, as in JAX."""
    c, s_len, k = num_chains, num_steps, cfg.K
    ds = sample_minibatches_device(cfg, edge_set, heldout_set, streams.sample,
                                   s_len * c, adjacency, alt_period=c)

    def r(x):
        return x.reshape(s_len, c, *x.shape[1:])

    nodes, node_mask = r(ds.nodes), r(ds.node_mask)
    eu, ev, emask = r(ds.edges_u), r(ds.edges_v), r(ds.edge_mask)
    weight = ds.weight.reshape(s_len, c)
    dev = nodes.device
    if cfg.shared_neighbors:
        # one draw per (step, chain) around the sentinel "node" N: each
        # chain keeps its own stream, every node of a chain's minibatch
        # reads the same neighbor set
        sentinel = torch.full((s_len, c), cfg.N, dtype=torch.int32,
                              device=dev)
        neighbors = sample_neighbors(streams.neighbor, sentinel, cfg.N,
                                     cfg.num_node_sample)       # [S, C, n]
        y_phi = edge_set.has_edges(nodes[..., None],
                                   neighbors[:, :, None, :])  # [S,C,B,n]
        nbr_mask = neighbors[:, :, None, :] != nodes[..., None]
        lanes_u, lanes_v = _lanes(eu, nodes), _lanes(ev, nodes)
    else:
        flat_nodes = nodes.reshape(s_len, -1)                    # [S, C*B]
        neighbors = sample_neighbors(streams.neighbor, flat_nodes, cfg.N,
                                     cfg.num_node_sample)   # [S, C*B, n]
        y_phi = edge_set.has_edges(flat_nodes[:, :, None], neighbors)
        nbr_mask = torch.zeros(s_len, dtype=torch.bool, device=dev)
        lanes_u = lanes_v = torch.zeros(s_len, dtype=torch.int32, device=dev)
    phi_noise = rng.randn(streams.phi, (s_len, nodes.shape[1] * nodes.shape[2],
                                        k), dev)
    beta_noise = rng.randn(streams.beta, (s_len, c, k, 2), dev)
    y_edges = edge_set.has_edges(eu, ev)
    return (nodes, node_mask, eu, ev, emask, weight, neighbors, y_phi,
            phi_noise, beta_noise, y_edges, nbr_mask, lanes_u, lanes_v)


def _beta_gradients_chains(cfg: Config, theta, beta, pi_u, pi_v, y, mask):
    """``ops/beta.beta_gradients_core`` with a leading chain axis: theta
    [C, K, 2], beta [C, K], pi_u/pi_v [C, E, K], y/mask [C, E] bool.
    Returns [C, K, 2]."""
    eps = cfg.epsilon
    theta_sum = theta[..., 0] + theta[..., 1]                 # [C, K]
    yf = y.to(pi_u.dtype)
    pp = pi_u * pi_v                                          # [C, E, K]
    pi_sum = torch.sum(pp, dim=-1)
    probs = torch.where(y[..., None], beta[:, None, :],
                        1.0 - beta[:, None, :]) * pp
    prob_0 = torch.where(y, eps, 1.0 - eps) * (1.0 - pi_sum)
    probs_sum = torch.sum(probs, dim=-1) + prob_0
    f = probs / probs_sum[..., None]
    inv_ts = 1.0 / theta_sum[:, None, :]                      # [C, 1, K]
    g0 = f * ((1.0 - yf)[..., None] / theta[:, None, :, 0] - inv_ts)
    g1 = f * (yf[..., None] / theta[:, None, :, 1] - inv_ts)
    m = mask.to(pi_u.dtype)[..., None]
    return torch.stack([torch.sum(g0 * m, dim=1),
                        torch.sum(g1 * m, dim=1)], dim=-1)


def _chain_step_body(cfg: Config, c: int, st: ChainState, x) -> ChainState:
    """One SGRLD step of all C chains on its hoisted operands, batched
    over chains (the JAX ``_chunk`` body)."""
    (nodes, nmask, eu, ev, emask, w, nbrs, y_n, n_phi, n_beta, y_e, nm,
     lu, lv) = x
    n_rows, k = cfg.N, cfg.K
    b_cap = nodes.shape[-1]
    offsets = (torch.arange(c, dtype=torch.int32, device=nodes.device)
               * n_rows)[:, None]                               # [C, 1]
    flat_nodes = _chain_flat_ids(nodes, n_rows).reshape(-1)    # [C*B]
    flat_mask = nmask.reshape(-1)
    # JAX clamps the sentinel's gather to C*N - 1; torch faults
    gidx = flat_nodes.long().clamp(max=c * n_rows - 1)
    pi_n, phis = st.pi[gidx].float(), st.phi_sum[gidx]
    if cfg.shared_neighbors:
        pi_nb = st.pi[(nbrs + offsets).long()].float()         # [C, n, K]
        rows, sums = phi_ops.phi_update_core(
            cfg, pi_n.reshape(c, b_cap, k), phis.reshape(c, b_cap),
            pi_nb[:, None], y_n, st.beta[:, None, :], st.step_count,
            n_phi.reshape(c, b_cap, k), nm)
        rows, sums = rows.reshape(c * b_cap, k), sums.reshape(-1)
    else:
        flat_nbrs = (nbrs.reshape(c, b_cap, -1)
                     + offsets[:, :, None]).reshape(c * b_cap, -1)
        rows, sums = phi_ops.phi_update_core(
            cfg, pi_n, phis, st.pi[flat_nbrs.long()].float(),
            y_n.reshape(c * b_cap, -1),
            st.beta.repeat_interleave(b_cap, dim=0), st.step_count, n_phi)
    pi, phi_sum = phi_ops.scatter_rows(st.pi, st.phi_sum, flat_nodes,
                                       flat_mask, rows, sums)
    if cfg.shared_neighbors:
        # endpoint rows from the staged rows; masked node lanes may hold
        # garbage: select 1/K before the lane gathers (NaN * 0 != 0)
        rows_safe = torch.where(flat_mask[:, None], rows,
                                1.0 / k).reshape(c, b_cap, k)
        chain = torch.arange(c, device=nodes.device)[:, None]
        pi_u = rows_safe[chain, lu.long()]                      # [C, E, K]
        pi_v = rows_safe[chain, lv.long()]
    else:
        pi_u = pi[(eu + offsets).reshape(-1).long()].float().reshape(c, -1, k)
        pi_v = pi[(ev + offsets).reshape(-1).long()].float().reshape(c, -1, k)
    grads = _beta_gradients_chains(cfg, st.theta, st.beta, pi_u, pi_v, y_e,
                                   emask)
    beta_count = st.beta_count + 1
    theta, beta = beta_ops.theta_step(cfg, st.theta, grads, w[:, None, None],
                                      beta_count, n_beta)
    return st._replace(pi=pi, phi_sum=phi_sum, theta=theta, beta=beta,
                       step_count=st.step_count + 1, beta_count=beta_count)


# ---------------------------------------------------------------------------
# The windowed chain engine
# ---------------------------------------------------------------------------

class ChainWindows(NamedTuple):
    """W whole windows of C chains, every array chain-major [W, C, T, ...]
    (``at(w)`` is window w, the same fields without the W axis)."""

    nodes: torch.Tensor     # [W, C, T, B] flat ids, sentinel C*N
    xs_t: tuple             # the window's operand tuple, chain-local
    mcode: torch.Tensor     # [W, C, T, B+n] int32, chain-local slots
    keep: torch.Tensor      # [W, C, T, B] last-write-wins mask

    def at(self, w: int) -> "ChainWindows":
        return ChainWindows(self.nodes[w], index_operands(self.xs_t, w),
                            self.mcode[w], self.keep[w])


def chain_windows(cfg: Config, c: int, xs) -> ChainWindows:
    """The bookkeeping of whole windows of the hoisted chain steps ``xs``
    (a multiple of ``cfg.window`` steps, shared draws): flat ids, the
    correction codes of each chain against its own staged rows, the
    last-write-wins mask, and the operands moved chain-major so that
    each chain's window is one contiguous slice (what
    ``window_chain_apply_*`` take)."""
    (nodes, nmask, eu, ev, emask, wts, nbrs, y_n, n_phi, n_beta, y_e, _nm,
     lu, lv) = xs
    t_win, n_rows = cfg.window, cfg.N
    n_win = nodes.shape[0] // t_win

    def cm(a):
        # [W*T, C, ...] -> [W, C, T, ...]
        return a.reshape(n_win, t_win, c, *a.shape[2:]).transpose(
            1, 2).contiguous()

    nodes_f = cm(_chain_flat_ids(nodes, n_rows, axis=1))
    nbrs_f = cm(nbrs + (torch.arange(c, dtype=torch.int32,
                                     device=nodes.device) * n_rows)[:, None])
    mask = cm(nmask)
    batch = DeviceBatch(edges_u=cm(eu), edges_v=cm(ev), edge_mask=cm(emask),
                        nodes=cm(nodes), node_mask=mask, weight=cm(wts))
    xs_t = (batch, cm(nbrs)[..., None, :], cm(y_n),
            cm(n_phi.reshape(*nodes.shape, -1)), cm(n_beta), cm(y_e),
            cm(lu), cm(lv))
    return ChainWindows(
        nodes=nodes_f, xs_t=xs_t,
        mcode=_correction_codes(cfg, nodes_f, mask, nbrs_f),
        keep=_last_write_wins(nodes_f, mask, t_win))


def _chain_window(cfg: Config, state: ChainState,
                  win: ChainWindows) -> ChainState:
    """One window of every chain: one kernel launch on the card (gather,
    steps and scatter), the plain gather, steps and scatter on the CPU
    and with ``cfg.window_impl == "jnp"``."""
    apply = plain_or(cfg, state, window_chain_apply_cuda,
                     window_chain_apply_torch)
    return apply(cfg, state, win.xs_t, win.mcode, win.keep)


def windowed_chain_scan(cfg: Config, c: int, state: ChainState, xs,
                        body) -> ChainState:
    """Run the hoisted chain steps ``xs`` in windows of ``cfg.window``;
    the steps after the last whole window go through ``body``. The
    bookkeeping is computed for a batch of windows at once, fewer windows
    the more chains, so its memory stays that of one chain's batch."""
    t_win = cfg.window
    s_len = xs[0].shape[0]
    n_win = s_len // t_win
    per_batch = max(1, _WINDOWS_PER_BATCH // c)
    for w0 in range(0, n_win, per_batch):
        w1 = min(n_win, w0 + per_batch)
        wins = chain_windows(cfg, c, tuple(a[w0 * t_win:w1 * t_win]
                                           for a in xs))
        for w in range(w1 - w0):
            state = _chain_window(cfg, state, wins.at(w))
    for i in range(n_win * t_win, s_len):
        state = body(state, tuple(a[i] for a in xs))
    return state


def run_chain_hoisted(cfg: Config, c: int, state: ChainState,
                      xs) -> ChainState:
    """Run the hoisted chain steps ``xs`` from ``state`` (windowed when
    ``cfg.window > 1``; the learner's guard requires shared draws then)."""
    body = partial(_chain_step_body, cfg, c)
    if cfg.window > 1:
        return windowed_chain_scan(cfg, c, state, xs, body)
    for i in range(xs[0].shape[0]):
        state = body(state, tuple(a[i] for a in xs))
    return state


def chain_perplexity(cfg: Config, c: int, heldout_set, eu, ev,
                     state: ChainState):
    """Per-chain held-out perplexity over the shared held-out population:
    (state, -mean log running-averaged likelihood [C] on the device). The
    rows are gathered in blocks of pairs (``ppx_ops.blocked_likelihood``),
    so the transient memory is bounded whatever C x H x K is; on a card
    the evaluation kernel takes the C chains in one launch pair, each
    with its beta row (``ppx_ops.likelihood_cuda``)."""
    count = state.ppx_count + 1
    y = heldout_set.has_edges(eu, ev)                          # [H]
    if state.pi.is_cuda:
        res = ppx_ops.likelihood_cuda(cfg, state.pi, state.pi,
                                      state.beta.contiguous(), eu, ev,
                                      y[None, :], state.ppx_per_edge, count)
        return (state._replace(ppx_per_edge=res.ppx_per_edge,
                               ppx_count=count), res.neg_avg_log)
    lik = ppx_ops.blocked_likelihood(cfg, state.pi, state.beta[:, None, :],
                                     eu, ev, y[None, :], lead=c)  # [C, H]
    cnt = float(count)
    ppx_new = (state.ppx_per_edge * (cnt - 1.0) + lik) / cnt   # [C, H]
    neg_avg = -torch.mean(torch.log(ppx_new), dim=-1)          # [C]
    return state._replace(ppx_per_edge=ppx_new, ppx_count=count), neg_avg


# ---------------------------------------------------------------------------
# Orchestration
# ---------------------------------------------------------------------------

class FlatChainLearner(Learner):
    """C chains in one flat row space, on ``Learner``'s surface (``run``,
    ``run_with_ppx``, ``heldout_perplexity``, ``print_stats``) with a [C]
    perplexity per evaluation, and ``beta_rhat``. ``init_seconds`` is the
    time of the per-chain init draws, the device's included."""

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

    def print_stage_profile(self, log=print, iters=None) -> None:
        """The traced per-stage table of the chain loop; no unfused
        fallback (the JAX chain engine has none)."""
        from mcmc_ammsb_tpu_torch.utils import profiling

        prof = self.fused_stage_profile(iters)
        if prof["source"] == "none" or prof["total_op_seconds"] <= 0:
            log("trace captured no attributable device ops")
            return
        profiling.format_stage_table(prof, prof["steps"], log)

    @staticmethod
    def _check(cfg: Config) -> None:
        """The JAX FlatChainLearner's guards (chains_flat.py:486-501)."""
        if cfg.rng_backend != RngBackend.NATIVE:
            raise ValueError("FlatChainLearner supports the native RNG "
                             "backend only (per-thread reference streams "
                             "are single-chain semantics)")
        if cfg.phi_impl != PhiImpl.JNP:
            raise ValueError("FlatChainLearner supports phi_impl=jnp only")
        if cfg.pi_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown pi_dtype {cfg.pi_dtype!r}")
        if cfg.window > 1 and not cfg.shared_neighbors:
            raise ValueError("window > 1 on the chain engine requires "
                             "shared_neighbors (the window kernel "
                             "operates on the shared-draw layout)")

    def _init_state(self, heldout_size: int) -> ChainState:
        t0 = time.perf_counter()
        state = init_chain_state(self.cfg, self.num_chains, heldout_size,
                                 self.device)
        self._sync()
        self.init_seconds = time.perf_counter() - t0
        return state

    def _train_chunk(self, state, num_steps: int):
        xs = hoist_chain_operands(self.cfg, self.num_chains,
                                  self.training_set, self.heldout_set,
                                  self.adjacency, self.streams, num_steps)
        return run_chain_hoisted(self.cfg, self.num_chains, state, xs)

    def _evaluate(self, state):
        return chain_perplexity(self.cfg, self.num_chains, self.heldout_set,
                                self.heldout_u, self.heldout_v, state)

    @staticmethod
    def _read_stats(neg_avg) -> dict:
        return {"ppx": np.exp(neg_avg.cpu().numpy())}

    def beta_rhat(self, draws: int = 10) -> np.ndarray:
        """Gelman-Rubin PSRF [K] over beta across the chains (chains.rhat):
        ``draws`` more chunks of steps_per_call steps, beta kept after
        each."""
        return beta_rhat_series(self, draws)
