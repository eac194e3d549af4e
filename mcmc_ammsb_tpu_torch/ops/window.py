"""T-step windowed training loop (counterpart of
``mcmc_ammsb_tpu/ops/window.py``).

Each window of T steps is

  1. ONE bulk gather of all T steps' pi rows ([T*(B+n)] indices);
  2. the T sequential phi/beta/theta updates — on a CUDA tensor one
     launch of the hand-written Hopper kernel ``csrc/window_kernel.cu``
     (``window_core_cuda``), on a CPU tensor the plain PyTorch version
     ``window_core_torch``;
  3. ONE last-write-wins scatter of the T*B staged rows.

A step may read a row that an earlier step of the same window wrote.
``_correction_codes`` gives every read lane the staged slot of the
latest such write, and both cores redirect the read there, so the
trajectory is the sequential scan's up to float reduction order. Only
the JAX package's default ``window_correction="always"`` is ported.

The flat chain engine (``chains_flat``) runs the windows of C chains
through ``window_chain_core_cuda`` (the same kernel, one thread block
per chain) and its plain version ``window_chain_core_torch``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from mcmc_ammsb_tpu_torch import kernels
from mcmc_ammsb_tpu_torch.config import Config
from mcmc_ammsb_tpu_torch.ops import beta as beta_ops
from mcmc_ammsb_tpu_torch.ops import phi as phi_ops


#: Windows whose correction codes are computed in one batch.
_WINDOWS_PER_BATCH = 64


def index_operands(xs, idx):
    """Index every array of the hoisted operand tuple (its first entry
    is the DeviceBatch of per-step minibatches)."""
    batch = type(xs[0])(*(a[idx] for a in xs[0]))
    return (batch, *(a[idx] for a in xs[1:]))


def iter_windows(cfg: Config, xs, nbrs):
    """Yield ``(xs_t, mcode, keep)`` for each whole window of
    ``cfg.window`` steps of the hoisted operands ``xs``: the window's
    operands, its correction codes [T, B+n] and its last-write-wins mask
    [T, B]. ``nbrs`` [S, n] are the steps' shared neighbor draws. The
    steps after the last whole window are the caller's."""
    t_win = cfg.window
    n_win = nbrs.shape[0] // t_win
    for w in range(n_win):
        if w % _WINDOWS_PER_BATCH == 0:
            # the correction codes and the last-write-wins masks depend
            # on the minibatches only: computed for a batch of windows
            # at once (bounded, the codes take ~1.5 MB per window at
            # the bench shape)
            w_end = min(n_win, w + _WINDOWS_PER_BATCH)
            steps = slice(w * t_win, w_end * t_win)
            nodes = xs[0].nodes[steps].reshape(w_end - w, t_win, -1)
            mask = xs[0].node_mask[steps].reshape(w_end - w, t_win, -1)
            nbrs_w = nbrs[steps].reshape(w_end - w, t_win, -1)
            mcodes = _correction_codes(cfg, nodes, mask, nbrs_w)
            keeps = _last_write_wins(nodes, mask, t_win)
        yield (index_operands(xs, slice(w * t_win, (w + 1) * t_win)),
               mcodes[w % _WINDOWS_PER_BATCH], keeps[w % _WINDOWS_PER_BATCH])


def windowed_scan(cfg: Config, state, xs, body):
    """Run the hoisted steps ``xs`` in windows of ``cfg.window``; the
    steps left over at the end go through ``body(state, x) -> state``.

    ``xs`` is the operand tuple of ``learner.hoist_operands``:
    (batches, neighbors [S,1,n], y_phi, phi_noise, beta_noise,
     y_edges, lanes_u, lanes_v)."""
    t_win = cfg.window
    for xs_t, mcode, keep in iter_windows(cfg, xs, xs[1][:, 0, :]):
        batch = xs_t[0]
        g, sums_g = _window_gather(cfg, state, batch, xs_t[1][:, 0, :])
        core = window_core_cuda if g.is_cuda else window_core_torch
        rows_flat, sums_flat, theta, beta = core(cfg, state, xs_t, g,
                                                 sums_g, mcode)
        pi, phi_sum = _window_scatter(cfg, state, batch, keep, rows_flat,
                                      sums_flat)
        state = state._replace(pi=pi, phi_sum=phi_sum, theta=theta,
                               beta=beta,
                               step_count=state.step_count + t_win,
                               beta_count=state.beta_count + t_win)
    s_len = xs[1].shape[0]
    for i in range(s_len - s_len % t_win, s_len):
        state = body(state, index_operands(xs, i))
    return state


def _last_write_wins(nodes, mask, t_win):
    """[..., T, B] bool: valid writes NOT superseded by a later step's
    write of the same row, so the scatter applies exactly the last write
    and its indices are unique. Leading axes batch windows."""
    wf = torch.where(mask, nodes, -2)                        # [..., T, B]
    eqw = (wf[..., :, :, None, None]
           == wf[..., None, None, :, :])                     # [...,T,B,T,B]
    t_r = torch.arange(t_win, device=nodes.device)
    later = t_r[None, None, :, None] > t_r[:, None, None, None]
    superseded = (eqw & later
                  & mask[..., None, None, :, :]).flatten(-2).any(-1)
    return mask & ~superseded


def _correction_codes(cfg: Config, nodes, mask, nbrs):
    """[..., T, B+n] int32: 1 + the staged slot (t*B + lane) of the
    LATEST earlier-step write of the row that read lane (t, i)
    references; 0 when the pre-window gather is current. Leading axes
    batch windows."""
    t_win, b_cap = nodes.shape[-2:]
    dev = nodes.device
    lin = torch.arange(t_win * b_cap, dtype=torch.int32, device=dev)
    writes_flat = torch.where(mask, nodes, -2).flatten(-2)   # [..., T*B]
    reads = torch.cat([nodes, nbrs], dim=-1)                 # [..., T, B+n]
    eq = (reads[..., :, :, None]
          == writes_flat[..., None, None, :])                # [...,T,B+n,T*B]
    earlier = ((lin[None, None, :] // b_cap)
               < torch.arange(t_win, device=dev)[:, None, None])
    codes = torch.where(eq & earlier, lin + 1, 0)
    return codes.max(dim=-1).values.to(torch.int32)


def _window_gather(cfg: Config, s, batch, nbrs):
    """Bulk read of the window's rows: g [T, B+n, K] f32, sums [T, B].

    Padded node lanes carry the sentinel N. JAX clamps that gather
    index to N-1; torch faults, so it is clamped here explicitly and
    padded lanes stay finite, as in the JAX package."""
    t_win, b_cap = batch.nodes.shape
    read_idx = torch.cat([batch.nodes, nbrs], dim=1).long().clamp(
        max=cfg.N - 1)
    g = s.pi[read_idx.reshape(-1)].float().reshape(t_win, -1, cfg.K)
    sums_g = s.phi_sum[batch.nodes.reshape(-1).long().clamp(
        max=cfg.N - 1)].reshape(t_win, b_cap)
    return g, sums_g


def _window_scatter(cfg: Config, s, batch, keep, rows_flat, sums_flat):
    """In-place write-back of the staged rows that ``keep`` selects
    (unique rows, by _last_write_wins), without a host sync: see
    phi.scatter_rows."""
    return phi_ops.scatter_rows(s.pi, s.phi_sum, batch.nodes.reshape(-1),
                                keep.reshape(-1), rows_flat, sums_flat)


# ---------------------------------------------------------------------------
# Window core: the plain PyTorch version
# ---------------------------------------------------------------------------

def window_core_torch(cfg: Config, s, xs_t, g, sums_g, mcode):
    """T sequential steps on the gathered rows with the stock torch ops.
    A read lane with ``mcode > 0`` reads staged row ``mcode - 1``; edge
    endpoints read the step's staged rows through the lane maps, masked
    node lanes replaced by 1/K first. These indexed loads are exactly
    the JAX package's 0/1 one-hot products. Returns (rows_flat [T*B, K],
    sums_flat [T*B], theta [K, 2], beta [K])."""
    batch, nbrs_s, y_w, nphi_w, nbeta_w, ye_w, lu, lv = xs_t
    t_win, _, k = g.shape
    b_cap = batch.nodes.shape[1]
    nbrs = nbrs_s[:, 0, :]
    theta, beta = s.theta, s.beta
    rows_buf = g.new_zeros(t_win * b_cap, k)
    sums_buf = g.new_zeros(t_win * b_cap)
    for t in range(t_win):
        staged = mcode[t] > 0                               # [B+n]
        slot = (mcode[t].long() - 1).clamp(min=0)
        g_corr = torch.where(staged[:, None], rows_buf[slot], g[t])
        phis = torch.where(staged[:b_cap], sums_buf[slot[:b_cap]],
                           sums_g[t])
        nbr_mask = nbrs[t][None, :] != batch.nodes[t][:, None]
        rows, sums = phi_ops.phi_update_core(
            cfg, g_corr[:b_cap], phis, g_corr[b_cap:][None], y_w[t], beta,
            s.step_count + t, nphi_w[t], nbr_mask)
        rows_buf[t * b_cap:(t + 1) * b_cap] = rows
        sums_buf[t * b_cap:(t + 1) * b_cap] = sums
        rows_safe = torch.where(batch.node_mask[t][:, None], rows, 1.0 / k)
        grads = beta_ops.beta_gradients_core(
            cfg, theta, beta, rows_safe[lu[t].long()],
            rows_safe[lv[t].long()], ye_w[t], batch.edge_mask[t])
        theta, beta = beta_ops.theta_step(
            cfg, theta, grads, batch.weight[t], s.beta_count + 1 + t,
            nbeta_w[t])
    return rows_buf, sums_buf, theta, beta


def window_chain_core_torch(cfg: Config, s, xs_t, g, sums_g, mcode):
    """C independent chains' windows: ``window_core_torch`` on each
    chain's slice with its own theta, beta and weights; the step counters
    are shared. Every operand carries a leading chain axis (chain-major:
    g [C, T, B+n, K], sums_g [C, T, B], mcode [C, T, B+n] with chain-local
    slots, the tuple's arrays [C, T, ...]); ``s.theta`` is [C, K, 2],
    ``s.beta`` [C, K]. Returns (rows [C*T*B, K] chain-major, sums
    [C*T*B], theta [C, K, 2], beta [C, K])."""
    outs = [window_core_torch(cfg, s._replace(theta=s.theta[c],
                                              beta=s.beta[c]),
                              index_operands(xs_t, c), g[c], sums_g[c],
                              mcode[c])
            for c in range(g.shape[0])]
    rows, sums, theta, beta = zip(*outs)
    return (torch.cat(rows), torch.cat(sums), torch.stack(theta),
            torch.stack(beta))


# ---------------------------------------------------------------------------
# Window core: the Hopper kernel
# ---------------------------------------------------------------------------

#: kMaxNeighbors of csrc/window_kernel.cu: the contrib loop keeps a
#: thread's column of the n neighbor rows in registers.
MAX_NEIGHBORS = 32
#: kMaxWindow of csrc/window_kernel.cu: the step sizes of a window
#: travel in the kernel's parameters.
MAX_WINDOW = 64

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.cache
def _window_lib():
    lib = kernels.load("window_kernel")
    lib.window_kernel_smem_bytes.argtypes = [_I, _I, _I, _I]
    lib.window_kernel_smem_bytes.restype = ctypes.c_size_t
    lib.window_kernel_launch.argtypes = ([_P] * 20 + [_I] * 6 + [_F] * 7
                                         + [_P] * 3)
    lib.window_kernel_launch.restype = _I
    return lib


def _step_sizes(cfg: Config, first: int, t_win: int) -> np.ndarray:
    """eps_t = a (1 + t/b)^(-c) of steps first .. first+T-1, on the host
    in float32 arithmetic like the plain version's int32 -> float32 path
    (phi.step_size); the kernel takes them as parameters."""
    f32 = np.float32
    t = np.arange(first, first + t_win).astype(f32)
    return np.ascontiguousarray(
        f32(cfg.a) * (f32(1.0) + t / f32(cfg.b)) ** f32(-cfg.c), f32)


def _launch(cfg: Config, s, xs_t, g, sums_g, mcode, chained: bool):
    """One launch of ``csrc/window_kernel.cu``: one block, or with
    ``chained`` one block per chain, every operand and ``s.theta``/
    ``s.beta`` then carrying a leading chain axis, chain-major as
    ``window_chain_core_torch`` takes them; the step sizes are shared."""
    batch, nbrs_s, y_w, nphi_w, nbeta_w, ye_w, lu, lv = xs_t
    if not g.is_cuda:
        raise ValueError("the window kernel's wrappers take CUDA tensors")
    t_win, n_read, k = g.shape[-3:]
    b_cap = batch.nodes.shape[-1]
    n_smpl = n_read - b_cap
    e_cap = ye_w.shape[-1]
    lead = tuple(g.shape[:-3])
    if (len(lead) != int(chained) or tuple(s.theta.shape) != (*lead, k, 2)
            or tuple(s.beta.shape) != (*lead, k)):
        raise ValueError(
            f"window kernel operands for {'C' if chained else 'one'} "
            f"chain(s): g {tuple(g.shape)}, theta "
            f"{tuple(s.theta.shape)}, beta {tuple(s.beta.shape)}")
    n_chains = lead[0] if chained else 1
    if n_smpl > MAX_NEIGHBORS or t_win > MAX_WINDOW:
        raise ValueError(
            f"window kernel takes n <= {MAX_NEIGHBORS} neighbors and "
            f"windows of <= {MAX_WINDOW} steps, got n={n_smpl}, "
            f"T={t_win}; use a smaller --window or --window -1")
    lib = _window_lib()
    smem = lib.window_kernel_smem_bytes(b_cap, n_smpl, e_cap, k)
    limit = kernels.smem_limit(g.device)
    if smem > limit:
        raise ValueError(
            f"window kernel needs {smem} B of shared memory at B={b_cap}, "
            f"n={n_smpl}, E={e_cap}, K={k}; the card gives a block "
            f"{limit} B. Use a smaller K or --window -1.")

    def arg(x, dtype):
        return kernels.pointer(x, dtype, g.device)

    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    ptrs = [arg(g, f32), arg(sums_g, f32), arg(y_w, b8),
            arg(batch.nodes, i32), arg(nbrs_s[..., 0, :], i32),
            arg(batch.node_mask, b8), arg(nphi_w, f32), arg(nbeta_w, f32),
            arg(ye_w, b8), arg(batch.edge_mask, b8), arg(lu, i32),
            arg(lv, i32), arg(mcode, i32), arg(batch.weight, f32),
            arg(s.theta, f32), arg(s.beta, f32)]
    rows = torch.empty(n_chains * t_win * b_cap, k, device=g.device)
    sums = torch.empty(n_chains * t_win * b_cap, device=g.device)
    theta = torch.empty_like(s.theta)
    beta = torch.empty_like(s.beta)
    eps_phi = _step_sizes(cfg, s.step_count, t_win)
    eps_theta = _step_sizes(cfg, s.beta_count + 1, t_win)
    err = lib.window_kernel_launch(
        *ptrs, *(t.data_ptr() for t in (rows, sums, theta, beta)),
        n_chains, t_win, b_cap, n_smpl, e_cap, k,
        cfg.epsilon, 1.0 - cfg.epsilon, cfg.alpha_value, float(cfg.N),
        cfg.eta0, cfg.eta1, 1.0 / k, eps_phi.ctypes.data,
        eps_theta.ctypes.data,
        torch.cuda.current_stream(g.device).cuda_stream)
    kernels.check_launch(err, "window kernel")
    return rows, sums, theta, beta


def window_core_cuda(cfg: Config, s, xs_t, g, sums_g, mcode):
    """The same T steps as ``window_core_torch`` in one launch of
    ``csrc/window_kernel.cu`` with one block: the JAX kernel with
    ``n_chains = 1``. CUDA tensors only: the kernel is launched or this
    raises — there is no fallback."""
    out = _launch(cfg, s, xs_t, g, sums_g, mcode, chained=False)
    window_core_cuda.launches += 1
    return out


#: Launches of the window kernel in this process (reset by callers that
#: check a run went through it).
window_core_cuda.launches = 0


def window_chain_core_cuda(cfg: Config, s, xs_t, g, sums_g, mcode):
    """The same C chains' windows as ``window_chain_core_torch`` in one
    launch of ``csrc/window_kernel.cu`` with one block per chain (the
    JAX kernel's blocked ``n_chains = C`` mode; g [C, T, B+n, K], C >= 1).
    CUDA tensors only: the kernel is launched or this raises."""
    out = _launch(cfg, s, xs_t, g, sums_g, mcode, chained=True)
    window_chain_core_cuda.launches += 1
    window_chain_core_cuda.chains += g.shape[0]
    return out


#: Launches of the chain entry, and the chains they ran in all.
window_chain_core_cuda.launches = 0
window_chain_core_cuda.chains = 0
