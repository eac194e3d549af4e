"""T-step windowed loop of the full MMSB (counterpart of
``mcmc_ammsb_tpu/ops/window_mmsb.py``).

The structure of ``ops/window.py``, single chain: each window of T steps
is one bulk gather of the window's pi rows, the T sequential full-MMSB
steps, one last-write-wins scatter; reads of rows that an earlier step of
the window wrote are redirected to the staged rows through the same
correction codes. The T steps run, on a CUDA tensor, in one launch of the
hand-written Hopper kernel ``csrc/mmsb_window_kernel.cu``
(``mmsb_window_core_cuda``), on a CPU tensor through the plain PyTorch
version ``mmsb_window_core_torch``.

Whether the kernel fits a card is a shared-memory rule
(``window_fits``), which replaces the JAX package's TPU VMEM envelope
(``mmsb_window_working_set_bytes`` / ``mmsb_max_safe_window``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from mcmc_ammsb_tpu_torch import kernels
from mcmc_ammsb_tpu_torch.config import Config
from mcmc_ammsb_tpu_torch.models import mmsb as model
from mcmc_ammsb_tpu_torch.ops.window import (MAX_WINDOW, _step_sizes,
                                             _window_gather, _window_scatter,
                                             index_operands, iter_windows)


def mmsb_windowed_scan(cfg: Config, state, xs, body):
    """Run the hoisted MMSB steps ``xs`` (``models/mmsb.
    mmsb_hoist_operands``, shared draws [S, n]) in windows of
    ``cfg.window``; the steps after the last whole window go through
    ``body(state, x) -> state``."""
    t_win = cfg.window
    for xs_t, mcode, keep in iter_windows(cfg, xs, xs[1]):
        batch = xs_t[0]
        g, sums_g = _window_gather(cfg, state, batch, xs_t[1])
        core = mmsb_window_core_cuda if g.is_cuda else mmsb_window_core_torch
        rows_flat, sums_flat, theta_b = core(cfg, state, xs_t, g, sums_g,
                                             mcode)
        pi, phi_sum = _window_scatter(cfg, state, batch, keep, rows_flat,
                                      sums_flat)
        state = state._replace(pi=pi, phi_sum=phi_sum, theta_b=theta_b,
                               b=theta_b[..., 1] / theta_b.sum(-1),
                               step_count=state.step_count + t_win,
                               theta_count=state.theta_count + t_win)
    s_len = xs[1].shape[0]
    for i in range(s_len - s_len % t_win, s_len):
        state = body(state, index_operands(xs, i))
    return state


# ---------------------------------------------------------------------------
# Window core: the plain PyTorch version
# ---------------------------------------------------------------------------

def mmsb_window_core_torch(cfg: Config, s, xs_t, g, sums_g, mcode):
    """T sequential steps on the gathered rows with the stock torch ops:
    the JAX kernel body (window_mmsb.py:130-236) with indexed loads for
    its one-hot products. A read lane with ``mcode > 0`` reads staged row
    ``mcode - 1``; edge endpoints read the step's staged rows through the
    lane maps, masked node lanes replaced by 1/K first. Returns
    (rows_flat [T*B, K], sums_flat [T*B], theta_b [K, K, 2])."""
    batch, nbrs, y_w, nphi_w, tn_w, ye_w, lu, lv = xs_t
    t_win, _, k = g.shape
    b_cap = batch.nodes.shape[1]
    theta = s.theta_b
    rows_buf = g.new_zeros(t_win * b_cap, k)
    sums_buf = g.new_zeros(t_win * b_cap)
    for t in range(t_win):
        staged = mcode[t] > 0                               # [B+n]
        slot = (mcode[t].long() - 1).clamp(min=0)
        g_corr = torch.where(staged[:, None], rows_buf[slot], g[t])
        phis = torch.where(staged[:b_cap], sums_buf[slot[:b_cap]],
                           sums_g[t])
        b_mat = theta[..., 1] / (theta[..., 0] + theta[..., 1])
        nbr_mask = nbrs[t][None, :] != batch.nodes[t][:, None]
        rows, sums = model._phi_rows_core_shared(
            cfg, g_corr[:b_cap], phis, b_mat, g_corr[b_cap:], y_w[t],
            nbr_mask, s.step_count + t, nphi_w[t])
        rows_buf[t * b_cap:(t + 1) * b_cap] = rows
        sums_buf[t * b_cap:(t + 1) * b_cap] = sums
        rows_safe = torch.where(batch.node_mask[t][:, None], rows, 1.0 / k)
        grads = model._theta_grads_core(
            cfg, theta, b_mat, rows_safe[lu[t].long()],
            rows_safe[lv[t].long()], ye_w[t], batch.edge_mask[t])
        theta, _ = model.mmsb_theta_step(cfg, theta, grads, batch.weight[t],
                                         s.theta_count + 1 + t, tn_w[t])
    return rows_buf, sums_buf, theta


# ---------------------------------------------------------------------------
# Window core: the Hopper kernel
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.cache
def _mmsb_lib():
    lib = kernels.load("mmsb_window_kernel")
    lib.mmsb_window_smem_bytes.argtypes = [_I, _I, _I, _I]
    lib.mmsb_window_smem_bytes.restype = ctypes.c_size_t
    lib.mmsb_window_launch.argtypes = ([_P] * 18 + [_I] * 5 + [_F] * 7
                                       + [_P] * 3)
    lib.mmsb_window_launch.restype = _I
    return lib


def window_fits(cfg: Config, device):
    """(fits, reason): whether the window kernel can run ``cfg``'s
    windows on ``device``: T <= MAX_WINDOW (the step sizes travel in the
    kernel's parameters) and its shared memory within the card's limit
    per block: B [K, K] and the B + n read rows in float32, the 2n phi
    products in float64, at an odd row stride, and the step's small
    operands (csrc/mmsb_window_kernel.cu smem_words)."""
    smem = _mmsb_lib().mmsb_window_smem_bytes(
        cfg.max_batch_nodes, cfg.num_node_sample, cfg.max_batch_edges,
        cfg.K)
    limit = kernels.smem_limit(device)
    why = (f"T={cfg.window} (at most {MAX_WINDOW}), shared memory "
           f"{smem} B at B={cfg.max_batch_nodes}, n={cfg.num_node_sample},"
           f" E={cfg.max_batch_edges}, K={cfg.K}; the card gives a block "
           f"{limit} B")
    return cfg.window <= MAX_WINDOW and smem <= limit, why


def mmsb_window_core_cuda(cfg: Config, s, xs_t, g, sums_g, mcode):
    """The same T steps as ``mmsb_window_core_torch`` in one launch of
    ``csrc/mmsb_window_kernel.cu``. CUDA tensors only: the kernel is
    launched or this raises — there is no fallback."""
    batch, nbrs, y_w, nphi_w, tn_w, ye_w, lu, lv = xs_t
    if not g.is_cuda:
        raise ValueError("mmsb_window_core_cuda takes CUDA tensors")
    t_win, n_read, k = g.shape
    b_cap = batch.nodes.shape[1]
    n_smpl = n_read - b_cap
    e_cap = ye_w.shape[1]
    lib = _mmsb_lib()
    smem = lib.mmsb_window_smem_bytes(b_cap, n_smpl, e_cap, k)
    limit = kernels.smem_limit(g.device)
    if t_win > MAX_WINDOW or smem > limit:
        raise ValueError(
            f"MMSB window kernel takes T <= {MAX_WINDOW} and {limit} B of "
            f"shared memory; T={t_win}, B={b_cap}, n={n_smpl}, E={e_cap}, "
            f"K={k} need {smem} B. Use a smaller --window or K.")

    def arg(x, dtype):
        return kernels.pointer(x, dtype, g.device)

    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    ptrs = [arg(g, f32), arg(sums_g, f32), arg(y_w, b8),
            arg(batch.nodes, i32), arg(nbrs, i32), arg(batch.node_mask, b8),
            arg(nphi_w, f32), arg(tn_w, f32), arg(ye_w, b8),
            arg(batch.edge_mask, b8), arg(lu, i32), arg(lv, i32),
            arg(mcode, i32), arg(batch.weight, f32), arg(s.theta_b, f32)]
    rows = torch.empty(t_win * b_cap, k, device=g.device)
    sums = torch.empty(t_win * b_cap, device=g.device)
    theta = torch.empty(k, k, 2, device=g.device)
    # the prior of the diagonal cells: mmsb_prior_diag, a scalar or an
    # (eta0, eta1) pair (models/mmsb.mmsb_eta)
    diag = np.broadcast_to(np.asarray(
        (cfg.eta0, cfg.eta1) if cfg.mmsb_prior_diag is None
        else cfg.mmsb_prior_diag, np.float64), (2,))
    eps_phi = _step_sizes(cfg, s.step_count, t_win)
    eps_theta = _step_sizes(cfg, s.theta_count + 1, t_win)
    err = lib.mmsb_window_launch(
        *ptrs, rows.data_ptr(), sums.data_ptr(), theta.data_ptr(),
        t_win, b_cap, n_smpl, e_cap, k,
        cfg.alpha_value, float(cfg.N), 1.0 / k, cfg.eta0, cfg.eta1,
        float(diag[0]), float(diag[1]),
        eps_phi.ctypes.data, eps_theta.ctypes.data,
        torch.cuda.current_stream(g.device).cuda_stream)
    kernels.check_launch(err, "MMSB window kernel")
    mmsb_window_core_cuda.launches += 1
    return rows, sums, theta


#: Launches of the MMSB window kernel in this process (reset by callers
#: that check a run went through it).
mmsb_window_core_cuda.launches = 0
