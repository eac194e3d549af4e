"""T-step windowed loop of the full MMSB (counterpart of
``mcmc_ammsb_tpu/ops/window_mmsb.py``).

The structure of ``ops/window.py``, single chain: each window of T steps
is one bulk gather of the window's pi rows, the T sequential full-MMSB
steps, one last-write-wins scatter; reads of rows that an earlier step of
the window wrote are redirected to the staged rows through the same
correction codes. On a CUDA tensor the three are ONE launch of the
hand-written Hopper kernel ``csrc/mmsb_window_kernel.cu``
(``mmsb_window_apply_cuda``): it reads its rows from pi by index, runs the
steps on a thread-block cluster whose CTAs own slices of the rows of B
and theta (``mmsb_window_cluster_size``), and writes the surviving rows
back itself. On a CPU tensor the plain PyTorch version
``mmsb_window_apply_torch`` runs them as ``_window_gather``,
``mmsb_window_core_torch`` and ``_window_scatter``.

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
from mcmc_ammsb_tpu_torch.ops.window import (H100_SMEM, MAX_CLUSTER,
                                             MAX_WINDOW, _step_sizes,
                                             _window_gather, _window_scatter,
                                             index_operands, iter_windows,
                                             window_slice_width)


def mmsb_windowed_scan(cfg: Config, state, xs, body):
    """Run the hoisted MMSB steps ``xs`` (``models/mmsb.
    mmsb_hoist_operands``, shared draws [S, n]) in windows of
    ``cfg.window``; the steps after the last whole window go through
    ``body(state, x) -> state``."""
    apply = (mmsb_window_apply_cuda if state.pi.is_cuda
             else mmsb_window_apply_torch)
    for xs_t, mcode, keep in iter_windows(cfg, xs, xs[1]):
        state = apply(cfg, state, xs_t, mcode, keep)
    s_len = xs[1].shape[0]
    for i in range(s_len - s_len % cfg.window, s_len):
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


def _advance(s, t_win: int, theta_b):
    """``s`` after one window: the new theta and B, the counters by T."""
    return s._replace(theta_b=theta_b, b=theta_b[..., 1] / theta_b.sum(-1),
                      step_count=s.step_count + t_win,
                      theta_count=s.theta_count + t_win)


def mmsb_window_apply_torch(cfg: Config, s, xs_t, mcode, keep):
    """One whole window with the stock torch ops: ``_window_gather``,
    ``mmsb_window_core_torch``, ``_window_scatter`` (JAX's gather, kernel
    and scatter). ``s.pi`` and ``s.phi_sum`` are updated in place;
    returns the state after the window."""
    batch = xs_t[0]
    g, sums_g = _window_gather(cfg, s, batch, xs_t[1])
    rows, sums, theta_b = mmsb_window_core_torch(cfg, s, xs_t, g, sums_g,
                                                 mcode)
    pi, phi_sum = _window_scatter(cfg, s, batch, keep, rows, sums)
    return _advance(s._replace(pi=pi, phi_sum=phi_sum), batch.nodes.shape[0],
                    theta_b)


# ---------------------------------------------------------------------------
# The window: the Hopper kernel
# ---------------------------------------------------------------------------

#: The K split aims at about this many rows of B and theta per CTA: a
#: cluster of 16 from K = 64 (scripts/window_phases.py sweeps S; PERF.md
#: gives the times).
_ROWS_PER_CTA = 4
#: Static shared memory of the kernel (its layout's offsets, 112 B by
#: ptxas), which the dynamic part must leave room for.
_STATIC_SMEM = 128


def mmsb_window_smem_bytes(t_win: int, b_cap: int, n_smpl: int, e_cap: int,
                           k: int, s: int) -> int:
    """Shared memory per CTA with a cluster of ``s`` (``layout`` of
    csrc/mmsb_window_kernel.cu). In double: g_link [w, n] (also the p_e
    terms [E, w]), w [n, B], the p partials of the owned nodes [S,
    ceil(B/S), n], the neighbor row sums [n], the row-sum and p_e
    partials [S, B] and [S, E], mask / p_e by label [2, E]. In float, at the full row
    stride ld: the neighbor rows [n, ld], the new rows [B, ld], the owned
    rows of B [w, ld]; the owned columns of the node rows and of the phi
    noise [B, w] each, the owned rows of the theta noise and of theta
    [w, K, 2] each, the staged slice [T*B, w] and its sums [T*B], the phi
    sums [B], the valid-neighbor counts [T*B]. The window's codes, ids and
    lane maps, its labels and masks as bits."""
    w = window_slice_width(k, s)
    q4 = -(-k // 4)
    ld = 4 * (q4 + 1 + q4 % 2)
    nl = -(-b_cap // s)
    tb, te = t_win * b_cap, t_win * e_cap
    doubles = 2 * (max(n_smpl, e_cap) * w + b_cap * n_smpl
                   + s * nl * n_smpl + n_smpl + s * b_cap + s * e_cap
                   + 2 * e_cap)
    floats = ((n_smpl + b_cap + w) * ld + 2 * b_cap * w + 4 * w * k
              + tb * (w + 2) + b_cap)
    bits = -(-tb * n_smpl // 32) + -(-tb // 32) + 2 * -(-te // 32)
    ints = t_win * (2 * b_cap + 2 * n_smpl + e_cap) + bits
    return 4 * (-(-doubles // 4) * 4 + floats + ints)


@functools.lru_cache(maxsize=None)
def mmsb_window_cluster_size(t_win: int, b_cap: int, n_smpl: int,
                             e_cap: int, k: int,
                             smem_limit: int = H100_SMEM) -> int:
    """The cluster size S of an MMSB window: the first of the powers of
    two from s0 = min(16, ceil(K / 4)) up to 16, then of the other S <=
    16 nearest to s0, whose slices of K are all non-empty and whose
    per-CTA shared memory (with the kernel's static part) fits
    ``smem_limit``. Raises, naming the shape, when none does."""
    s0 = min(MAX_CLUSTER, max(1, -(-k // _ROWS_PER_CTA)))
    pow2 = [s for s in (1, 2, 4, 8, 16) if s >= s0]
    rest = sorted((s for s in range(1, MAX_CLUSTER + 1) if s not in pow2),
                  key=lambda s: (abs(s - s0), s))
    for s in pow2 + rest:
        if s > k or (s - 1) * window_slice_width(k, s) >= k:
            continue
        if (mmsb_window_smem_bytes(t_win, b_cap, n_smpl, e_cap, k, s)
                + _STATIC_SMEM <= smem_limit):
            return s
    raise ValueError(
        f"MMSB window kernel: (T, B, n, E, K) = ({t_win}, {b_cap}, "
        f"{n_smpl}, {e_cap}, {k}) fits {smem_limit} B of shared memory per "
        f"CTA at no cluster size <= {MAX_CLUSTER}; use a smaller --window "
        f"or K")


def window_fits(cfg: Config, device):
    """(fits, reason): whether the window kernel can run ``cfg``'s
    windows on ``device``: T <= MAX_WINDOW (the step sizes travel in the
    kernel's parameters) and some cluster size fits the card's shared
    memory per block (``mmsb_window_cluster_size``)."""
    shape = (cfg.window, cfg.max_batch_nodes, cfg.num_node_sample,
             cfg.max_batch_edges, cfg.K)
    limit = kernels.smem_limit(device)
    try:
        s = mmsb_window_cluster_size(*shape, limit)
    except ValueError as err:
        return False, str(err)
    if cfg.window > MAX_WINDOW:
        return False, f"T={cfg.window}: the kernel takes at most {MAX_WINDOW}"
    return True, (f"(T, B, n, E, K) = {shape}: a cluster of {s} CTAs, "
                  f"{mmsb_window_smem_bytes(*shape, s)} B of shared memory "
                  f"per CTA; the card gives a block {limit} B")


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def bind_mmsb_lib(lib):
    """Declare the C interface of a build of csrc/mmsb_window_kernel.cu."""
    lib.mmsb_window_smem_bytes.argtypes = [_I] * 6
    lib.mmsb_window_smem_bytes.restype = ctypes.c_size_t
    lib.mmsb_window_launch.argtypes = ([_P] * 17 + [_I] * 7 + [_F] * 7
                                       + [_P] * 3)
    lib.mmsb_window_launch.restype = _I
    return lib


@functools.cache
def _mmsb_lib():
    return bind_mmsb_lib(kernels.load("mmsb_window_kernel"))


def mmsb_window_apply_cuda(cfg: Config, s, xs_t, mcode, keep):
    """The same window as ``mmsb_window_apply_torch`` in ONE launch of
    ``csrc/mmsb_window_kernel.cu`` (one cluster): the kernel reads its rows
    from ``s.pi``/``s.phi_sum`` by index and writes the rows ``keep``
    selects back into them IN PLACE; theta is a new tensor. CUDA tensors
    only: the kernel is launched or this raises — there is no fallback."""
    batch, nbrs, y_w, nphi_w, tn_w, ye_w, lu, lv = xs_t
    if not s.pi.is_cuda:
        raise ValueError("the MMSB window kernel's wrapper takes CUDA "
                         "tensors")
    dev = s.pi.device
    t_win, b_cap = batch.nodes.shape
    n_smpl = nbrs.shape[-1]
    e_cap = ye_w.shape[-1]
    k = cfg.K
    if (nbrs.dim() != 2 or tuple(s.pi.shape) != (cfg.N, k)
            or tuple(s.theta_b.shape) != (k, k, 2)
            or tuple(keep.shape) != (t_win, b_cap)):
        raise ValueError(
            f"MMSB window kernel operands: nodes {tuple(batch.nodes.shape)}"
            f", neighbors {tuple(nbrs.shape)}, pi {tuple(s.pi.shape)}, "
            f"theta {tuple(s.theta_b.shape)}, keep {tuple(keep.shape)}")
    if t_win > MAX_WINDOW:
        raise ValueError(f"MMSB window kernel takes windows of <= "
                         f"{MAX_WINDOW} steps, got T={t_win}")
    cluster = mmsb_window_cluster_size(t_win, b_cap, n_smpl, e_cap, k,
                                       kernels.smem_limit(dev))
    lib = _mmsb_lib()

    def arg(x, dtype):
        return kernels.pointer(x, dtype, dev)

    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    theta = torch.empty_like(s.theta_b)
    ptrs = [arg(s.pi, f32), arg(s.phi_sum, f32), arg(y_w, b8),
            arg(batch.nodes, i32), arg(nbrs, i32), arg(batch.node_mask, b8),
            arg(keep, b8), arg(nphi_w, f32), arg(tn_w, f32), arg(ye_w, b8),
            arg(batch.edge_mask, b8), arg(lu, i32), arg(lv, i32),
            arg(mcode, i32), arg(batch.weight, f32), arg(s.theta_b, f32),
            theta.data_ptr()]
    # the prior of the diagonal cells: mmsb_prior_diag, a scalar or an
    # (eta0, eta1) pair (models/mmsb.mmsb_eta)
    diag = np.broadcast_to(np.asarray(
        (cfg.eta0, cfg.eta1) if cfg.mmsb_prior_diag is None
        else cfg.mmsb_prior_diag, np.float64), (2,))
    eps_phi = _step_sizes(cfg, s.step_count, t_win)
    eps_theta = _step_sizes(cfg, s.theta_count + 1, t_win)
    err = lib.mmsb_window_launch(
        *ptrs, t_win, b_cap, n_smpl, e_cap, k, cfg.N, cluster,
        cfg.alpha_value, float(cfg.N), 1.0 / k, cfg.eta0, cfg.eta1,
        float(diag[0]), float(diag[1]), eps_phi.ctypes.data,
        eps_theta.ctypes.data, torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch(err, "MMSB window kernel")
    mmsb_window_apply_cuda.launches += 1
    return _advance(s, t_win, theta)


#: Launches of the MMSB window kernel in this process (reset by callers
#: that check a run went through it).
mmsb_window_apply_cuda.launches = 0
