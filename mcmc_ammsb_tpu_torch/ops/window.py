"""T-step windowed training loop (counterpart of
``mcmc_ammsb_tpu/ops/window.py``).

Each window of T steps is what the JAX package's ``windowed_scan`` does
with ``window_correction="always"``:

  1. ONE bulk gather of all T steps' pi rows ([T*(B+n)] indices);
  2. the T sequential phi/beta/theta updates;
  3. ONE last-write-wins scatter of the T*B staged rows.

The S % T steps after a chunk's last whole window, which the JAX package
runs one at a time through its step body, run here as one window of
S % T steps (``windowed_scan``): a launch instead of ~60 torch ops a
step, and no copy from host memory. With bf16 pi storage they keep the
step body, which rounds the rows after every step.

On a CUDA tensor the three are one launch of the hand-written Hopper
kernel ``csrc/window_kernel.cu`` (``window_apply_cuda``): it reads its
rows from pi by index, runs the steps on a thread-block cluster that
splits K, and writes the surviving rows back itself. ``window_plan``
picks its mode from the per-chain shape and the card's shared memory,
which it reads for each layout from the kernel's own
``csrc/window_layout.h`` (``window_layout_bytes``): the resident mode
(the window's rows in shared memory) wherever it fits, else one of the
wide mode's five layouts (the staged rows in a global scratch), which
the head of ``csrc/window_kernel.cu`` describes. With bfloat16 pi
storage (``cfg.pi_dtype``) both versions gather the rows upcast to float32,
compute and stage in float32, and round the kept rows to nearest-even
only at the write-back, as the JAX package's bf16 window does; the
kernel takes the storage type from ``s.pi``. On a CPU tensor, and on any
device with ``cfg.window_impl == "jnp"`` (``plain_or``), the plain
PyTorch version ``window_apply_torch`` runs them as ``_window_gather``,
``window_core_torch`` and ``_window_scatter``.

A step may read a row that an earlier step of the same window wrote.
``_correction_codes`` gives every read lane the staged slot of the
latest such write, and both versions redirect the read there, so the
trajectory is the sequential scan's up to float reduction order.
``window_correction="auto"`` runs as ``"always"``: the JAX package skips
the codes of windows without such a read (``_dirty_windows``), whose
codes are all zero, so the bits are the same; on the H100 skipping them
did not pay (PERF.md).

The flat chain engine (``chains_flat``) runs the windows of C chains
through ``window_chain_apply_cuda`` (the same kernel, one cluster per
chain) and its plain version ``window_chain_apply_torch``.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from mcmc_ammsb_tpu_torch import kernels
from mcmc_ammsb_tpu_torch.config import Config
from mcmc_ammsb_tpu_torch.ops import beta as beta_ops
from mcmc_ammsb_tpu_torch.ops import phi as phi_ops
from mcmc_ammsb_tpu_torch.utils import profiling
from mcmc_ammsb_tpu_torch.utils.profiling import stage


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
            with stage("window_correct"):
                mcodes = _correction_codes(cfg, nodes, mask, nbrs_w)
            with stage("window_prep"):
                keeps = _last_write_wins(nodes, mask, t_win)
        yield (index_operands(xs, slice(w * t_win, (w + 1) * t_win)),
               mcodes[w % _WINDOWS_PER_BATCH], keeps[w % _WINDOWS_PER_BATCH])


def plain_or(cfg: Config, state, kernel, plain):
    """The version of a window a run goes through: ``kernel`` when the
    state lies on a card, ``plain`` (the stock torch ops) on the CPU and,
    on any device, with ``cfg.window_impl == "jnp"``, the explicit golden
    twin."""
    if state.pi.is_cuda and cfg.window_impl != "jnp":
        return kernel
    return plain


def windowed_scan(cfg: Config, state, xs, body):
    """Run the hoisted steps ``xs`` in windows of ``cfg.window``; the
    ``S % T`` steps after the last whole window run as one short window
    of that many steps, through the same launch (the kernel reads T from
    the operands' shape), and count in ``windowed_scan.tail_launches``.
    With bf16 pi storage they go through ``body(state, x) -> state`` one
    at a time, as in the JAX package: a window rounds the rows it writes
    to bf16 only at its end, so a later step of a short window would
    read an earlier step's rows unrounded where the step body reads them
    rounded.

    ``xs`` is the operand tuple of ``learner.hoist_operands``:
    (batches, neighbors [S,1,n], y_phi, phi_noise, beta_noise,
     y_edges, lanes_u, lanes_v)."""
    apply = plain_or(cfg, state, window_apply_cuda, window_apply_torch)
    for xs_t, mcode, keep in iter_windows(cfg, xs, xs[1][:, 0, :]):
        with stage("window_kernel"):
            state = apply(cfg, state, xs_t, mcode, keep)
    s_len = xs[1].shape[0]
    tail = s_len % cfg.window
    if tail:
        # under window_tail, not window_kernel: the readers of that stage
        # count whole windows
        with stage("window_tail", tail):
            if state.pi.dtype == torch.bfloat16:
                for i in range(s_len - tail, s_len):
                    state = body(state, index_operands(xs, i))
                return state
            xs_t = index_operands(xs, slice(s_len - tail, s_len))
            batch, nbrs = xs_t[0], xs_t[1][:, 0, :]
            with stage("window_correct"):
                mcode = _correction_codes(cfg, batch.nodes,
                                          batch.node_mask, nbrs)
            with stage("window_prep"):
                keep = _last_write_wins(batch.nodes, batch.node_mask, tail)
            state = apply(cfg, state, xs_t, mcode, keep)
            windowed_scan.tail_launches += 1
    return state


#: Chunk tails run as one short window in this process (reset by callers
#: that check a run went through it).
windowed_scan.tail_launches = 0


def _dirty_windows(nodes, mask, nbrs, t_win):
    """[W] bool: the window has an intra-window read-after-write (a later
    step reads a row an earlier step wrote) or write-after-write. Shapes:
    nodes/mask [W, T, B], nbrs [W, T, n]. The JAX package's test of a
    window that needs correcting; the port corrects every window, and
    counts the dirty ones with it in its checks."""
    writes = torch.where(mask, nodes, -2)                    # [W, T, B]
    reads = torch.cat([torch.where(mask, nodes, -1), nbrs], dim=2)
    # masked write lanes are non-writes: they never match each other
    # (every padded lane carries the same sentinel) nor a read
    t_r = torch.arange(t_win, device=nodes.device)
    later = (t_r[:, None, None, None] > t_r[None, None, :, None])
    rw = ((reads[:, :, :, None, None] == writes[:, None, None, :, :])
          & later & mask[:, None, None, :, :])
    distinct = t_r[:, None, None, None] != t_r[None, None, :, None]
    ww = ((writes[:, :, :, None, None] == writes[:, None, None, :, :])
          & distinct & mask[:, :, :, None, None] & mask[:, None, None, :, :])
    return rw.flatten(1).any(1) | ww.flatten(1).any(1)


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


def _chain_flat_ids(nodes, n_rows: int, axis: int = 0):
    """Chain-local ids, the chain on ``axis``, -> flat row ids of pi
    [C*N, K]; the sentinel N becomes the flat sentinel C*N."""
    c = nodes.shape[axis]
    shape = [1] * nodes.dim()
    shape[axis] = c
    offsets = (torch.arange(c, dtype=nodes.dtype, device=nodes.device)
               * n_rows).reshape(shape)
    return torch.where(nodes < n_rows, nodes + offsets, c * n_rows)


def _chain_window_gather(cfg: Config, s, xs_t):
    """The bulk read of one window of C chains on the flat layout (the
    JAX chain engine's): g [C, T, B+n, K] f32, sums [C, T, B]; the flat
    sentinel C*N is clamped to C*N - 1, as JAX's gather clamps it."""
    batch, nbrs_s = xs_t[0], xs_t[1]
    c, t_win, b_cap = batch.nodes.shape
    read_idx = _chain_flat_ids(torch.cat([batch.nodes, nbrs_s[..., 0, :]],
                                         dim=-1), cfg.N)
    read_idx = read_idx.long().clamp(max=c * cfg.N - 1)
    g = s.pi[read_idx.reshape(-1)].float().reshape(c, t_win, -1, cfg.K)
    sums = s.phi_sum[read_idx[..., :b_cap].reshape(-1)].reshape(
        c, t_win, b_cap)
    return g, sums


def _advance(s, t_win: int, **fields):
    """``s`` after one window: the given fields replaced, the step
    counters advanced by T."""
    return s._replace(step_count=s.step_count + t_win,
                      beta_count=s.beta_count + t_win, **fields)


# ---------------------------------------------------------------------------
# The window: the plain PyTorch version
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


def window_apply_torch(cfg: Config, s, xs_t, mcode, keep):
    """One whole window with the stock torch ops: ``_window_gather``,
    ``window_core_torch``, ``_window_scatter`` (JAX's gather, kernel and
    scatter). ``s.pi`` and ``s.phi_sum`` are updated in place; returns
    the state after the window. Tags the open span ``torch``."""
    profiling.tag("torch")
    batch = xs_t[0]
    g, sums_g = _window_gather(cfg, s, batch, xs_t[1][:, 0, :])
    rows, sums, theta, beta = window_core_torch(cfg, s, xs_t, g, sums_g,
                                                mcode)
    pi, phi_sum = _window_scatter(cfg, s, batch, keep, rows, sums)
    return _advance(s, batch.nodes.shape[0], pi=pi, phi_sum=phi_sum,
                    theta=theta, beta=beta)


def window_chain_apply_torch(cfg: Config, s, xs_t, mcode, keep):
    """One whole window of C chains on the flat layout with the stock
    torch ops: ``_chain_window_gather``, ``window_chain_core_torch`` and
    the chain-major last-write-wins scatter (JAX's _windowed_chain_scan).
    Operands as ``window_chain_core_torch`` takes them, ``keep``
    [C, T, B]; ``s.pi`` [C*N, K] and ``s.phi_sum`` are updated in place."""
    batch = xs_t[0]
    g, sums_g = _chain_window_gather(cfg, s, xs_t)
    rows, sums, theta, beta = window_chain_core_torch(cfg, s, xs_t, g,
                                                      sums_g, mcode)
    pi, phi_sum = phi_ops.scatter_rows(
        s.pi, s.phi_sum, _chain_flat_ids(batch.nodes, cfg.N).reshape(-1),
        keep.reshape(-1), rows, sums)
    return _advance(s, batch.nodes.shape[1], pi=pi, phi_sum=phi_sum,
                    theta=theta, beta=beta)


# ---------------------------------------------------------------------------
# The window: the Hopper kernel
# ---------------------------------------------------------------------------

#: kMaxNeighbors of csrc/window_layout.h: the contrib loop keeps a
#: thread's column of the n neighbor rows in registers.
MAX_NEIGHBORS = 32
#: kMaxWindow of csrc/window_layout.h: the step sizes of a window travel
#: in the kernel's parameters.
MAX_WINDOW = 64
#: kMaxCluster of csrc/window_layout.h: the largest thread-block cluster.
MAX_CLUSTER = 16
#: Shared memory one thread block may use on an H100 (bytes).
H100_SMEM = 232448
#: The K split aims at about this many columns per CTA: at K = 256 a
#: cluster of 4, of which an H100 runs 30 at once (15 of 8), so 16
#: chains fit in one wave.
_COLUMNS_PER_CTA = 64

#: The kernel's code of each layout (``Mode`` of csrc/window_layout.h).
LAYOUTS = {"resident": 0, "step": 1, "step1": 2, "wide": 3, "nodes": 4,
           "grid": 5}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.cache
def _layout_lib():
    """The host build of the kernel's layouts, csrc/window_layout.h
    (csrc/window_layout.cpp): built with g++ at the first plan."""
    lib = kernels.load("window_layout.cpp")
    lib.window_layout_bytes.argtypes = [_I] * 8
    lib.window_layout_bytes.restype = ctypes.c_size_t
    lib.window_layout_slice_width.argtypes = [_I] * 2
    lib.window_layout_slice_width.restype = _I
    lib.window_layout_grid_exchange_words.argtypes = [_I] * 6
    lib.window_layout_grid_exchange_words.restype = ctypes.c_size_t
    return lib


def window_layout_bytes(shape, plan) -> int:
    """Shared memory per CTA of a launch of the per-chain ``shape`` (T, B,
    n, E, K) in ``plan`` (S, mode, wc): ``layout_bytes`` of
    csrc/window_layout.h (``wc``: the chunk, tile or slice width)."""
    s, mode, wc = plan
    return _layout_lib().window_layout_bytes(*shape, s, wc, LAYOUTS[mode])


def window_slice_width(k: int, s: int) -> int:
    """Columns per CTA with a cluster of ``s`` (``slice_width`` of
    csrc/window_layout.h); CTA r owns [r*w, min(K, (r+1)*w))."""
    return _layout_lib().window_layout_slice_width(k, s)


def _tiles(k: int, s: int) -> bool:
    """The S column slices of width ``window_slice_width(k, s)`` tile K
    with none empty."""
    return s <= k and (s - 1) * window_slice_width(k, s) < k


def _resident_cluster(shape, smem_limit):
    """The resident mode's cluster size (``window_cluster_size``), or None
    when its layout fits no S <= 16."""
    k = shape[4]
    s0 = min(8, max(1, -(-k // _COLUMNS_PER_CTA)))
    pow2 = [s for s in (1, 2, 4, 8, 16) if s >= s0]
    for s in pow2 + [s for s in range(1, MAX_CLUSTER + 1) if s not in pow2]:
        if (_tiles(k, s) and window_layout_bytes(shape, (s, "resident", 0))
                <= smem_limit):
            return s
    return None


@functools.lru_cache(maxsize=None)
def window_cluster_size(t_win: int, b_cap: int, n_smpl: int, e_cap: int,
                        k: int, smem_limit: int = H100_SMEM) -> int:
    """The resident mode's cluster size S of one chain's window, from the
    per-chain shape and the card's shared memory per block (never from
    the number of chains, so one C-chain launch gives the bits of C
    single-chain launches). The first of: the powers of two from
    min(8, ceil(K / 64)) up to 16, then any other S <= 16 — whose slices
    are all non-empty and whose per-CTA shared memory (the window's
    staged slice above all) fits. Raises when none does (``window_plan``
    then takes the wide mode)."""
    s = _resident_cluster((t_win, b_cap, n_smpl, e_cap, k), smem_limit)
    if s is None:
        raise ValueError(
            f"window kernel: (T, B, n, E, K) = ({t_win}, {b_cap}, "
            f"{n_smpl}, {e_cap}, {k}) fits {smem_limit} B of shared memory "
            f"per CTA at no cluster size <= {MAX_CLUSTER}; use a smaller "
            f"--window or K")
    return s


#: Column chunk widths of the wide mode's chunked layout, widest first
#: (multiples of 8: 16-byte copies of float32 and of bf16 rows).
WIDE_CHUNKS = (128, 64)
#: kQNodes of csrc/window_layout.h: the nodes of a warp's q tile in the
#: step layout.
_Q_NODES = 11
#: Cluster sizes the wide mode tries, in order: the most SMs per window
#: first, powers of two (even slices) before the rest.
_WIDE_CLUSTERS = (16, 8, 4, 2, 1) + tuple(s for s in range(15, 2, -1)
                                          if s & (s - 1))
#: The node-resident layout's tile width: columns of the neighbor rows a
#: tile holds (a multiple of 8).
NODES_TILE = 128
#: The node-resident layout's q gives each warp one task of kQNodes nodes
#: (csrc/window_kernel.cu refuses more groups than its 16 warps).
_MAX_Q_GROUPS = 16
#: The grid layout's cluster: its CTAs add their partials through
#: distributed shared memory before the clusters exchange theirs in L2.
GRID_CLUSTER = 4
#: Clusters of GRID_CLUSTER CTAs, one an SM, that an H100 runs at once
#: (120 of its 132 SMs); on a card ``window_apply_cuda`` asks the card
#: (``window_kernel_max_clusters``).
H100_GRID_CLUSTERS = 30
#: kMaxGrid of csrc/window_layout.h: a sum over the clusters holds their
#: partials in registers.
MAX_GRID_CLUSTERS = 32
#: The grid layout runs where it spreads a window over at least this many
#: CTAs, four times the node-resident layout's cluster of 16; on fewer
#: its grid barriers would buy little.
MIN_GRID_CTAS = 64


def window_grid_width(k: int, clusters: int,
                      s: int = GRID_CLUSTER):
    """The grid layout's slice width at K with ``clusters`` co-resident
    clusters of ``s`` CTAs: the narrowest multiple of 8 columns (16-byte
    rows of bf16 storage) whose ceil(K / w) slices are a whole number of
    clusters, at most ``clusters`` and MAX_GRID_CLUSTERS of them, so that
    the slices tile K with none empty; None where that gives fewer than
    MIN_GRID_CTAS slices."""
    g_max = min(clusters, MAX_GRID_CLUSTERS)
    if g_max <= 0:
        return None
    w = 8 * -(-k // (8 * s * g_max))
    while True:
        ctas = -(-k // w)
        if ctas < MIN_GRID_CTAS:
            return None
        if ctas % s == 0 and ctas // s <= g_max:
            return w
        w += 8


@functools.lru_cache(maxsize=None)
def window_grid_exchange_words(b_cap: int, n_smpl: int, e_cap: int, k: int,
                               w: int, s: int = GRID_CLUSTER) -> int:
    """Floats of the grid layout's L2 exchange after the staged rows in the
    scratch (``grid_exchange_words`` of csrc/window_layout.h); cached."""
    return _layout_lib().window_layout_grid_exchange_words(
        b_cap, n_smpl, e_cap, k, w, s)


def _grid_plan(shape, smem_limit, clusters):
    """The grid layout's plan ``(GRID_CLUSTER, "grid", w)`` with
    ``clusters`` co-resident clusters, or None where it takes too few
    CTAs or its shared memory does not fit."""
    plan = GRID_CLUSTER, "grid", window_grid_width(shape[4], clusters)
    if plan[2] is None or window_layout_bytes(shape, plan) > smem_limit:
        return None
    return plan


def step_chunk(k: int, s: int) -> int:
    """The chunk width the launch passes for either step layout: the
    slice width rounded up to a multiple of 8, one chunk that covers the
    slice."""
    return -(-window_slice_width(k, s) // 8) * 8


@functools.lru_cache(maxsize=None)
def window_plan(t_win: int, b_cap: int, n_smpl: int, e_cap: int, k: int,
                smem_limit: int = H100_SMEM,
                grid_clusters: int = H100_GRID_CLUSTERS):
    """How one chain's window runs on the card: ``(S, mode, wc)``. The
    resident mode (``window_cluster_size``'s S, ``wc`` 0) wherever its
    layout fits; else the wide mode at the first S of 16, 8, 4, 2, 1,
    then the other S <= 16, whose slices tile K and where one of its
    layouts fits ``smem_limit``, tried in this order: the step layout
    (``"step"``, ``wc`` = ``step_chunk``, a chunk that covers the slice),
    the step layout with one set of rows (``"step1"``, the same ``wc``),
    the node-resident layout (``"nodes"``, ``wc`` = ``NODES_TILE``, the
    tiles' width; B <= 176, one q task a warp), the chunked one
    (``"wide"``) with the widest chunk of ``WIDE_CHUNKS`` narrower than
    the slice. Where the node-resident layout fits, the grid layout
    takes its place (``(GRID_CLUSTER, "grid", w)``, ``w`` the slice width
    of ``window_grid_width``) if ``grid_clusters`` co-resident clusters
    of GRID_CLUSTER CTAs give it MIN_GRID_CTAS CTAs and its shared memory
    fits: so the shapes that fit are the same with or without it. The
    single-chain entry passes the card's count; the chain entry passes 0
    (``window_chain_apply_cuda``: its launch puts the chains side by side
    as clusters, which the grid's spread over columns would compete with
    for the same SMs). Otherwise from the per-chain shape only, never
    from the number of chains: one C-chain launch gives the bits of C
    single-chain launches in any layout it takes. Each layout's bytes are
    the kernel's own (``window_layout_bytes``). Raises ValueError past
    the kernel's limits (n, T) or when no layout fits; the launch and the
    CLI's window resolution both go through it."""
    if n_smpl > MAX_NEIGHBORS or t_win > MAX_WINDOW:
        raise ValueError(
            f"window kernel takes n <= {MAX_NEIGHBORS} neighbors and "
            f"windows of <= {MAX_WINDOW} steps, got n={n_smpl}, "
            f"T={t_win}; use a smaller --window or --window -1")
    shape = (t_win, b_cap, n_smpl, e_cap, k)

    def fits(plan):
        return window_layout_bytes(shape, plan) <= smem_limit

    s = _resident_cluster(shape, smem_limit)
    if s is not None:
        return s, "resident", 0
    for s in _WIDE_CLUSTERS:
        if not _tiles(k, s):
            continue
        wc = step_chunk(k, s)
        for plan in ((s, "step", wc), (s, "step1", wc)):
            if fits(plan):
                return plan
        if (-(-b_cap // _Q_NODES) <= _MAX_Q_GROUPS
                and fits((s, "nodes", NODES_TILE))):
            return (_grid_plan(shape, smem_limit, grid_clusters)
                    or (s, "nodes", NODES_TILE))
        for wc in WIDE_CHUNKS:
            if wc < window_slice_width(k, s) and fits((s, "wide", wc)):
                return s, "wide", wc
    raise ValueError(
        f"window kernel: (T, B, n, E, K) = ({t_win}, {b_cap}, {n_smpl}, "
        f"{e_cap}, {k}) fits {smem_limit} B of shared memory per CTA in "
        f"neither mode at any cluster size <= {MAX_CLUSTER}; use a "
        f"smaller --window")


def bind_window_lib(lib):
    """Declare the C interface of a build of csrc/window_kernel.cu: the
    byte count and the cluster occupancy of a (T, B, n, E, K, S, wc,
    layout), and the launch."""
    lib.window_kernel_smem_bytes.argtypes = [_I] * 8
    lib.window_kernel_smem_bytes.restype = ctypes.c_size_t
    lib.window_kernel_max_clusters.argtypes = [_I] * 8
    lib.window_kernel_max_clusters.restype = _I
    lib.window_kernel_launch.argtypes = ([_P] * 20 + [_I] * 11 + [_F] * 7
                                         + [_P] * 3)
    lib.window_kernel_launch.restype = _I
    return lib


@functools.cache
def _window_lib():
    return bind_window_lib(kernels.load("window_kernel"))


@functools.lru_cache(maxsize=None)
def _grid_clusters(dev_index: int, shape, plan) -> int:
    """Clusters of a grid plan's CTAs (with their shared memory) that the
    card ``dev_index`` runs at once, as it reports them
    (``window_kernel_max_clusters``)."""
    s, mode, wc = plan
    with torch.cuda.device(dev_index):
        got = _window_lib().window_kernel_max_clusters(*shape, s, wc,
                                                       LAYOUTS[mode])
    if got < 0:
        raise RuntimeError(f"window kernel: occupancy query of {plan} at "
                           f"{shape} failed: CUDA error {-got}")
    return got


def launch_plan(shape, dev, chained: bool):
    """The plan a launch of the per-chain ``shape`` takes on the card
    ``dev``: ``window_plan`` at its shared memory per block, for a chain
    launch with no grid layout, for one chain with the card's own count
    of co-resident grid clusters. That count is read at the plan the
    H100's count gives and again at the plan it leads to, which must fit
    it, else the node-resident layout runs."""
    limit = kernels.smem_limit(dev)
    if chained:
        return window_plan(*shape, limit, 0)
    plan = window_plan(*shape, limit)
    if plan[1] != "grid":
        return plan
    plan = window_plan(*shape, limit, _grid_clusters(dev.index, shape, plan))
    if plan[1] == "grid" and (_grid_clusters(dev.index, shape, plan)
                              * plan[0] < -(-shape[4] // plan[2])):
        plan = window_plan(*shape, limit, 0)
    return plan


def _step_sizes(cfg: Config, first: int, t_win: int) -> np.ndarray:
    """eps_t = a (1 + t/b)^(-c) of steps first .. first+T-1, on the host
    in float32 arithmetic like the plain version's int32 -> float32 path
    (phi.step_size); the kernel takes them as parameters."""
    f32 = np.float32
    t = np.arange(first, first + t_win).astype(f32)
    return np.ascontiguousarray(
        f32(cfg.a) * (f32(1.0) + t / f32(cfg.b)) ** f32(-cfg.c), f32)


def _launch(cfg: Config, s, xs_t, mcode, keep, chained: bool,
            table_rows: int = None):
    """One launch of ``csrc/window_kernel.cu``: one cluster, or with
    ``chained`` one cluster per chain, every operand, ``keep`` and
    ``s.theta``/``s.beta`` then carrying a leading chain axis,
    chain-major as ``window_chain_core_torch`` takes them, and ``s.pi``
    the flat [C*N, K]. ``table_rows`` is the number of rows of each
    chain's table (``s.pi``), N unless given: the sharded path hands the
    kernel a table of fetched rows and ids remapped into it, while the
    scale of the phi gradient stays N. Updates ``s.pi`` and ``s.phi_sum``
    in place; returns the state after the window."""
    batch, nbrs_s, y_w, nphi_w, nbeta_w, ye_w, lu, lv = xs_t
    if not s.pi.is_cuda:
        raise ValueError("the window kernel's wrappers take CUDA tensors")
    dev = s.pi.device
    t_win, b_cap = batch.nodes.shape[-2:]
    n_smpl = nbrs_s.shape[-1]
    e_cap = ye_w.shape[-1]
    k = cfg.K
    lead = tuple(batch.nodes.shape[:-2])
    n_chains = lead[0] if chained else 1
    n_rows = cfg.N if table_rows is None else table_rows
    if (len(lead) != int(chained) or tuple(s.theta.shape) != (*lead, k, 2)
            or tuple(s.beta.shape) != (*lead, k)
            or tuple(s.pi.shape) != (n_chains * n_rows, k)
            or tuple(keep.shape) != (*lead, t_win, b_cap)):
        raise ValueError(
            f"window kernel operands for {'C' if chained else 'one'} "
            f"chain(s): nodes {tuple(batch.nodes.shape)}, pi "
            f"{tuple(s.pi.shape)}, theta {tuple(s.theta.shape)}, beta "
            f"{tuple(s.beta.shape)}, keep {tuple(keep.shape)}")
    cluster, mode, wc = launch_plan((t_win, b_cap, n_smpl, e_cap, k), dev,
                                    chained)
    lib = _window_lib()

    def arg(x, dtype):
        return kernels.pointer(x, dtype, dev)

    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    if s.pi.dtype not in (f32, torch.bfloat16):
        raise ValueError(f"the window kernel stores pi as float32 or "
                         f"bfloat16, got {s.pi.dtype}")
    theta = torch.empty_like(s.theta)
    beta = torch.empty_like(s.beta)
    # the wide mode's staged rows: [C, T*B, K] float32 (6.5 MB at the main
    # path's T = 12, B = 33, K = 4096); the grid layout's L2 exchange after
    # them (138 KB at K = 16384)
    extra = (window_grid_exchange_words(b_cap, n_smpl, e_cap, k, wc, cluster)
             if mode == "grid" else 0)
    staged = (torch.empty(n_chains * t_win * b_cap * k + extra, dtype=f32,
                          device=dev) if mode != "resident" else None)
    ptrs = [arg(s.pi, s.pi.dtype), arg(s.phi_sum, f32), arg(y_w, b8),
            arg(batch.nodes, i32), arg(nbrs_s[..., 0, :], i32),
            arg(batch.node_mask, b8), arg(keep, b8), arg(nphi_w, f32),
            arg(nbeta_w, f32), arg(ye_w, b8), arg(batch.edge_mask, b8),
            arg(lu, i32), arg(lv, i32), arg(mcode, i32),
            arg(batch.weight, f32), arg(s.theta, f32), arg(s.beta, f32),
            theta.data_ptr(), beta.data_ptr(),
            None if staged is None else staged.data_ptr()]
    eps_phi = _step_sizes(cfg, s.step_count, t_win)
    eps_theta = _step_sizes(cfg, s.beta_count + 1, t_win)
    err = lib.window_kernel_launch(
        *ptrs, n_chains, t_win, b_cap, n_smpl, e_cap, k, n_rows, cluster, wc,
        LAYOUTS[mode], int(s.pi.dtype == torch.bfloat16), cfg.epsilon,
        1.0 - cfg.epsilon, cfg.alpha_value, float(cfg.N),
        cfg.eta0, cfg.eta1, 1.0 / k, eps_phi.ctypes.data,
        eps_theta.ctypes.data, torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch(err, "window kernel")
    return _advance(s, t_win, theta=theta, beta=beta), mode


def window_apply_cuda(cfg: Config, s, xs_t, mcode, keep,
                      table_rows: int = None):
    """The same window as ``window_apply_torch`` in ONE launch of
    ``csrc/window_kernel.cu`` (one cluster): the kernel reads its rows
    from ``s.pi``/``s.phi_sum`` by index and writes the rows ``keep``
    selects back into them IN PLACE; theta and beta are new tensors.
    ``table_rows``: ``s.pi`` is a table of that many rows and the ids
    index it (``parallel/sharded.py``'s fetched rows), not pi [N, K].
    ``s.pi`` is float32 or bfloat16 (the kernel's bf16 row mode).
    CUDA tensors only: the kernel is launched or this raises — there is
    no fallback. The mode (resident or wide, in one of its five
    layouts) is ``launch_plan``'s, with the card's count of co-resident
    grid clusters; the open span is tagged with its layout
    (``profiling.tag``: ``resident``, ``step``, ``step1``, ``wide``,
    ``nodes`` or ``grid``)."""
    out, mode = _launch(cfg, s, xs_t, mcode, keep, chained=False,
                        table_rows=table_rows)
    profiling.tag(mode)
    window_apply_cuda.launches += 1
    window_apply_cuda.wide_launches += mode != "resident"
    window_apply_cuda.layouts[mode] += 1
    return out


#: Launches of the single-chain entry in this process, those of them in
#: the wide mode, any layout, and those of each layout (reset by callers
#: that check a run went through it).
window_apply_cuda.launches = 0
window_apply_cuda.wide_launches = 0
window_apply_cuda.layouts = collections.Counter()


def window_chain_apply_cuda(cfg: Config, s, xs_t, mcode, keep):
    """The same C chains' window as ``window_chain_apply_torch`` in ONE
    launch of ``csrc/window_kernel.cu``, one cluster per chain (the JAX
    kernel's blocked ``n_chains = C`` mode with its gather and scatter,
    C >= 1); ``s.pi`` [C*N, K] and ``s.phi_sum`` are updated IN PLACE.
    Never the grid layout (``launch_plan``): the node-resident one where a
    single chain would take it. CUDA tensors only: the kernel is launched
    or this raises."""
    out, mode = _launch(cfg, s, xs_t, mcode, keep, chained=True)
    window_chain_apply_cuda.launches += 1
    window_chain_apply_cuda.wide_launches += mode != "resident"
    window_chain_apply_cuda.chains += keep.shape[0]
    return out


#: Launches of the chain entry, those of them in the wide mode, and the
#: chains they ran in all.
window_chain_apply_cuda.launches = 0
window_chain_apply_cuda.wide_launches = 0
window_chain_apply_cuda.chains = 0
