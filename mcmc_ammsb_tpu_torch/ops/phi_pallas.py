"""The per-node phi update with private neighbor draws, as
``--phi-impl pallas`` runs it (counterpart of
``mcmc_ammsb_tpu/ops/phi_pallas.py``).

Two entries with the JAX package's contracts, each with a plain PyTorch
version and a hand-written Hopper kernel (``csrc/phi_kernel.cu``):

* the pre-gathered entry (``phi_update_core_pallas``): node rows
  [B, K], their phi sums [B], neighbor rows [B, n, K]. The
  step-at-a-time host-sampled path (``learner.train_step`` at
  ``--steps-per-call 1``) calls it through ``phi_update_rows_pallas``,
  which gathers and queries membership first, as the JAX package does;
* the by-index entry (``phi_update_rows_pallas_gather``): the kernel
  reads the B + B n rows from pi [N, K] itself. The hoisted
  ``--phi-impl pallas`` step calls this one (``phi_update_rows``): no
  [B, n, K] buffer, no separate gather launch.

Both return the row-normalized rows and their sums (the JAX package
normalizes outside its kernel; the CUDA kernel fuses that step). The TPU
tiling limits (K % 128, K % 1024, ``node_tile``) are not carried over:
the kernel takes any K, staging a node's neighbor rows in chunks where
they do not all fit a block's shared memory (``phi_neighbor_chunk``).
Shared-neighbor masks are rejected, as in JAX.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mcmc_ammsb_tpu_torch import kernels
from mcmc_ammsb_tpu_torch.config import Config
from mcmc_ammsb_tpu_torch.ops import phi as phi_ops
from mcmc_ammsb_tpu_torch.ops.window import _step_sizes


def _reject_mask(nbr_mask) -> None:
    if nbr_mask is not None:
        raise ValueError(
            "the per-node phi kernel does not take shared-neighbor masks "
            "(shared_neighbors requires phi_impl=jnp)")


def _gather(cfg: Config, pi, phi_sum, nodes, nbrs):
    """pi rows of the nodes and their neighbors, phi sums of the nodes.
    Padded node lanes carry the sentinel N: clamped to N-1 as JAX's
    gather does."""
    idx = nodes.long().clamp(0, cfg.N - 1)
    cdt = phi_sum.dtype                  # compute type, as in JAX
    return (pi[idx].to(cdt), phi_sum[idx],
            pi[nbrs.long().clamp(0, cfg.N - 1)].to(cdt))


# ---------------------------------------------------------------------------
# The plain PyTorch versions
# ---------------------------------------------------------------------------

def phi_update_core_torch(cfg: Config, pi_n, phis, pi_nb, y, beta,
                          step_count, noise, nbr_mask=None):
    """pi_n [B, K], phis [B], pi_nb [B, n, K], y [B, n] bool, beta [K],
    noise [B, K] -> (rows [B, K], sums [B]): ops/phi.phi_update_core in
    its private form."""
    _reject_mask(nbr_mask)
    return phi_ops.phi_update_core(cfg, pi_n, phis, pi_nb, y, beta,
                                   step_count, noise)


def phi_update_rows_torch(cfg: Config, pi, phi_sum, beta, nodes, nbrs, y,
                          step_count, noise):
    """The by-index entry: pi [N, K], phi_sum [N], nodes [B], nbrs
    [B, n] int32; the same result as gathering the rows first."""
    pi_n, phis, pi_nb = _gather(cfg, pi, phi_sum, nodes, nbrs)
    return phi_ops.phi_update_core(cfg, pi_n, phis, pi_nb, y, beta,
                                   step_count, noise)


def phi_update_rows(cfg: Config, pi, phi_sum, beta, nodes, nbrs, y,
                    step_count, noise):
    """The ``--phi-impl pallas`` step: the CUDA kernel for a CUDA ``pi``,
    the plain version for a CPU one."""
    entry = phi_update_rows_cuda if pi.is_cuda else phi_update_rows_torch
    return entry(cfg, pi, phi_sum, beta, nodes, nbrs, y, step_count, noise)


def phi_update_rows_pallas(cfg: Config, pi, phi_sum, beta, edge_set, nodes,
                           neighbors, step_count, noise):
    """The step-at-a-time ``--phi-impl pallas`` update (``train_step``),
    the contract of ``ops/phi.phi_update_rows``: torch gathers of
    ``pi[nodes]``, ``pi[neighbors]`` and ``phi_sum[nodes]`` and the
    membership query, then the pre-gathered entry: the CUDA kernel for a
    CUDA ``pi``, the plain version for a CPU one. Padded node lanes (the
    sentinel N, or id 0 with a false mask) are clamped into the table."""
    pi_n, phis, pi_nb = _gather(cfg, pi, phi_sum, nodes, neighbors)
    y = edge_set.has_edges(nodes[:, None], neighbors)
    entry = phi_update_core_cuda if pi.is_cuda else phi_update_core_torch
    return entry(cfg, pi_n, phis, pi_nb, y, beta, step_count, noise)


# ---------------------------------------------------------------------------
# The Hopper kernel
# ---------------------------------------------------------------------------

#: The largest cluster per node (kMaxCluster of csrc/phi_kernel.cu).
MAX_CLUSTER = 8


def phi_smem_bytes(n_smpl: int, k: int, nc: int, g: int) -> int:
    """Shared memory per block (``smem_words`` of csrc/phi_kernel.cu):
    the staged rows of a chunk [nc, ceil4(K)], the node row, beta - eps
    and the accumulator [ceil4(K)] each, with ``g`` > 1 the cluster's
    partial rows [g, ceil4(K)]; the block's ceil(n/g) neighbors' row
    offsets (two words), labels and sums; 32 words for the row sum."""
    ldr = -(-k // 4) * 4
    ng = -(-n_smpl // g)
    return 4 * (nc * ldr + 3 * ldr + (g * ldr if g > 1 else 0) + 4 * ng
                + 32)


def phi_neighbor_chunk(n_smpl: int, k: int, g: int = 1,
                       smem_limit: int = 232448) -> int:
    """Neighbors whose rows a block stages at once: all of its ceil(n/g)
    when they fit ``smem_limit``, else as many as fit (the kernel loops
    over the chunks). Raises, naming the shape, when not even one row
    fits."""
    ng = -(-n_smpl // g)
    fixed = phi_smem_bytes(n_smpl, k, 0, g)
    nc = min(ng, (smem_limit - fixed) // (4 * (-(-k // 4) * 4)))
    if nc < 1:
        raise ValueError(f"phi kernel: (n, K) = ({n_smpl}, {k}) leaves no "
                         f"room for one row in {smem_limit} B of shared "
                         f"memory per block")
    return nc


def phi_cluster_size(b_cap: int, n_smpl: int, k: int, sms: int = 132,
                     smem_limit: int = 232448) -> int:
    """Blocks per node (the kernel's G, a cluster that splits the node's
    neighbors): the largest power of two <= MAX_CLUSTER and <= n whose B*G
    blocks fit the card's ``sms`` SMs at one block each and whose blocks
    still have room for a neighbor row beside the cluster's partial rows;
    G = 4 at the --phi-impl pallas shape (B = 33), which fills the 132 SMs
    of an H100 (scripts/window_phases.py --kernels phi sweeps G; PERF.md
    gives the times)."""
    g = 1
    while (2 * g <= min(MAX_CLUSTER, n_smpl) and 2 * g * b_cap <= sms
           and phi_smem_bytes(n_smpl, k, 1, 2 * g) <= smem_limit):
        g *= 2
    return g


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def bind_phi_lib(lib):
    """Declare the C interface of a build of csrc/phi_kernel.cu."""
    lib.phi_kernel_smem_bytes.argtypes = [_I] * 4
    lib.phi_kernel_smem_bytes.restype = ctypes.c_size_t
    lib.phi_kernel_launch.argtypes = [_P] * 8 + [_I] * 5 + [_F] * 5 + [_P]
    lib.phi_kernel_launch.restype = _I
    lib.phi_gather_launch.argtypes = [_P] * 9 + [_I] * 6 + [_F] * 5 + [_P]
    lib.phi_gather_launch.restype = _I
    return lib


@functools.cache
def _phi_lib():
    return bind_phi_lib(kernels.load("phi_kernel"))


def _scalars(cfg: Config, step_count):
    """eps, eps_t, alpha, N/n, n: the kernel's by-value scalars."""
    eps_t = float(_step_sizes(cfg, step_count, 1)[0])
    return (cfg.epsilon, eps_t, cfg.alpha_value,
            cfg.N / cfg.num_node_sample, float(cfg.num_node_sample))


def _check(cfg: Config, x, b_cap, n_smpl, k):
    """Outputs (rows, sums) and the launch's (nc, G) for a CUDA
    operand ``x``; raises on a CPU tensor or a shape the kernel does not
    take."""
    if not x.is_cuda:
        raise ValueError("the phi kernel takes CUDA tensors")
    if n_smpl != cfg.num_node_sample:
        raise ValueError(f"{n_smpl} neighbors per node, the config says "
                         f"{cfg.num_node_sample}")
    limit = kernels.smem_limit(x.device)
    g = phi_cluster_size(
        b_cap, n_smpl, k,
        torch.cuda.get_device_properties(x.device).multi_processor_count,
        limit)
    nc = phi_neighbor_chunk(n_smpl, k, g, limit)
    return (torch.empty(b_cap, k, device=x.device),
            torch.empty(b_cap, device=x.device), nc, g)


def phi_update_core_cuda(cfg: Config, pi_n, phis, pi_nb, y, beta,
                         step_count, noise, nbr_mask=None):
    """``phi_update_core_torch`` in one launch of the pre-gathered entry
    of ``csrc/phi_kernel.cu``. CUDA tensors only: the kernel is launched
    or this raises."""
    _reject_mask(nbr_mask)
    b_cap, n_smpl, k = pi_nb.shape
    rows, sums, nc, g = _check(cfg, pi_n, b_cap, n_smpl, k)
    dev = pi_n.device
    f32 = torch.float32
    err = _phi_lib().phi_kernel_launch(
        kernels.pointer(pi_n, f32, dev), kernels.pointer(phis, f32, dev),
        kernels.pointer(pi_nb, f32, dev),
        kernels.pointer(y, torch.bool, dev),
        kernels.pointer(beta, f32, dev), kernels.pointer(noise, f32, dev),
        rows.data_ptr(), sums.data_ptr(), b_cap, n_smpl, k, nc, g,
        *_scalars(cfg, step_count), torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch(err, "phi kernel")
    phi_update_core_cuda.launches += 1
    return rows, sums


def phi_update_rows_cuda(cfg: Config, pi, phi_sum, beta, nodes, nbrs, y,
                         step_count, noise):
    """``phi_update_rows_torch`` in one launch of the by-index entry of
    ``csrc/phi_kernel.cu``: the kernel reads the node and neighbor rows
    from ``pi`` itself (ids clamped to N-1). CUDA tensors only."""
    b_cap, n_smpl = nbrs.shape
    k = pi.shape[1]
    if pi.shape[0] != cfg.N:
        raise ValueError(f"pi has {pi.shape[0]} rows, the config says "
                         f"N={cfg.N}")
    rows, sums, nc, g = _check(cfg, pi, b_cap, n_smpl, k)
    dev = pi.device
    f32, i32 = torch.float32, torch.int32
    err = _phi_lib().phi_gather_launch(
        kernels.pointer(pi, f32, dev), kernels.pointer(phi_sum, f32, dev),
        kernels.pointer(nodes, i32, dev), kernels.pointer(nbrs, i32, dev),
        kernels.pointer(y, torch.bool, dev),
        kernels.pointer(beta, f32, dev), kernels.pointer(noise, f32, dev),
        rows.data_ptr(), sums.data_ptr(), b_cap, n_smpl, k, cfg.N, nc, g,
        *_scalars(cfg, step_count), torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch(err, "phi gather kernel")
    phi_update_rows_cuda.launches += 1
    return rows, sums


#: Launches of each entry in this process (reset by callers that check a
#: run went through it).
phi_update_core_cuda.launches = 0
phi_update_rows_cuda.launches = 0
