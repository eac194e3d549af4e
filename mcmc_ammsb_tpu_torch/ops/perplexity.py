"""Held-out perplexity estimator (counterpart of
``mcmc_ammsb_tpu/ops/perplexity.py``):

  link edge:     L = sum_k pi_uk pi_vk beta_k
  non-link edge: L = sum_k pi_uk pi_vk (1 - beta_k)
                     + (1 - sum_k pi_uk pi_vk)(1 - eps)
  floored at 1e-30, folded into a per-edge running average across calls
  ppx_e <- (ppx_e (c - 1) + L) / c, c = call count;
  result = -mean_e log(ppx_e), which the caller exponentiates.

On a card every evaluation is one launch pair of the hand-written kernel
``csrc/ppx_kernel.cu`` (``likelihood_cuda``): it streams each pair's two
stored rows once and folds the averages in the same pass. CPU tensors
take the plain PyTorch version (``edge_likelihood``,
``blocked_likelihood``, ``fold_likelihood``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from mcmc_ammsb_tpu_torch import kernels
from mcmc_ammsb_tpu_torch.config import Config
from mcmc_ammsb_tpu_torch.ops.edgeset import EdgeSet


class PpxResult(NamedTuple):
    ppx_per_edge: torch.Tensor   # [H] updated running averages
    neg_avg_log: torch.Tensor    # scalar; exp() of it is the perplexity
    link_likelihood: torch.Tensor
    non_link_likelihood: torch.Tensor
    link_count: torch.Tensor
    non_link_count: torch.Tensor


_EMPTY = "empty held-out population: heldout_ratio too small for this graph"

#: Bytes of one block's [rows, K] float32 temporary in the plain blocked
#: evaluations: the population's rows are gathered, upcast and reduced one
#: block at a time, so the transient memory is bounded whatever H x K is
#: (at N = 4M, K = 4096 one [H, K] float32 gather is ~5.6 GB). The kernel
#: keeps no such temporary.
EVAL_BLOCK_BYTES = 256 << 20


def eval_block_rows(k: int, lead: int = 1) -> int:
    """Population rows per block of the blocked evaluations: the rows
    whose [lead, rows, K] float32 temporary fits ``EVAL_BLOCK_BYTES``."""
    return max(1, EVAL_BLOCK_BYTES // (4 * max(k, 1) * max(lead, 1)))


def edge_likelihood(cfg: Config, pi_u: torch.Tensor, pi_v: torch.Tensor,
                    y: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Each pair's likelihood from its endpoint rows [..., K] (the link or
    non-link formula by ``y``), floored at 1e-30."""
    eps = cfg.epsilon
    pp = pi_u * pi_v
    pi_sum = torch.sum(pp, dim=-1)
    s_link = torch.sum(pp * beta, dim=-1)
    s_non = (torch.sum(pp * (1.0 - beta), dim=-1)
             + (1.0 - pi_sum) * (1.0 - eps))
    return torch.clamp(torch.where(y, s_link, s_non), min=1e-30)


def blocked_likelihood(cfg: Config, pi: torch.Tensor, beta: torch.Tensor,
                       edges_u: torch.Tensor, edges_v: torch.Tensor,
                       y: torch.Tensor, lead: int = 1) -> torch.Tensor:
    """``edge_likelihood`` of the pairs (edges_u, edges_v) over pi's rows
    in blocks of ``eval_block_rows``: [H], or [lead, H] where the rows of
    ``lead`` chains sit at offsets of N in pi (the chain engine's flat
    layout, ``beta`` [lead, 1, K], ``y`` [lead or 1, H]). Each pair's
    value comes from its own rows alone, as the unblocked gather gives
    it."""
    h = edges_u.shape[0]
    block = eval_block_rows(cfg.K, lead)
    offsets = (torch.arange(lead, device=edges_u.device) * cfg.N)[:, None]
    parts = []
    for a in range(0, h, block):
        u, v = edges_u[a:a + block].long(), edges_v[a:a + block].long()
        if lead == 1:
            rows_u, rows_v = pi[u], pi[v]
        else:
            rows_u = pi[(u[None, :] + offsets).reshape(-1)].reshape(
                lead, -1, cfg.K)
            rows_v = pi[(v[None, :] + offsets).reshape(-1)].reshape(
                lead, -1, cfg.K)
        parts.append(edge_likelihood(cfg, rows_u.to(beta.dtype),
                                     rows_v.to(beta.dtype),
                                     y[..., a:a + block], beta))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def perplexity_step(cfg: Config, pi: torch.Tensor, beta: torch.Tensor,
                    heldout_set: EdgeSet, edges_u: torch.Tensor,
                    edges_v: torch.Tensor, ppx_per_edge: torch.Tensor,
                    avg_count) -> PpxResult:
    """One evaluation over the population (edges_u, edges_v): the
    likelihoods in blocks of rows (``blocked_likelihood``), then the
    running averages and the sums of ``fold_likelihood`` over all of
    them. ``avg_count``: an integer, or its ``count_operand``."""
    if edges_u.shape[0] == 0:
        raise ValueError(_EMPTY)
    y = heldout_set.has_edges(edges_u, edges_v)
    if pi.is_cuda:
        return _one_chain(likelihood_cuda(cfg, pi, pi, beta[None], edges_u,
                                          edges_v, y[None],
                                          ppx_per_edge[None], avg_count))
    lik = blocked_likelihood(cfg, pi, beta, edges_u, edges_v, y)
    return fold_likelihood(lik, y, torch.ones_like(y), ppx_per_edge,
                           avg_count)


def perplexity_core(cfg: Config, pi_u: torch.Tensor, pi_v: torch.Tensor,
                    y: torch.Tensor, mask: torch.Tensor,
                    beta: torch.Tensor, ppx_per_edge: torch.Tensor,
                    avg_count: int) -> PpxResult:
    """Likelihood math on gathered rows; masked lanes are excluded from
    every sum and keep their running average."""
    if pi_u.shape[-2] == 0:
        raise ValueError(_EMPTY)
    if pi_u.is_cuda:
        return _one_chain(likelihood_cuda(cfg, pi_u, pi_v, beta[None], None,
                                          None, y[None], ppx_per_edge[None],
                                          avg_count, mask=mask))
    return fold_likelihood(edge_likelihood(cfg, pi_u, pi_v, y, beta), y,
                           mask, ppx_per_edge, avg_count)


def count_operand(avg_count: int, like: torch.Tensor) -> torch.Tensor:
    """The running averages' count as a 0-d tensor of ``like``'s dtype and
    device. Its copy to a card leaves from pageable memory, so the host
    waits there for the card's queue to drain: a caller that opens a
    ``device_wait`` span around it, outside the ``ppx`` stage, passes it
    to ``perplexity_step`` in place of the integer."""
    return torch.tensor(float(avg_count), dtype=like.dtype,
                        device=like.device)


def fold_likelihood(lik: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                    ppx_per_edge: torch.Tensor, avg_count) -> PpxResult:
    """Fold each pair's likelihood into its running average and sum the
    link and non-link log averages and counts over the unmasked pairs.
    ``avg_count``: an integer, or its ``count_operand``."""
    c = (avg_count if isinstance(avg_count, torch.Tensor)
         else count_operand(avg_count, lik))
    ppx_new = (ppx_per_edge * (c - 1.0) + lik) / c
    ppx_new = torch.where(mask, ppx_new, ppx_per_edge)
    # select, not a multiply: log of a zero padding lane is -inf
    lg = torch.where(mask, torch.log(torch.clamp(ppx_new, min=1e-30)),
                     torch.zeros_like(ppx_new))
    mf = mask.to(lik.dtype)
    yf = y.to(lik.dtype) * mf
    link_lik = torch.sum(lg * yf)
    non_link_lik = torch.sum(lg * (mf - yf))
    link_count = torch.sum(y & mask)
    non_link_count = torch.sum(mask) - link_count
    neg_avg = -(link_lik + non_link_lik) / (link_count
                                            + non_link_count).to(lik.dtype)
    return PpxResult(ppx_new, neg_avg, link_lik, non_link_lik,
                     link_count, non_link_count)


#: Threads of a CTA of the kernel's pair launch; a pair takes a group of
#: ``ppx_plan``'s threads, so a CTA holds PPX_CTA_THREADS / tpp pairs.
PPX_CTA_THREADS = 256
#: Loads of each row a thread should issue at the least before the plan
#: gives a pair more threads.
_LOADS_PER_THREAD = 8


def ppx_plan(k: int, elt_bytes: int, aligned: bool = True):
    """(elements a load, threads per pair) of the evaluation kernel for
    rows of ``k`` values of ``elt_bytes``: 16-byte loads where a row is a
    whole number of them and the bases are ``aligned`` (else one value a
    load), and the fewest threads, a warp at least and a CTA at most, that
    leave each thread ``_LOADS_PER_THREAD`` loads of a row or fewer. One
    pair a CTA at K = 16384, eight at K = 1024 in float32."""
    vec = 16 // elt_bytes if aligned and (k * elt_bytes) % 16 == 0 else 1
    loads = -(-k // vec)
    tpp = 32
    while tpp < PPX_CTA_THREADS and tpp * _LOADS_PER_THREAD < loads:
        tpp *= 2
    return vec, tpp


_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float


@functools.cache
def _ppx_lib():
    lib = kernels.load("ppx_kernel")
    lib.ppx_launch.argtypes = [_P] * 14 + [_LL] * 2 + [_I] * 8 + [_F] * 2 + [
        _P]
    lib.ppx_launch.restype = _I
    return lib


def _want(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"evaluation kernel operand: {what}")


def _check_operands(cfg: Config, rows_u, rows_v, beta, u, v, y, ppx,
                    avg_count, mask) -> tuple:
    """(chains, pairs H), once every operand of ``likelihood_cuda`` has
    its dtype, shape, layout and device; raises ValueError otherwise.
    Nothing here loads the kernel's library."""
    _want(ppx.dim() == 2, f"running averages {tuple(ppx.shape)}, want "
          f"[chains, H]")
    lead, h = ppx.shape
    _want(lead > 0 and h > 0, _EMPTY)
    _want(rows_u.dtype in (torch.float32, torch.bfloat16)
          and rows_v.dtype == rows_u.dtype,
          f"rows {rows_u.dtype} / {rows_v.dtype}, want float32 or bfloat16")
    _want(rows_u.dim() == 2 and rows_v.dim() == 2
          and rows_u.shape[1] == cfg.K and rows_v.shape[1] == cfg.K,
          f"rows {tuple(rows_u.shape)} / {tuple(rows_v.shape)}, want "
          f"[R, {cfg.K}]")
    _want(ppx.dtype == torch.float32, f"running averages {ppx.dtype}, "
          f"want float32")
    _want(beta.dtype == torch.float32 and tuple(beta.shape) == (lead, cfg.K),
          f"beta {beta.dtype} {tuple(beta.shape)}, want float32 "
          f"{(lead, cfg.K)}")
    _want(y.dtype == torch.bool and y.dim() == 2
          and y.shape[0] in (1, lead) and y.shape[1] == h,
          f"labels {y.dtype} {tuple(y.shape)}, want bool [1 or {lead}, {h}]")
    if u is None:
        _want(v is None and lead == 1 and rows_u.shape[0] == h
              and rows_v.shape[0] == h,
              f"gathered rows {tuple(rows_u.shape)} / "
              f"{tuple(rows_v.shape)} for {lead} chain(s) of {h} pairs")
    else:
        _want(v is not None and all(
            t.dtype == torch.int32 and tuple(t.shape) == (h,)
            for t in (u, v)), f"row ids {u.dtype} {tuple(u.shape)}, want "
            f"int32 ({h},)")
        _want(rows_u.shape[0] >= lead * cfg.N, f"rows "
              f"{tuple(rows_u.shape)} hold fewer than {lead} x N = "
              f"{lead * cfg.N}")
    if mask is not None:
        _want(mask.dtype == torch.bool and tuple(mask.shape) == (h,),
              f"mask {mask.dtype} {tuple(mask.shape)}, want bool ({h},)")
    count = avg_count if isinstance(avg_count, torch.Tensor) else None
    if count is not None:
        _want(count.dtype == torch.float32 and count.numel() == 1,
              f"count {count.dtype} {tuple(count.shape)}, want one float32")
    tensors = [t for t in (rows_u, rows_v, beta, u, v, y, ppx, mask, count)
               if t is not None]
    _want(all(t.is_contiguous() for t in tensors), "not contiguous")
    dev = rows_u.device
    _want(dev.type == "cuda" and all(t.device == dev for t in tensors),
          f"the kernel takes tensors on one CUDA device, got "
          f"{sorted({str(t.device) for t in tensors})}")
    return lead, h


def _one_chain(res: PpxResult) -> PpxResult:
    """A one-chain ``likelihood_cuda`` result without its chain axis:
    [H] averages and 0-d scalars."""
    return PpxResult(*(t[0] for t in res))


def likelihood_cuda(cfg: Config, rows_u: torch.Tensor, rows_v: torch.Tensor,
                    beta: torch.Tensor, u: Optional[torch.Tensor],
                    v: Optional[torch.Tensor], y: torch.Tensor,
                    ppx_per_edge: torch.Tensor, avg_count,
                    mask: Optional[torch.Tensor] = None) -> PpxResult:
    """One evaluation of C chains in one launch pair of
    ``csrc/ppx_kernel.cu``: what ``blocked_likelihood`` then
    ``fold_likelihood`` give, from the stored rows (float32 or bf16) with
    no [rows, K] temporary. The chains are the rows of the running
    averages ``ppx_per_edge`` [C, H]; chain c has its ``beta`` row [C, K]
    and its ``y`` row [C, H] (or all share one, [1, H]). Pair p of chain c
    reads row ``u[p] + c N`` of ``rows_u`` and ``v[p] + c N`` of
    ``rows_v`` (pi twice on the main path), or, with one chain, row p of
    each where ``u`` and ``v`` are None (gathered rows). ``mask`` [H]
    excludes lanes from the sums and keeps their averages; ``avg_count``
    an integer or its ``count_operand``. Returns [C, H] averages and [C]
    scalars. CUDA tensors only: the kernel is launched or this raises."""
    lead, h = _check_operands(cfg, rows_u, rows_v, beta, u, v, y,
                              ppx_per_edge, avg_count, mask)
    lib = _ppx_lib()
    dev = rows_u.device
    aligned = all(t.data_ptr() % 16 == 0 for t in (rows_u, rows_v, beta))
    vec, tpp = ppx_plan(cfg.K, rows_u.element_size(), aligned)
    blocks = -(-h // (PPX_CTA_THREADS // tpp))
    ppx_new = torch.empty_like(ppx_per_edge)
    part_lik = torch.empty(lead, blocks, 2, dtype=torch.float64, device=dev)
    part_cnt = torch.empty(lead, blocks, 2, dtype=torch.int64, device=dev)
    out_f = torch.empty(3, lead, device=dev)
    out_i = torch.empty(2, lead, dtype=torch.int64, device=dev)
    count = avg_count if isinstance(avg_count, torch.Tensor) else None
    err = lib.ppx_launch(
        rows_u.data_ptr(), rows_v.data_ptr(),
        None if u is None else u.data_ptr(),
        None if v is None else v.data_ptr(), beta.data_ptr(), y.data_ptr(),
        None if mask is None else mask.data_ptr(), ppx_per_edge.data_ptr(),
        None if count is None else count.data_ptr(), ppx_new.data_ptr(),
        part_lik.data_ptr(), part_cnt.data_ptr(), out_f.data_ptr(),
        out_i.data_ptr(), h if y.shape[0] > 1 else 0, cfg.N, h, cfg.K, lead,
        tpp, PPX_CTA_THREADS, blocks, int(vec > 1),
        int(rows_u.dtype == torch.bfloat16),
        0.0 if count is not None else float(avg_count), 1.0 - cfg.epsilon,
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch(err, "evaluation kernel")
    likelihood_cuda.launches += 1
    return PpxResult(ppx_new, out_f[2], out_f[0], out_f[1], out_i[0],
                     out_i[1])


#: Evaluations through the kernel in this process (reset by callers that
#: check a run went through it).
likelihood_cuda.launches = 0
