"""Row collectives (counterpart of ``mcmc_ammsb_tpu/ops/rowops.py``): the
reference's workgroup reductions (WG_SUM, WG_NORMALIZE, WG_SORT_TT and
the fixed-slice Normalizer) as torch row ops."""

from __future__ import annotations

import torch


def row_sums(x: torch.Tensor) -> torch.Tensor:
    """Per-row sum of a [rows, cols] matrix."""
    return torch.sum(x, dim=-1)


def row_normalize(x: torch.Tensor):
    """Normalize each row to sum 1; returns (normalized, sums)."""
    s = torch.sum(x, dim=-1, keepdim=True)
    return x / s, s.squeeze(-1)


def row_sort(x: torch.Tensor) -> torch.Tensor:
    """Per-row ascending sort."""
    return torch.sort(x, dim=-1).values


def slice_normalize(x: torch.Tensor, slice_size: int) -> torch.Tensor:
    """Normalize a flat vector in consecutive groups of ``slice_size``
    (slice 2 turns theta pairs into beta)."""
    g = x.reshape(-1, slice_size)
    return (g / torch.sum(g, dim=-1, keepdim=True)).reshape(x.shape)
