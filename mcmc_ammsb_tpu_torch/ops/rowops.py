"""Row collectives (counterpart of ``mcmc_ammsb_tpu/ops/rowops.py``)."""

from __future__ import annotations

import torch


def row_normalize(x: torch.Tensor):
    """Normalize each row to sum 1; returns (normalized, sums)."""
    s = torch.sum(x, dim=-1, keepdim=True)
    return x / s, s.squeeze(-1)
