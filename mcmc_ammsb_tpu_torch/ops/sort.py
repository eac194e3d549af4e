"""Batched in-row bitonic sort (counterpart of ``mcmc_ammsb_tpu/ops/sort.py``).

The reference sorts one power-of-two segment per workgroup with a
local-memory compare-exchange network (WG_SORT_TT), built and tested
there but unused by the training path; the same holds here. The network
is the JAX package's: a fixed sequence of static lane permutations and
min/max selects over the last axis, every row sorted independently, as
torch ops. ``torch.sort`` is the tool for real sorting needs; this module
exists for parity with the JAX package.
"""

from __future__ import annotations

import torch


def bitonic_sort_rows(x: torch.Tensor, descending: bool = False
                      ) -> torch.Tensor:
    """Sort each row (last axis) of ``x`` with a bitonic network.

    A row whose length is not a power of two is padded with +inf (-inf
    when descending) for a float dtype, the dtype's largest (smallest)
    integer otherwise, sorted at the padded width and cut back, so the
    padding sinks to the tail."""
    n = x.shape[-1]
    if n <= 1:
        return x
    m = 1 << (n - 1).bit_length()
    if x.is_floating_point():
        pad_val = float("-inf") if descending else float("inf")
    else:
        info = torch.iinfo(x.dtype)
        pad_val = info.min if descending else info.max
    if m != n:
        pad = x.new_full((*x.shape[:-1], m - n), pad_val)
        x = torch.cat([x, pad], dim=-1)
    idx = torch.arange(m, device=x.device)
    k = 2
    while k <= m:
        j = k >> 1
        while j >= 1:
            partner = idx ^ j                       # static permutation
            px = x[..., partner]
            keep_small = ((idx & k) == 0) == (idx < partner)
            if descending:
                keep_small = ~keep_small
            x = torch.where(keep_small, torch.minimum(x, px),
                            torch.maximum(x, px))
            j >>= 1
        k <<= 1
    return x[..., :n]
