"""On-device neighbor sampler (counterpart of
``mcmc_ammsb_tpu/ops/neighbor.py``): for each row node draw ``n``
uniform candidates from [0, N), then run fixup rounds that redraw any
candidate equal to the node or to an earlier candidate of its row."""

from __future__ import annotations

import torch

from mcmc_ammsb_tpu_torch import rng


def sample_neighbors(gen: torch.Generator, nodes: torch.Tensor,
                     num_nodes: int, num_samples: int,
                     rounds: int = 4) -> torch.Tensor:
    """``nodes`` [..., B] int32 -> [..., B, n] int32 neighbor ids,
    distinct per row and != node. Leading axes batch independent draws
    (the hoisted loop draws all S steps at once)."""
    shape = (*nodes.shape, num_samples)
    draw = rng.randint(gen, num_nodes, shape, nodes.device)
    earlier = torch.ones(num_samples, num_samples, dtype=torch.bool,
                         device=nodes.device).tril(-1)
    for _ in range(rounds):
        eq_node = draw == nodes[..., None]
        eq_pair = draw[..., :, None] == draw[..., None, :]
        bad = eq_node | torch.any(eq_pair & earlier, dim=-1)
        redraw = rng.randint(gen, num_nodes, shape, nodes.device)
        draw = torch.where(bad, redraw, draw)
    return draw
