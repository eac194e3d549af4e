"""Device edge membership, ``has_edges(u, v) -> bool[...]`` (counterpart
of ``mcmc_ammsb_tpu/ops/edgeset.py``).

Only the ADJACENCY backend is ported: a padded [N, max_degree] int32
matrix of each node's neighbors, pad -1. AUTO resolves exactly as in the
JAX package — the matrix when it fits 1 GiB, else the CHD perfect hash —
and the perfect hash, CSR, SORTED and CUCKOO backends raise until
ROADMAP queue 1 item 3 ports them.
"""

from __future__ import annotations

import numpy as np
import torch

from mcmc_ammsb_tpu_torch.config import EdgeSetBackend
from mcmc_ammsb_tpu_torch.data import Graph

#: Default memory budget for the AUTO backend's adjacency matrix.
ADJACENCY_AUTO_BUDGET_BYTES = 1 << 30


class EdgeSet:
    """Static edge set with batched membership lookup (adjacency)."""

    backend = "adjacency"

    def __init__(self, matrix: torch.Tensor):
        self.matrix = matrix                      # [N, F] int32
        self.num_nodes = matrix.shape[0]

    def has_edges(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Batched membership test over broadcastable u, v.

        JAX clamps an out-of-range gather index; torch faults on one. The
        padded node lanes carry the sentinel N, so the row index is
        clamped to N-1 here, which gives the JAX package's answers."""
        if v.numel() < u.numel():
            u, v = v, u                           # adjacency is symmetric
        rows = self.matrix[u.long().clamp(0, self.num_nodes - 1)]
        return torch.any(rows == v.to(torch.int32)[..., None], dim=-1)


def _build_adjacency_matrix(num_nodes: int, u: np.ndarray,
                            v: np.ndarray) -> np.ndarray:
    """Padded [N, F] adjacency matrix; pad value -1 (matches no vertex,
    including the N sentinel used for padded query lanes)."""
    g = Graph.from_edges(num_nodes, u, v)
    deg = g.offsets[1:] - g.offsets[:-1]
    f = max(1, int(deg.max()) if len(deg) else 1)
    matrix = np.full((num_nodes, f), -1, np.int32)
    row = np.repeat(np.arange(num_nodes), deg)
    pos = np.arange(len(g.cols)) - np.repeat(g.offsets[:-1], deg)
    matrix[row, pos] = g.cols
    return matrix


def resolve_backend(backend: EdgeSetBackend, num_nodes: int,
                    u: np.ndarray, v: np.ndarray) -> EdgeSetBackend:
    """AUTO -> ADJACENCY when the padded matrix fits the budget, else
    PERFECT (the JAX package's rule)."""
    if backend != EdgeSetBackend.AUTO:
        return backend
    deg = np.bincount(np.concatenate([u, v]).astype(np.int64),
                      minlength=num_nodes)
    f = max(1, int(deg.max()) if len(deg) else 1)
    fits = num_nodes * f * 4 <= ADJACENCY_AUTO_BUDGET_BYTES
    return EdgeSetBackend.ADJACENCY if fits else EdgeSetBackend.PERFECT


def build_edge_set(backend: EdgeSetBackend, num_nodes: int,
                   u: np.ndarray, v: np.ndarray, device) -> EdgeSet:
    """Build a device EdgeSet from canonical host edges (u < v)."""
    backend = resolve_backend(backend, num_nodes, u, v)
    if backend != EdgeSetBackend.ADJACENCY:
        raise NotImplementedError(
            f"edge-set backend {backend.value!r} is not ported yet "
            "(ROADMAP queue 1 item 3: perfect, csr, sorted, cuckoo)")
    return EdgeSet(torch.as_tensor(
        _build_adjacency_matrix(num_nodes, u, v), device=device))
