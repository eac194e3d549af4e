"""Edge/vertex types and packing helpers (a copy of
``mcmc_ammsb_tpu/types.py``; see config.py for why it is copied).

The reference packs an undirected edge (u, v), u < v, into a uint64
``(u << 32) | v`` (reference mcmc/types.h:66-74). On TPU we keep
edges as pairs of int32 device-side (XLA:TPU handles 32-bit natively;
64-bit integers are emulated) and use the packed uint64 form only for
host-side storage/serialization parity.
"""

from __future__ import annotations

import numpy as np

# Host-side dtypes
VERTEX_DTYPE = np.int32
EDGE_DTYPE = np.uint64


def pack_edges(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(u, v) -> uint64 (u << 32) | v, matching mcmc/types.h:66-68."""
    return (np.asarray(u, np.uint64) << np.uint64(32)) | np.asarray(v, np.uint64)


def unpack_edges(e: np.ndarray):
    """uint64 -> (u, v), matching mcmc/types.h:70-74."""
    e = np.asarray(e, np.uint64)
    u = (e >> np.uint64(32)).astype(VERTEX_DTYPE)
    v = (e & np.uint64(0xFFFFFFFF)).astype(VERTEX_DTYPE)
    return u, v


def canonicalize(u: np.ndarray, v: np.ndarray):
    """Order endpoints so u <= v (undirected canonical form)."""
    u = np.asarray(u)
    v = np.asarray(v)
    return np.minimum(u, v), np.maximum(u, v)
