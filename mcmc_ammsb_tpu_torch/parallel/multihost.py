"""Multi-process execution: process-group start-up, the global mesh, and
host-local dataset ingestion (counterpart of
``mcmc_ammsb_tpu/parallel/multihost.py``).

  * ``initialize()``  — the torch.distributed process group: started by
                        ``torchrun`` (env ``RANK``, ``WORLD_SIZE``,
                        ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``),
                        by the JAX CLI's flags ``--coordinator HOST:PORT
                        --num-processes P --process-id I`` (a TCP
                        rendezvous at the coordinator), or, in a lone
                        process, a group of size 1 on an in-memory store;
  * ``global_mesh()`` — ('data', 'model') mesh over every rank, the
                        model axis kept within a host;
  * byte-range ETL    — each process parses only its slice of a SNAP
                        file (``byte_ranges`` + ``load_snap_edges_range``),
                        renumbers against a shared vocabulary
                        (``global_vocab``, ``renumber_edges``) and builds
                        only the CSR rows its model shard owns
                        (``shard_csr``). numpy throughout; the arrays are
                        the JAX package's, exactly.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mcmc_ammsb_tpu_torch.parallel.mesh import (Mesh, backend_for,
                                                rank_device)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device="cuda") -> bool:
    """Start the default process group, unless one is running; returns
    True when this call started it (the caller then ends it with
    ``dist.destroy_process_group``).

    The backend follows ``device``: NCCL on a card, gloo on the CPU. If
    NCCL cannot start, this raises: there is no fallback to gloo. A CUDA
    rank selects its card (``mesh.rank_device``) before the group
    starts."""
    if dist.is_initialized():
        return False
    backend = backend_for(device)
    if num_processes is not None and num_processes > 1:
        if not coordinator_address:
            raise ValueError("--num-processes > 1 needs --coordinator "
                             "HOST:PORT (process 0's address)")
        kw = dict(init_method=f"tcp://{coordinator_address}",
                  world_size=num_processes, rank=process_id or 0)
        rank = process_id or 0
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        kw = dict(init_method="env://")       # torchrun
        rank = int(os.environ["RANK"])
    else:
        kw = dict(store=dist.HashStore(), world_size=1, rank=0)
        rank = 0
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available (pass "
                               "--device cpu to run on the CPU)")
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, **kw)
    return True


def global_mesh(n_model: Optional[int] = None, device="cuda") -> Mesh:
    """('data', 'model') mesh over ALL ranks, the model axis kept within
    a host (its ``LOCAL_WORLD_SIZE`` ranks) when possible so pi row
    fetches stay on NVLink and only the small gradient sums cross
    hosts."""
    n = dist.get_world_size()
    per_host = max(1, int(os.environ.get("LOCAL_WORLD_SIZE", n)))
    if n_model is None:
        n_model = min(per_host, 4)
        while n % n_model:
            n_model //= 2
    return Mesh(n // n_model, n_model, rank_device(device))


# ---------------------------------------------------------------------------
# Host-local ETL: byte-range parsing + per-shard CSR
# ---------------------------------------------------------------------------

def byte_ranges(path: str, num_ranges: int) -> list:
    """Split a text file into ``num_ranges`` newline-aligned [start, end)
    byte ranges that exactly partition it: range i starts at the first
    line boundary at-or-after i * size/num_ranges. Every line belongs to
    exactly one range, so per-process parses union to the full file."""
    size = os.path.getsize(path)
    cuts = [0]
    with open(path, "rb") as f:
        for i in range(1, num_ranges):
            f.seek((size * i) // num_ranges)
            f.readline()  # skip to the end of the straddling line
            cuts.append(min(f.tell(), size))
    cuts.append(size)
    return [(cuts[i], cuts[i + 1]) for i in range(num_ranges)]


def load_snap_edges_range(path: str, start: int,
                          end: int) -> Tuple[np.ndarray, np.ndarray]:
    """Parse the SNAP edge lines whose first byte lies in [start, end).

    Returns RAW (unrenumbered) endpoint arrays; comment lines (``#``,
    ``%``) and lines of fewer than two fields skipped, self-loops
    dropped, pairs canonicalized to u < v — the whole-file loader's
    per-line semantics. ``start`` must be a line boundary (use
    byte_ranges). The range is read in one piece and split into lines,
    the line that straddles ``end`` completed."""
    with open(path, "rb") as f:
        f.seek(start)
        buf = f.read(max(0, end - start))
        if buf and not buf.endswith(b"\n"):
            buf += f.readline()
    pairs = [p[:2] for p in (ln.split() for ln in buf.split(b"\n")
                             if not ln.startswith((b"#", b"%")))
             if len(p) >= 2]
    raw = np.array([(int(a), int(b)) for a, b in pairs],
                   np.int64).reshape(-1, 2)
    raw = raw[raw[:, 0] != raw[:, 1]]
    return (np.minimum(raw[:, 0], raw[:, 1]),
            np.maximum(raw[:, 0], raw[:, 1]))


def allgather_arrays(arr: np.ndarray) -> list:
    """Every process's ``arr`` (any length), in rank order, through one
    ``all_gather_object``; a lone process gets its own back."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return [arr]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, np.ascontiguousarray(arr))
    return out


def global_vocab(local_ids: np.ndarray) -> np.ndarray:
    """Shared vocabulary: sorted unique original vertex ids across all
    processes (ids are metadata-sized — ~N entries — not edge-sized)."""
    local = np.unique(local_ids)
    return np.unique(np.concatenate(allgather_arrays(local)))


def renumber_edges(u_raw: np.ndarray, v_raw: np.ndarray,
                   vocab: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Map raw vertex ids to [0, N) positions in the shared vocabulary."""
    u = np.searchsorted(vocab, u_raw).astype(np.int32)
    v = np.searchsorted(vocab, v_raw).astype(np.int32)
    return np.minimum(u, v), np.maximum(u, v)


def shard_csr(num_nodes: int, u: np.ndarray, v: np.ndarray,
              row_lo: int, row_hi: int) -> Tuple[np.ndarray, np.ndarray]:
    """CSR adjacency restricted to owned rows [row_lo, row_hi).

    offsets has row_hi - row_lo + 1 entries (local row indexing); cols
    are GLOBAL node ids. Concatenating all shards' adjacency lists
    reproduces the full-graph CSR."""
    src = np.concatenate([u, v])
    dst = np.concatenate([v, u])
    keep = (src >= row_lo) & (src < row_hi)
    src = src[keep] - row_lo
    dst = dst[keep]
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    counts = np.bincount(src, minlength=row_hi - row_lo)
    offsets = np.zeros(row_hi - row_lo + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    return offsets, dst.astype(np.int32)
