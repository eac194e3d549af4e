"""Device edge membership, ``has_edges(u, v) -> bool[...]``, batched
(counterpart of ``mcmc_ammsb_tpu/ops/edgeset.py``).

Five backends behind one class, the JAX package's tables and answers:

  * ``adjacency`` - a padded [N, max_degree] int32 matrix of each node's
    neighbors, pad -1: one row gather per query of the smaller side;
  * ``perfect``   - a CHD perfect hash built once on the host: two
    dependent gathers per query (displacement, then the stored pair);
  * ``csr``       - binary search in the node's sorted adjacency row;
  * ``sorted``    - lexicographic binary search over all canonical edges;
  * ``cuckoo``    - the reference's 2 buckets x bins x 4 slots layout,
    split into 32-bit endpoint planes.

AUTO resolves as in the JAX package: the matrix when it fits 1 GiB, else
the perfect hash (O(E) memory always). The lookups are torch ops on the
tables' device (XLA ops in the JAX package, so no hand kernel here).
``chip_smoke.py``'s membership phase times each backend on the card.

Integer arithmetic. The hashes are defined mod 2^32 (the perfect hash)
and mod 2^64 (the cuckoo hash of the packed key u * 2^32 + v). torch has
no unsigned types to compute in, so the lookups run in int64 lanes that
never overflow: a 32 x 32-bit product whose constant is >= 2^31 is formed
from two 48-bit products (``_mul_u32``) and masked to 32 bits after every
multiply and add; the cuckoo product P1 * key mod 2^64 is formed from its
32-bit halves, each a 55-bit product, and reduced mod the bin count with
one int64 multiply and remainder. The 16-bit-limb full product and the
32-round shift-add modular product of the JAX package (a TPU has no
64-bit integers) are not carried over; the answers are the same
(tests/test_torch_edgeset.py holds them against Python integers).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from mcmc_ammsb_tpu_torch.config import EdgeSetBackend
from mcmc_ammsb_tpu_torch.data import Graph

#: Default memory budget for the AUTO backend's adjacency matrix.
ADJACENCY_AUTO_BUDGET_BYTES = 1 << 30

# First prime pair of the reference's cuckoo set.
_CUCKOO_P1 = 15485807
_CUCKOO_P2 = 920429591
_EMPTY64 = np.uint64(0xFFFFFFFFFFFFFFFF)

# Perfect-hash (CHD) mixing constants. The bucket hash and the slot hash
# use independent linear bases: at E ~ 1M keys any scheme that derives
# both from one shared 32-bit intermediate suffers ~E^2/2^33 birthday
# collisions of that intermediate, which collide both hashes and make
# construction fail for every seed.
_PH_C1 = 0x9E3779B1
_PH_C2 = 0x85EBCA77
_PH_C3 = 0x2545F491
_PH_C4 = 0xC2B2AE35
_PH_C5 = 0x27D4EB2F
_FMIX_M1 = 0x7FEB352D
_FMIX_M2 = 0x846CA68B
_MASK32 = 0xFFFFFFFF


class EdgeSet:
    """Static edge set with batched membership lookup.

    backend 'adjacency': arrays = (matrix [N, F] i32, pad -1)
    backend 'csr':    arrays = (offsets [N+1] i32, cols [M] i32 row-sorted)
    backend 'sorted': arrays = (keys_u [E] i32, keys_v [E] i32), sorted
                      lexicographically on canonical (u < v) pairs
    backend 'cuckoo': arrays = (slots_u [2, bins, 4] i32,
                      slots_v [2, bins, 4] i32); empty slots hold
                      (-1, -1). meta['num_bins'].
    backend 'perfect': arrays = (displacements [NB] i32, table [M, 2]
                      i32 canonical key pairs, empty = (-1, -1));
                      meta carries slot_mask/bucket_mask/seed.
    """

    def __init__(self, backend: str, num_nodes: int, num_search_steps: int,
                 meta: Tuple[Tuple[str, int], ...],
                 arrays: Tuple[torch.Tensor, ...]):
        self.backend = backend
        self.num_nodes = num_nodes
        self.num_search_steps = num_search_steps
        self.meta = tuple(meta)
        self.arrays = tuple(arrays)

    @property
    def device(self) -> torch.device:
        return self.arrays[0].device

    def has_edges(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Batched membership test over broadcastable integer u, v.

        Queries need not be canonical. JAX clamps an out-of-range gather
        index and torch faults on one, so every table index is clamped
        here, which gives the JAX package's answers: padded node lanes
        that carry the sentinel N read node N-1's row of the adjacency
        matrix and an empty row of the CSR."""
        if self.backend == "adjacency":
            # gathers rows for the smaller query side before broadcasting
            return _adjacency_has_edges(self, u, v)
        u, v = torch.broadcast_tensors(u.long(), v.long())
        if self.backend == "csr":
            return _csr_has_edges(self, u, v)
        if self.backend == "sorted":
            return _sorted_has_edges(self, u, v)
        if self.backend == "cuckoo":
            return _cuckoo_has_edges(self, u, v)
        if self.backend == "perfect":
            return _perfect_has_edges(self, u, v)
        raise ValueError(self.backend)


def _adjacency_has_edges(s: EdgeSet, u, v):
    (matrix,) = s.arrays
    if v.numel() < u.numel():
        u, v = v, u                           # adjacency is symmetric
    rows = matrix[u.long().clamp(0, s.num_nodes - 1)]
    return torch.any(rows == v.to(torch.int32)[..., None], dim=-1)


def _lower_bound(num_steps: int, lo, hi, less_fn):
    """Vectorized lower bound: smallest i in [lo, hi) with !less(i), by a
    binary search of a fixed ``num_steps`` trips (the range halves per
    step), branch-free per lane."""
    for _ in range(num_steps):
        active = lo < hi
        mid = (lo + hi) >> 1
        less = less_fn(mid)
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    return lo


def _csr_has_edges(s: EdgeSet, u, v):
    """v in the sorted adjacency row of u (symmetric: no canonical
    order needed)."""
    offsets, cols = s.arrays
    m = cols.shape[0]
    last = offsets.shape[0] - 1
    lo0 = offsets[u.clamp(0, last)].long()
    hi0 = offsets[(u + 1).clamp(0, last)].long()

    def less(mid):
        return cols[mid.clamp(0, m - 1)] < v

    pos = _lower_bound(s.num_search_steps, lo0, hi0, less)
    return (pos < hi0) & (cols[pos.clamp(0, m - 1)] == v)


def _sorted_has_edges(s: EdgeSet, u, v):
    keys_u, keys_v = s.arrays
    cu = torch.minimum(u, v)
    cv = torch.maximum(u, v)
    n = keys_u.shape[0]
    lo0 = torch.zeros_like(cu)
    hi0 = torch.full_like(cu, n)

    def less(mid):
        m = mid.clamp(0, n - 1)
        mu = keys_u[m]
        return (mu < cu) | ((mu == cu) & (keys_v[m] < cv))

    pos = _lower_bound(s.num_search_steps, lo0, hi0, less)
    m = pos.clamp(0, n - 1)
    return (pos < n) & (keys_u[m] == cu) & (keys_v[m] == cv)


def _mul_u32(x, c: int):
    """(x * c) mod 2^32 for int64 lanes 0 <= x < 2^32 and a constant
    0 <= c < 2^32, without overflowing int64: a constant of 32 bits is
    split into 16-bit halves (two products below 2^48)."""
    if c < (1 << 31):
        return (x * c) & _MASK32
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _MASK32


def _fmix32(x):
    """The 32-bit avalanche mixer (xor-shift-multiply finalizer) on
    int64 lanes that hold values below 2^32."""
    x = x ^ (x >> 16)
    x = _mul_u32(x, _FMIX_M1)
    x = x ^ (x >> 15)
    x = _mul_u32(x, _FMIX_M2)
    return x ^ (x >> 16)


def _perfect_hashes(cu, cv, seed: int, bucket_mask: int, slot_mask: int):
    """(bucket, slot hash before displacement) of canonical pairs:
      bucket = fmix32(u*C1 + v*C2 + seed)        & bucket_mask
      h2     = fmix32(u*C4 + v*C5 + (seed ^ C3)) & slot_mask
    every product and sum mod 2^32."""
    b = _fmix32((_mul_u32(cu, _PH_C1) + _mul_u32(cv, _PH_C2) + seed)
                & _MASK32) & bucket_mask
    h2 = _fmix32((_mul_u32(cu, _PH_C4) + _mul_u32(cv, _PH_C5)
                  + (seed ^ _PH_C3)) & _MASK32) & slot_mask
    return b, h2


def _perfect_has_edges(s: EdgeSet, u, v):
    d_arr, table = s.arrays
    meta = dict(s.meta)
    mask = meta["slot_mask"]
    cu = torch.minimum(u, v)
    cv = torch.maximum(u, v)
    # int32 ids reinterpreted as uint32, as the JAX package's astype does
    b, h2 = _perfect_hashes(cu & _MASK32, cv & _MASK32, meta["seed"],
                            meta["bucket_mask"], mask)
    d = d_arr[b].long() & _MASK32
    pair = table[(h2 + d) & mask]                          # [..., 2]
    return (pair[..., 0] == cu) & (pair[..., 1] == cv)


def _cuckoo_hashes(cu, cv, num_bins: int):
    """(hash1, hash2) of the packed key u * 2^32 + v on int64 lanes:
      hash1 = ((P1 * key) mod 2^64) % bins
      hash2 = (key ^ P2) % bins           (the xor touches the low word)
    P1 * key mod 2^64 = ((hi(P1 v) + lo(P1 u)) mod 2^32) 2^32 + lo(P1 v),
    with P1 < 2^24 and ids < 2^32, so both products stay below 2^56."""
    pow32 = (1 << 32) % num_bins
    pv = cv * _CUCKOO_P1
    prod_hi = ((pv >> 32) + ((cu * _CUCKOO_P1) & _MASK32)) & _MASK32
    h1 = (prod_hi * pow32 + (pv & _MASK32)) % num_bins
    h2 = (cu * pow32 + (cv ^ _CUCKOO_P2)) % num_bins
    return h1, h2


def _cuckoo_has_edges(s: EdgeSet, u, v):
    slots_u, slots_v = s.arrays
    num_bins = dict(s.meta)["num_bins"]
    cu = torch.minimum(u, v)
    cv = torch.maximum(u, v)
    h1, h2 = _cuckoo_hashes(cu & _MASK32, cv & _MASK32, num_bins)

    def probe(bucket, h):
        return torch.any((slots_u[bucket][h] == cu[..., None])
                         & (slots_v[bucket][h] == cv[..., None]), dim=-1)

    return probe(0, h1) | probe(1, h2)


# ---------------------------------------------------------------------------
# Host-side construction (numpy; the CHD attempt and the cuckoo walk run in
# the native library when it is built)
# ---------------------------------------------------------------------------

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


def _fmix32_numpy(x):
    """``_fmix32`` on numpy uint32 arrays (which wrap mod 2^32)."""
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(_FMIX_M1)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(_FMIX_M2)
    return x ^ (x >> np.uint32(16))


def _chd_attempt_numpy(cu, cv, M: int, NB: int, s: np.uint32):
    """One CHD construction attempt in vectorized numpy (uint32 ``cu``,
    ``cv``; the native ``chd_build`` runs the same greedy with the same
    hashes). Returns (d_arr, slot_of in original edge order), or None
    when this seed fails."""
    E = len(cu)
    c1, c2, c3, c4, c5 = (np.uint32(c) for c in (_PH_C1, _PH_C2, _PH_C3,
                                                  _PH_C4, _PH_C5))
    b = (_fmix32_numpy(cu * c1 + cv * c2 + s)
         & np.uint32(NB - 1)).astype(np.int64)
    h2 = (_fmix32_numpy(cu * c4 + cv * c5 + (s ^ c3))
          & np.uint32(M - 1)).astype(np.int64)
    order = np.argsort(b, kind="stable")
    bs, h2s = b[order], h2[order]
    starts = np.searchsorted(bs, np.arange(NB))
    ends = np.searchsorted(bs, np.arange(NB), side="right")
    sizes = ends - starts
    bucket_order = np.argsort(-sizes, kind="stable")
    taken = np.zeros(M, bool)
    d_arr = np.zeros(NB, np.int32)
    slot_sorted = np.empty(E, np.int64)
    mask = M - 1
    trial_block = np.arange(64)
    for bi in bucket_order:
        k = sizes[bi]
        if k == 0:
            continue
        hs = h2s[starts[bi]:ends[bi]]
        if len(np.unique(hs)) != int(k):
            return None             # same slot for every displacement
        found = -1
        for dbase in range(0, 1 << 16, 64):
            cand = (hs[None, :] + (trial_block + dbase)[:, None]) & mask
            good = np.nonzero(~taken[cand].any(axis=1))[0]
            if len(good):
                found = dbase + int(good[0])
                slots = cand[good[0]]
                break
        if found < 0:
            return None
        d_arr[bi] = found
        taken[slots] = True
        slot_sorted[starts[bi]:ends[bi]] = slots
    slot_of = np.empty(E, np.int64)
    slot_of[order] = slot_sorted
    return d_arr, slot_of


def _use_native(use_native) -> bool:
    from mcmc_ammsb_tpu_torch import native
    return native.available() if use_native is None else bool(use_native)


def _build_perfect_host(u: np.ndarray, v: np.ndarray, seed: int = 1,
                        use_native=None):
    """CHD construction: greedy displacement search, largest buckets
    first, M = the next power of two of E / 0.8 slots and E // 4 buckets
    rounded up to a power of two (every mod is a bitwise AND on the
    device); up to 16 hash seeds on the rare within-bucket collision of
    the slot hash. ``use_native``: None takes the native ``chd_build``
    when it is built, else the numpy attempt; both give identical tables.
    Returns (displacements, table [M, 2], slot_mask, bucket_mask, seed)."""
    from mcmc_ammsb_tpu_torch import native

    E = len(u)
    u = np.asarray(u, np.int64)
    v = np.asarray(v, np.int64)
    M = 1 << int(np.ceil(np.log2(max(2, E / 0.8))))
    NB = 1 << max(0, int(np.ceil(np.log2(max(1, E // 4)))))
    use_native = _use_native(use_native)
    with np.errstate(over="ignore"):
        cu = u.astype(np.uint32)
        cv = v.astype(np.uint32)
        for attempt in range(16):
            s = np.uint32((seed + attempt * 0x9E3779B9) & 0xFFFFFFFF)
            if use_native:
                res = native.chd_build(
                    u.astype(np.int32), v.astype(np.int32), M, NB, int(s))
            else:
                res = _chd_attempt_numpy(cu, cv, M, NB, s)
            if res is None:
                continue
            d_arr, slot_of = res
            table = np.full((M, 2), -1, np.int32)
            table[slot_of, 0] = u
            table[slot_of, 1] = v
            return d_arr, table, M - 1, NB - 1, int(s)
    raise RuntimeError(
        f"perfect-hash build failed after 16 seeds (E={E}, M={M})")


def _cuckoo_try_numpy(keys: np.ndarray, num_bins: int,
                      rng: np.random.RandomState):
    """One placement attempt in Python (a random-walk displacement is
    sequential: one interpreter iteration per move); returns the slots or
    None on failure. The native ``cuckoo_try`` walks with its own random
    stream, so its table differs from this one where a key was evicted;
    both are valid for the lookup."""
    n = len(keys)
    p1, p2, bins = (np.uint64(x) for x in (_CUCKOO_P1, _CUCKOO_P2, num_bins))
    slots = np.full((2, num_bins, 4), _EMPTY64)
    for key in keys:
        k = np.uint64(key)
        placed = False
        bucket = 0
        for _disp in range(max(64, n // 2 + 1)):
            h = int((p1 * k) % bins if bucket == 0 else (k ^ p2) % bins)
            row = slots[bucket, h]
            empty = np.nonzero(row == _EMPTY64)[0]
            if len(empty):
                row[empty[0]] = k
                placed = True
                break
            # evict a random occupant, retry it in the other bucket
            j = rng.randint(4)
            k, row[j] = row[j], k
            bucket = 1 - bucket
        if not placed:
            return None
    return slots


def _build_cuckoo_host(u: np.ndarray, v: np.ndarray, use_native=None):
    """Host cuckoo build: 2 buckets x bins x 4 slots at load factor
    1/1.15, random-walk displacement, the table grown by 1.3x on a failed
    walk (12 attempts). The uint64 hash arithmetic wraps on purpose.
    Returns (slots_u, slots_v, num_bins); empty slots are (-1, -1)."""
    from mcmc_ammsb_tpu_torch import native

    n = len(u)
    keys = ((np.asarray(u, np.uint64) << np.uint64(32))
            | np.asarray(v, np.uint64))
    num_bins = int(1 + np.ceil((1.15 * max(n, 1)) / (2 * 4)))
    use_native = _use_native(use_native)
    rng = np.random.RandomState(42)
    with np.errstate(over="ignore"):
        for attempt in range(12):
            if use_native:
                slots = native.cuckoo_try(keys, num_bins, seed=42 + attempt)
            else:
                slots = _cuckoo_try_numpy(keys, num_bins, rng)
            if slots is not None:
                break
            num_bins = int(num_bins * 1.3) + 1
        else:
            raise RuntimeError("cuckoo build failed")
    # the all-ones empty slot becomes -1 in both int32 planes
    su = (slots >> np.uint64(32)).astype(np.uint32).view(np.int32)
    sv = (slots & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    return su, sv, num_bins


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


def build_host_tables(backend: EdgeSetBackend, num_nodes: int,
                      u: np.ndarray, v: np.ndarray, use_native=None):
    """The numpy tables of ``backend`` (AUTO resolved) for canonical host
    edges (u < v): (backend name, search steps, meta, arrays)."""
    backend = resolve_backend(backend, num_nodes, u, v)
    if backend == EdgeSetBackend.ADJACENCY:
        return ("adjacency", 1, (),
                (_build_adjacency_matrix(num_nodes, u, v),))
    if backend == EdgeSetBackend.CSR:
        g = Graph.from_edges(num_nodes, u, v)
        steps = max(1, math.ceil(math.log2(g.max_fan_out + 1)) + 1)
        return ("csr", steps, (),
                (g.offsets.astype(np.int32), g.cols.astype(np.int32)))
    if backend == EdgeSetBackend.SORTED:
        order = np.lexsort((v, u))
        su, sv = np.asarray(u)[order], np.asarray(v)[order]
        steps = max(1, math.ceil(math.log2(len(su) + 1)) + 1)
        return ("sorted", steps, (),
                (su.astype(np.int32), sv.astype(np.int32)))
    if backend == EdgeSetBackend.CUCKOO:
        slots_u, slots_v, num_bins = _build_cuckoo_host(u, v, use_native)
        return ("cuckoo", 1, (("num_bins", num_bins),), (slots_u, slots_v))
    if backend == EdgeSetBackend.PERFECT:
        d_arr, table, slot_mask, bucket_mask, seed = _build_perfect_host(
            u, v, use_native=use_native)
        return ("perfect", 1,
                (("slot_mask", slot_mask), ("bucket_mask", bucket_mask),
                 ("seed", seed)), (d_arr, table))
    raise ValueError(backend)


def build_edge_set(backend: EdgeSetBackend, num_nodes: int,
                   u: np.ndarray, v: np.ndarray, device) -> EdgeSet:
    """Build a device EdgeSet from canonical host edges (u < v)."""
    name, steps, meta, arrays = build_host_tables(backend, num_nodes, u, v)
    return EdgeSet(name, num_nodes, steps, meta,
                   tuple(torch.as_tensor(np.ascontiguousarray(a),
                                         device=device) for a in arrays))
