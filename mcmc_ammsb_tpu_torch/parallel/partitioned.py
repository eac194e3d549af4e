"""Partitioned (multi-process capacity) graph structures: a CSR whose rows
are sharded over the mesh's 'model' axis, and the per-process ingest that
builds it without any process ever holding the full graph (counterpart
of ``mcmc_ammsb_tpu/parallel/partitioned.py``).

BOTH E-sized structures — the membership set and the sampling adjacency
— are the rank's model shard of the training CSR (``ShardedCSR``), and
the SNAP ETL is split by byte range, so each process parses, exchanges
and keeps only O(E/P) edges (``multihost`` provides the byte-range and
vocabulary plumbing).

Membership and adjacency queries are collectives with the discipline of
the pi row fetches (``sharded._fetch_rows``): the owner of row u answers
from its local CSR slice and an integer all-reduce over the model group
gives every rank the answer. The answers are EXACT (integer sums), so a
partitioned run's trajectory is the replicated-graph engine's bit for
bit.

The held-out structures stay replicated: they are ratio-sized and the
evaluation population must be globally visible anyway.

Split semantics (the JAX package's, PARITY.md): the held-out links are
chosen by a deterministic per-edge hash (splitmix64(pack(u,v)) <
ratio/2 * 2^64), so P processes make identical choices without
communication, and the fake non-link population is drawn from one shared
numpy stream with distributed membership rejection.

Collective-ordering discipline: every cross-process helper below runs
the SAME sequence of collectives on every process regardless of which
shards it owns (one pass over all shards), so mixed ownership cannot
deadlock. Packed uint64 edge keys travel as int64 tensors (a bit view,
no loss); membership verdicts are summed as int32, never as bool.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mcmc_ammsb_tpu_torch.data import DataSplit, Graph
from mcmc_ammsb_tpu_torch.ops.edgeset import _lower_bound
from mcmc_ammsb_tpu_torch.parallel import multihost
from mcmc_ammsb_tpu_torch.parallel.mesh import Mesh

# ---------------------------------------------------------------------------
# Device structure: model-row-sharded CSR
# ---------------------------------------------------------------------------


class ShardedCSR:
    """This rank's model shard of a symmetric CSR adjacency.

      offsets [rows_per_shard + 1] int32 — shard-LOCAL offsets (padded
          rows are empty);
      cols    [cols_cap] int32 — GLOBAL column ids, each row sorted
          ascending, padded to the common cap.

    Every query is a collective over the mesh's model group: the owner of
    row u answers locally, everyone else contributes zero, and an int32
    all-reduce sums the answers. It implements both the ``EdgeSet``
    membership protocol (``has_edges``, ``device``, ``backend``) and the
    device sampler's adjacency protocol (``degree``, ``row_gather``,
    ``cols``), so the sharded engine uses it exactly where it used the
    replicated edge set and CSR pair. Every rank of a model group must
    make the same queries in the same order."""

    backend = "sharded_csr"

    def __init__(self, offsets: torch.Tensor, cols: torch.Tensor,
                 num_nodes: int, rows_per_shard: int, num_search_steps: int,
                 mesh: Mesh):
        self.offsets = offsets
        self.cols = cols
        self.num_nodes = num_nodes
        self.rows_per_shard = rows_per_shard
        self.num_search_steps = num_search_steps
        self.mesh = mesh

    @property
    def device(self) -> torch.device:
        return self.cols.device

    def _local(self, u):
        """(local_row, owned) for global node ids ``u`` on this shard."""
        lu = u.long() - self.mesh.m_idx * self.rows_per_shard
        ok = (lu >= 0) & (lu < self.rows_per_shard)
        return lu.clamp(0, self.rows_per_shard - 1), ok

    def _sum(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.int32).contiguous()
        dist.all_reduce(x, group=self.mesh.model_group)
        return x

    def has_edges(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Collective membership: exact, one owner answers per query."""
        u, v = torch.broadcast_tensors(u, v.long())
        lu, ok = self._local(u)
        lo0 = self.offsets[lu].long()
        hi0 = self.offsets[lu + 1].long()
        m = self.cols.shape[0]

        def less(mid):
            return self.cols[mid.clamp(0, m - 1)] < v

        pos = _lower_bound(self.num_search_steps, lo0, hi0, less)
        hit = ok & (pos < hi0) & (self.cols[pos.clamp(0, m - 1)] == v)
        return self._sum(hit) > 0

    def degree(self, u: torch.Tensor) -> torch.Tensor:
        lu, ok = self._local(u)
        deg = (self.offsets[lu + 1] - self.offsets[lu]) * ok
        return self._sum(deg)

    def row_gather(self, u: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
        """cols of row u at in-row offsets ``off`` ([*u.shape, L]);
        out-of-row offsets return clamped garbage exactly like the
        replicated gather — callers mask those lanes."""
        lu, ok = self._local(u)
        idx = self.offsets[lu].long()[..., None] + off
        m = self.cols.shape[0]
        vals = self.cols[idx.clamp(0, m - 1)] * ok[..., None]
        return self._sum(vals)


class ShardSlice(NamedTuple):
    """Host-side CSR of one model shard's rows [row_lo, row_hi)."""

    row_lo: int
    row_hi: int
    offsets: np.ndarray   # [row_hi - row_lo + 1] local offsets
    cols: np.ndarray      # global ids, sorted within each row


def build_sharded_csr(mesh: Mesh, num_nodes: int, rows_per_shard: int,
                      shards: Dict[int, ShardSlice],
                      cols_cap: Optional[int] = None) -> ShardedCSR:
    """This rank's ``ShardedCSR`` from the host-side slice of its model
    shard (``shards[mesh.m_idx]``). ``cols_cap`` (the common padded
    column count) must be identical on every rank; multi-process callers
    pass the all-reduced max."""
    if cols_cap is None:
        cols_cap = max((len(s.cols) for s in shards.values()), default=1)
    cols_cap = max(int(cols_cap), 1)
    s = shards[mesh.m_idx]
    offs = np.zeros(rows_per_shard + 1, np.int32)
    n_rows = s.row_hi - s.row_lo
    offs[: n_rows + 1] = s.offsets
    offs[n_rows + 1:] = s.offsets[-1]   # padded rows are empty
    cols = np.zeros(cols_cap, np.int32)
    cols[: len(s.cols)] = s.cols
    steps = int(np.ceil(np.log2(max(cols_cap, 2)))) + 1
    return ShardedCSR(torch.from_numpy(offs).to(mesh.device),
                      torch.from_numpy(cols).to(mesh.device), num_nodes,
                      rows_per_shard, steps, mesh)


# ---------------------------------------------------------------------------
# Deterministic split + ingest
# ---------------------------------------------------------------------------

_SPLITMIX_C1 = np.uint64(0xBF58476D1CE4E5B9)
_SPLITMIX_C2 = np.uint64(0x94D049BB133111EB)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Finalizer of splitmix64 — a high-quality 64-bit mix."""
    x = np.asarray(x, np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * _SPLITMIX_C1
        x = (x ^ (x >> np.uint64(27))) * _SPLITMIX_C2
        return x ^ (x >> np.uint64(31))


def _pack(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    return ((np.asarray(u).astype(np.uint64) << np.uint64(32))
            | np.asarray(v).astype(np.uint64))


def _unpack(p: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return ((p >> np.uint64(32)).astype(np.int32),
            (p & np.uint64(0xFFFFFFFF)).astype(np.int32))


def heldout_link_mask(u: np.ndarray, v: np.ndarray,
                      heldout_ratio: float, seed: int) -> np.ndarray:
    """Deterministic per-edge held-out choice: order-independent, so
    every process classifies its local edges identically without
    communication. P(heldout) = ratio/2 per edge."""
    h = _splitmix64(_pack(u, v) ^ _splitmix64(np.uint64(seed)))
    thresh = np.uint64(int((heldout_ratio / 2.0) * float(2**64 - 1)))
    return h < thresh


class PartitionedData(NamedTuple):
    """Per-process view of a partitioned dataset."""

    num_nodes: int
    num_edges: int              # global unique-edge count E
    max_fan_out: int            # global max degree (training graph)
    shards: Dict[int, ShardSlice]   # my model shard's TRAINING csr
    cols_cap: int               # global max shard cols (padding target)
    heldout_u: np.ndarray       # real held-out links (full, small)
    heldout_v: np.ndarray
    fake_u: np.ndarray          # sampled non-links (full, small)
    fake_v: np.ndarray
    local_parse_edges: int = 0  # this process's byte-range edge count
    max_shard_edges: int = 0    # largest per-shard edge count held

    @property
    def heldout_edges_u(self) -> np.ndarray:
        return np.concatenate([self.heldout_u, self.fake_u])

    @property
    def heldout_edges_v(self) -> np.ndarray:
        return np.concatenate([self.heldout_v, self.fake_v])


def my_model_shards(mesh: Mesh, rows_per_shard: int,
                    num_nodes: int) -> Dict[int, Tuple[int, int]]:
    """The model shard's row range this rank owns (clamped to real rows:
    the top shard may be pure padding on tall meshes). One rank, one
    device: one shard."""
    m = mesh.m_idx
    return {m: (min(m * rows_per_shard, num_nodes),
                min((m + 1) * rows_per_shard, num_nodes))}


def _shard_owner(mesh: Mesh, m: int) -> int:
    """Lowest rank holding model shard ``m`` (dedup rule for global
    reductions when the model axis is replicated over data rows): the
    rank of data row 0."""
    return m


def _multi() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def _comm_device() -> torch.device:
    """Where the world group's collectives take their tensors: the
    rank's card under NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _allgather_concat(arr: np.ndarray) -> np.ndarray:
    """Variable-length cross-process concat in rank order: the lengths
    are all-gathered, then the arrays padded to the longest. 64-bit
    arrays travel as int64 bit views (packed uint64 edge keys keep their
    u half). A lone process gets its own array back."""
    if not _multi():
        return arr
    dev = _comm_device()
    arr = np.ascontiguousarray(arr)
    wide = arr.dtype.itemsize == 8
    view = arr.view(np.int64) if wide else arr.astype(np.int64)
    n = torch.tensor([len(view)], dtype=torch.int64, device=dev)
    lens = torch.empty(dist.get_world_size(), dtype=torch.int64, device=dev)
    dist.all_gather_into_tensor(lens, n)
    lens = lens.cpu().numpy()
    width = max(int(lens.max()), 1)
    padded = torch.zeros(width, dtype=torch.int64, device=dev)
    padded[: len(view)] = torch.from_numpy(view).to(dev)
    out = torch.empty(len(lens) * width, dtype=torch.int64, device=dev)
    dist.all_gather_into_tensor(out, padded)
    out = out.cpu().numpy().reshape(len(lens), width)
    flat = np.concatenate([out[p, : int(lens[p])] for p in range(len(lens))])
    return flat.view(arr.dtype) if wide else flat.astype(arr.dtype)


def _allreduce_int(x: int, op) -> int:
    if not _multi():
        return int(x)
    t = torch.tensor([int(x)], dtype=torch.int64, device=_comm_device())
    dist.all_reduce(t, op=op)
    return int(t.item())


def _allreduce_max(x: int) -> int:
    return _allreduce_int(x, dist.ReduceOp.MAX)


def _allreduce_sum(x: int) -> int:
    return _allreduce_int(x, dist.ReduceOp.SUM)


def _allreduce_any_rows(local_bad: np.ndarray) -> np.ndarray:
    """Element-wise OR across processes, summed as int32."""
    if not _multi():
        return local_bad > 0
    t = torch.from_numpy(np.asarray(local_bad, np.int32)).to(_comm_device())
    dist.all_reduce(t)
    return t.cpu().numpy() > 0


def exchange_edges(u: np.ndarray, v: np.ndarray,
                   row_cuts: np.ndarray,
                   my_shards: Dict[int, Tuple[int, int]]
                   ) -> Tuple[Dict[int, Tuple[np.ndarray, np.ndarray]],
                              int]:
    """Route locally-parsed edges to the shards they touch; return
    {shard -> deduplicated canonical edges touching its rows} for MY
    shards, plus the largest per-shard edge count (memory telemetry).

    ONE all-gather round per model shard, executed by EVERY process; each
    round carries only the edges destined for that shard, so peak
    transient memory is O(max_shard_edges), never O(E). A lone process:
    a pure local filter."""
    out: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    max_edges = 0
    for s in range(len(row_cuts) - 1):
        lo, hi = int(row_cuts[s]), int(row_cuts[s + 1])
        sel = ((u >= lo) & (u < hi)) | ((v >= lo) & (v < hi))
        packed = _allgather_concat(_pack(u[sel], v[sel]))
        if s in my_shards:
            packed = np.unique(packed)
            out[s] = _unpack(packed)
            max_edges = max(max_edges, len(packed))
        del packed
    return out, max_edges


def _csr_slice(u: np.ndarray, v: np.ndarray, row_lo: int,
               row_hi: int) -> ShardSlice:
    """Symmetric CSR restricted to rows [row_lo, row_hi) (the device
    form of multihost.shard_csr, cols sorted within each row)."""
    src = np.concatenate([u, v])
    dst = np.concatenate([v, u])
    keep = (src >= row_lo) & (src < row_hi)
    src = src[keep] - row_lo
    dst = dst[keep]
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    counts = np.bincount(src, minlength=max(row_hi - row_lo, 1))
    offsets = np.zeros(max(row_hi - row_lo, 0) + 1, np.int64)
    if row_hi > row_lo:
        np.cumsum(counts[: row_hi - row_lo], out=offsets[1:])
    return ShardSlice(row_lo, row_hi, offsets.astype(np.int32),
                      dst.astype(np.int32))


def sample_fake_nonlinks(num_nodes: int, target: int, seed: int,
                         local_edges_packed: np.ndarray,
                         owned_ranges: List[Tuple[int, int]]
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """``target`` uniform non-edges, chosen identically on every
    process (real edges and each other excluded). Candidates come from
    one shared numpy stream; membership is rejected DISTRIBUTEDLY — each
    process tests the candidates whose u falls in a row range it owns
    against its local edge set, the verdicts are summed across processes
    (candidate-sized, tiny) and every process applies the identical
    accept rule, so the loop runs the same number of rounds everywhere."""
    rng = np.random.RandomState(seed & 0x7FFFFFFF)
    chosen = np.zeros(0, np.uint64)
    rounds = 0
    while len(chosen) < target and rounds < 64:
        rounds += 1
        n_prop = max(64, 2 * (target - len(chosen)))
        a = rng.randint(0, num_nodes, size=n_prop).astype(np.int64)
        b = rng.randint(0, num_nodes, size=n_prop).astype(np.int64)
        cu = np.minimum(a, b).astype(np.int32)
        cv = np.maximum(a, b).astype(np.int32)
        packed = _pack(cu, cv)
        mine = np.zeros(n_prop, np.bool_)
        for lo, hi in owned_ranges:
            mine |= (cu >= lo) & (cu < hi)
        local_bad = np.zeros(n_prop, np.int8)
        local_bad[mine] = np.isin(packed[mine],
                                  local_edges_packed).astype(np.int8)
        bad = _allreduce_any_rows(local_bad)
        ok = ~bad & (cu != cv) & ~np.isin(packed, chosen)
        # dedup within the round, keep first occurrences in order
        _, first = np.unique(packed[ok], return_index=True)
        keep = packed[ok][np.sort(first)]
        chosen = np.concatenate([chosen, keep])[: target]
    if len(chosen) < target:
        raise RuntimeError(
            f"could not sample {target} non-links in 64 rounds "
            "(graph too dense?)")
    return _unpack(chosen)


def partitioned_ingest(mesh: Mesh, *, heldout_ratio: float, seed: int,
                       path: Optional[str] = None,
                       edges: Optional[Tuple[np.ndarray,
                                             np.ndarray]] = None,
                       num_nodes: Optional[int] = None
                       ) -> PartitionedData:
    """Per-process dataset build: parse MY byte range, agree on the
    vocabulary, exchange edges to their owning model shards, split
    held-out links by hash, and build MY shard's training CSR.

    ``path``: SNAP file, split by ``multihost.byte_ranges`` across the
    world's processes. ``edges`` + ``num_nodes``: pre-parsed LOCAL (this
    process's share) renumbered edge arrays — the synthetic-graph entry
    of the tests. No process holds more than O(E/P + max_shard_edges)
    edge records (P processes), reported by the telemetry fields."""
    if path is not None:
        pid = dist.get_rank() if dist.is_initialized() else 0
        n_proc = dist.get_world_size() if dist.is_initialized() else 1
        ranges = multihost.byte_ranges(path, n_proc)
        raw_u, raw_v = multihost.load_snap_edges_range(path, *ranges[pid])
        vocab = multihost.global_vocab(np.concatenate([raw_u, raw_v]))
        num_nodes = len(vocab)
        u, v = multihost.renumber_edges(raw_u, raw_v, vocab)
        del raw_u, raw_v
    else:
        assert edges is not None and num_nodes is not None
        u = np.asarray(edges[0], np.int32)
        v = np.asarray(edges[1], np.int32)
        u, v = np.minimum(u, v), np.maximum(u, v)
    local_parse_edges = len(u)

    n_model = mesh.shape["model"]
    rows_per_shard = -(-num_nodes // n_model)   # == ShardedLearner's
    row_cuts = np.minimum(np.arange(n_model + 1) * rows_per_shard,
                          num_nodes)
    mine = my_model_shards(mesh, rows_per_shard, num_nodes)
    rank = dist.get_rank() if dist.is_initialized() else 0

    shard_edges, max_shard_edges = exchange_edges(u, v, row_cuts, mine)
    del u, v  # the byte-range parse is no longer needed

    # global E: the owner of each shard counts the unique edges whose
    # canonical u lands in that shard's rows
    my_e = 0
    for m, (su, sv) in shard_edges.items():
        if _shard_owner(mesh, m) != rank:
            continue
        lo, hi = mine[m]
        my_e += int(((su >= lo) & (su < hi)).sum())
    num_edges = _allreduce_sum(my_e)

    # held-out links: hash rule, classified by each shard's owner,
    # gathered globally (small)
    ho_parts_u, ho_parts_v = [], []
    for m, (su, sv) in shard_edges.items():
        if _shard_owner(mesh, m) != rank:
            continue
        lo, hi = mine[m]
        own = (su >= lo) & (su < hi)
        hm = heldout_link_mask(su[own], sv[own], heldout_ratio, seed)
        ho_parts_u.append(su[own][hm])
        ho_parts_v.append(sv[own][hm])
    ho_u = (np.concatenate(ho_parts_u) if ho_parts_u
            else np.zeros(0, np.int32))
    ho_v = (np.concatenate(ho_parts_v) if ho_parts_v
            else np.zeros(0, np.int32))
    heldout_packed = np.sort(_allgather_concat(_pack(ho_u, ho_v)))
    heldout_u, heldout_v = _unpack(heldout_packed)

    # fake non-links: shared stream + distributed membership rejection
    if shard_edges:
        all_local_packed = np.unique(np.concatenate(
            [_pack(su, sv) for su, sv in shard_edges.values()]))
    else:
        all_local_packed = np.zeros(0, np.uint64)
    fake_u, fake_v = sample_fake_nonlinks(
        num_nodes, len(heldout_u), seed + 1, all_local_packed,
        list(mine.values()))

    # training CSR per shard: drop held-out links, build symmetric CSR
    shards: Dict[int, ShardSlice] = {}
    max_deg = 0
    for m, (su, sv) in shard_edges.items():
        lo, hi = mine[m]
        keep = ~np.isin(_pack(su, sv), heldout_packed)
        sl = _csr_slice(su[keep], sv[keep], lo, hi)
        shards[m] = sl
        if len(sl.offsets) > 1:
            max_deg = max(max_deg, int(np.diff(sl.offsets).max()))
    max_fan_out = _allreduce_max(max_deg)
    cols_cap = _allreduce_max(max(
        (len(s.cols) for s in shards.values()), default=1))

    return PartitionedData(
        num_nodes=num_nodes, num_edges=num_edges,
        max_fan_out=max_fan_out, shards=shards, cols_cap=cols_cap,
        heldout_u=heldout_u, heldout_v=heldout_v,
        fake_u=fake_u, fake_v=fake_v,
        local_parse_edges=local_parse_edges,
        max_shard_edges=max_shard_edges)


def _local_packed_training_edges(pdata: PartitionedData) -> np.ndarray:
    """This process's view of the training edge set as sorted unique
    canonical-packed uint64 (each shard CSR row contributes its
    adjacency; undirected edges seen from both endpoint rows dedup
    here). O(local shard edges) memory — never the full list."""
    pairs = []
    for s in pdata.shards.values():
        rows = np.repeat(np.arange(s.row_lo, s.row_hi, dtype=np.int32),
                         np.diff(s.offsets))
        pairs.append(_pack(np.minimum(rows, s.cols),
                           np.maximum(rows, s.cols)))
    if not pairs:
        return np.zeros(0, np.uint64)
    return np.unique(np.concatenate(pairs))


def to_datasplit(pdata: PartitionedData):
    """TEST-ONLY: gather a PartitionedData back into the replicated
    Graph + DataSplit pair, to run the replicated engine on the
    identical dataset for trajectory-parity checks. Materializes the
    full graph — never call this in a capacity-constrained run."""
    allp = np.unique(_allgather_concat(_local_packed_training_edges(pdata)))
    tu, tv = _unpack(allp)
    split = DataSplit(
        num_nodes=pdata.num_nodes,
        training_u=tu, training_v=tv,
        heldout_u=pdata.heldout_u, heldout_v=pdata.heldout_v,
        heldout_edges_u=pdata.heldout_edges_u,
        heldout_edges_v=pdata.heldout_edges_v,
        total_edges=pdata.num_edges)
    return Graph.from_edges(pdata.num_nodes, tu, tv), split


def make_training_ppx_edges_partitioned(
        pdata: PartitionedData, ratio: float, seed: int = 777
) -> Tuple[np.ndarray, np.ndarray]:
    """Training-perplexity population in partitioned mode — BIT-EQUAL
    to ``data.make_training_ppx_edges(to_datasplit(pdata)[1], ratio)``
    (MakeEdgesForTrainingPerplexity, learner.cc:48-74) without the full
    edge list:

      - the link half is the first num_links training edges in global
        canonical-packed order: each process contributes its local
        num_links-smallest and a k-smallest union over one all-gather
        reproduces the same head;
      - the non-link half replays the replicated RandomState rejection
        stream exactly, the training-membership test answered by local
        searchsorted + an all-reduced OR.

    Every process returns the identical arrays (collective)."""
    n = pdata.num_nodes
    e = pdata.num_edges
    train_count = e - len(pdata.heldout_u)
    total = n * (n - 1) // 2
    num_links = int(ratio * train_count)
    num_non_links = int(num_links * total / float(e))

    local = _local_packed_training_edges(pdata)
    head = np.unique(_allgather_concat(local[:num_links]))
    if len(head) < num_links:
        raise ValueError(
            f"training graph has only {len(head)} edges visible; "
            f"needs {num_links} for training_ppx_ratio={ratio}")
    lu, lv = _unpack(head[:num_links])

    ho = np.sort(_pack(pdata.heldout_u, pdata.heldout_v))

    def member(sorted_arr: np.ndarray, p: np.ndarray) -> np.ndarray:
        idx = np.searchsorted(sorted_arr, p)
        ok = idx < len(sorted_arr)
        out = np.zeros(len(p), np.bool_)
        out[ok] = sorted_arr[idx[ok]] == p[ok]
        return out

    rng = np.random.RandomState(seed)
    fu = np.empty(num_non_links, np.int32)
    fv = np.empty(num_non_links, np.int32)
    count = 0
    rounds = 0
    while count < num_non_links:
        rounds += 1
        if rounds > 200:
            raise ValueError(
                f"make_training_ppx_edges_partitioned: found only "
                f"{count}/{num_non_links} non-edges after 200 "
                "rejection rounds — the graph is too dense")
        need = num_non_links - count
        ra = rng.randint(0, n, size=2 * need + 16)
        rb = rng.randint(0, n, size=2 * need + 16)
        keep = ra != rb
        cu = np.minimum(ra[keep], rb[keep])
        cv = np.maximum(ra[keep], rb[keep])
        p = _pack(cu, cv)
        # training membership is sharded; heldout is replicated host
        hit = _allreduce_any_rows(member(local, p) | member(ho, p))
        take = np.flatnonzero(~hit)[: num_non_links - count]
        fu[count:count + len(take)] = cu[take]
        fv[count:count + len(take)] = cv[take]
        count += len(take)
    return (np.concatenate([lu, fu]).astype(np.int32),
            np.concatenate([lv, fv]).astype(np.int32))
