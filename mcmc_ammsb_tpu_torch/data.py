"""Graph ETL: SNAP loading, renumbering, train/held-out split, CSR
adjacency — the numpy paths of ``mcmc_ammsb_tpu/data.py``, copied (see
config.py for why the port does not import them).

  * ``load_snap_edges``  — parse an edge list (the native C++ parser
                           of ``native.py`` when it is built, else numpy),
                           canonicalize, renumber vertices to [0, N),
                           dedup, shuffle.
  * ``synthetic_edges``  — uniform random test/benchmark graph.
  * ``synthetic_sbm_edges``, ``synthetic_powerlaw_edges`` — a planted
                           partition, and its degree-corrected heavy-tailed
                           variant (the surrogate for SNAP graphs).
  * ``generate_sets``    — training / held-out split plus an equal count
                           of "fake" held-out non-edges.
  * ``Graph``            — CSR adjacency + max fan-out.

  * ``make_training_ppx_edges`` — the evaluation population of the
                           training perplexity.
  * ``dump_dataset``, ``load_dataset`` — the dataset cache: the npz
                           cache, or the reference's gzip binary layout.
"""

from __future__ import annotations

import dataclasses
import gzip
import io
from typing import Optional, Tuple

import numpy as np

from mcmc_ammsb_tpu_torch.types import (VERTEX_DTYPE, canonicalize,
                                        pack_edges, unpack_edges)


@dataclasses.dataclass
class Graph:
    """Undirected graph in CSR form."""

    num_nodes: int
    edges_u: np.ndarray  # [E] int32, canonical u < v
    edges_v: np.ndarray  # [E] int32
    offsets: np.ndarray  # [N+1] int64 CSR row offsets
    cols: np.ndarray     # [2E] int32, sorted within each row

    @classmethod
    def from_edges(cls, num_nodes: int, u: np.ndarray,
                   v: np.ndarray) -> "Graph":
        u = np.asarray(u, VERTEX_DTYPE)
        v = np.asarray(v, VERTEX_DTYPE)
        src = np.concatenate([u, v])
        dst = np.concatenate([v, u])
        order = np.lexsort((dst, src))
        src, dst = src[order], dst[order]
        counts = np.bincount(src, minlength=num_nodes)
        offsets = np.zeros(num_nodes + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        return cls(num_nodes, u, v, offsets, dst)

    @property
    def num_edges(self) -> int:
        return len(self.edges_u)

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.offsets)

    @property
    def max_fan_out(self) -> int:
        return int(self.degrees.max()) if self.num_nodes else 0

    def neighbors_of(self, u: int) -> np.ndarray:
        return self.cols[self.offsets[u]: self.offsets[u + 1]]

    def has_edge(self, u: int, v: int) -> bool:
        row = self.neighbors_of(u)
        i = np.searchsorted(row, v)
        return bool(i < len(row) and row[i] == v)


def load_snap_edges(path: str, shuffle_seed: int = 0,
                    use_native: str = "auto"
                    ) -> Tuple[int, np.ndarray, np.ndarray]:
    """Parse a SNAP edge-list file (``#`` comment lines, then ``u v``
    pairs; ``.gz`` is read through gzip). Returns (N, u, v).

    Plain-text files go through the native C++ parser when it is built
    (``use_native="auto"``; ``"always"`` raises when it is not or the
    file is gzip, ``"never"`` takes the numpy path). Both give the same
    arrays."""
    if use_native != "never":
        if path.endswith(".gz"):
            if use_native == "always":
                raise RuntimeError("native parser does not read gzip; "
                                   "decompress first or use the numpy path")
        else:
            from mcmc_ammsb_tpu_torch import native
            if native.available():
                a, b = native.snap_parse(path)
                return renumber_dedup_shuffle(a, b, shuffle_seed)
            if use_native == "always":
                raise RuntimeError("native parser requested but "
                                   "unavailable")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        text = f.read()
    lines = [ln for ln in text.splitlines()
             if ln and not ln.lstrip().startswith("#")]
    raw = np.loadtxt(io.StringIO("\n".join(lines)), dtype=np.int64,
                     ndmin=2)
    return renumber_dedup_shuffle(raw[:, 0], raw[:, 1], shuffle_seed)


def renumber_dedup_shuffle(
    a: np.ndarray, b: np.ndarray, shuffle_seed: int = 0
) -> Tuple[int, np.ndarray, np.ndarray]:
    """Vertex renumber to [0, N), self-loop drop, dedup, shuffle."""
    keep = a != b
    a, b = a[keep], b[keep]
    uniq, inv = np.unique(np.concatenate([a, b]), return_inverse=True)
    n = len(uniq)
    a = inv[: len(a)].astype(VERTEX_DTYPE)
    b = inv[len(b):].astype(VERTEX_DTYPE)
    u, v = canonicalize(a, b)
    packed = np.unique(pack_edges(u, v))
    rng = np.random.RandomState(shuffle_seed)
    rng.shuffle(packed)
    u, v = unpack_edges(packed)
    return n, u, v


def synthetic_edges(num_nodes: int, avg_degree: int, seed: int = 0
                    ) -> Tuple[int, np.ndarray, np.ndarray]:
    """Uniform random graph, the same draws as the JAX package's."""
    rng = np.random.RandomState(seed)
    m = num_nodes * avg_degree // 2
    a = rng.randint(0, num_nodes, size=2 * m)
    b = rng.randint(0, num_nodes, size=2 * m)
    n, u, v = renumber_dedup_shuffle(a, b, shuffle_seed=seed)
    u, v = u[:m], v[:m]
    order = np.random.RandomState(seed + 1).permutation(len(u))
    return n, u[order], v[order]


def synthetic_sbm_edges(num_nodes: int, num_communities: int,
                        p_in: float = 0.05, p_out: float = 0.001,
                        seed: int = 0) -> Tuple[int, np.ndarray, np.ndarray]:
    """Planted-partition (stochastic block model) graph, the same draws
    as the JAX package's: equal communities, intra-community edges at
    ``p_in``, inter at ``p_out`` (sampled by pair counts, not O(N^2)).
    A uniform random graph carries no structure to learn; this one
    does."""
    rng = np.random.RandomState(seed)
    sizes = np.full(num_communities, num_nodes // num_communities)
    sizes[: num_nodes % num_communities] += 1
    labels = np.repeat(np.arange(num_communities), sizes)
    rng.shuffle(labels)
    chunks = []
    for c in range(num_communities):
        m = np.where(labels == c)[0]
        s = len(m)
        count = rng.binomial(s * (s - 1) // 2, p_in)
        if count:
            chunks.append((m[rng.randint(0, s, count)],
                           m[rng.randint(0, s, count)]))
    count = rng.binomial(num_nodes * (num_nodes - 1) // 2, p_out)
    if count:
        chunks.append((rng.randint(0, num_nodes, count),
                       rng.randint(0, num_nodes, count)))
    return renumber_dedup_shuffle(np.concatenate([c[0] for c in chunks]),
                                  np.concatenate([c[1] for c in chunks]),
                                  shuffle_seed=seed + 1)


def synthetic_powerlaw_edges(
        num_nodes: int, avg_degree: float, exponent: float = 2.7,
        max_degree: Optional[int] = None, num_communities: int = 0,
        intra_fraction: float = 0.85, seed: int = 0
) -> Tuple[int, np.ndarray, np.ndarray]:
    """Degree-realistic surrogate graph, the same draws as the JAX
    package's: a degree-corrected planted partition whose degree sequence
    follows a truncated power law. Per-node propensities theta_i ~ 1 +
    Pareto(exponent - 1), capped so that the largest expected degree lands
    near ``max_degree``; edges draw endpoints in proportion to theta (a
    Chung-Lu law), ``intra_fraction`` of them inside ``num_communities``
    planted communities. Returns renumbered, deduped, canonical edges;
    isolated nodes are dropped."""
    rng = np.random.RandomState(seed)
    theta = rng.pareto(exponent - 1.0, num_nodes) + 1.0
    if max_degree is not None:
        for _ in range(4):
            scale = avg_degree * num_nodes / theta.sum()
            theta = np.minimum(theta, max_degree / scale)
    p_global = theta / theta.sum()
    total = int(num_nodes * avg_degree) // 2
    a = rng.choice(num_nodes, size=total, p=p_global)
    if num_communities and num_communities > 1:
        labels = rng.randint(0, num_communities, num_nodes)
        b = rng.choice(num_nodes, size=total, p=p_global)
        intra = rng.rand(total) < intra_fraction
        # an intra edge's second endpoint is redrawn inside a's community,
        # in proportion to theta: nodes sorted by label form contiguous
        # segments, and a uniform draw in a segment's cumulative-theta
        # mass + searchsorted is that draw
        order = np.argsort(labels, kind="stable")
        lab_sorted = labels[order]
        cum = np.cumsum(theta[order])
        cum0 = np.concatenate([[0.0], cum])
        seg_lo = np.searchsorted(lab_sorted, np.arange(num_communities))
        seg_hi = np.searchsorted(lab_sorted,
                                 np.arange(num_communities) + 1)
        c_edge = labels[a]
        lo, hi = seg_lo[c_edge], seg_hi[c_edge]
        redir = intra & (hi - lo >= 2)   # singletons keep the global draw
        r = rng.rand(int(redir.sum()))
        mass = cum0[lo[redir]] + r * (cum0[hi[redir]] - cum0[lo[redir]])
        pos = np.searchsorted(cum, mass, side="left")
        pos = np.clip(pos, lo[redir], hi[redir] - 1)
        b[redir] = order[pos]
    else:
        b = rng.choice(num_nodes, size=total, p=p_global)
    return renumber_dedup_shuffle(a, b, shuffle_seed=seed + 1)


@dataclasses.dataclass
class DataSplit:
    """Training / held-out split plus the held-out evaluation edge list
    (heldout_len real edges followed by as many sampled non-edges)."""

    num_nodes: int
    training_u: np.ndarray
    training_v: np.ndarray
    heldout_u: np.ndarray      # real held-out edges only
    heldout_v: np.ndarray
    heldout_edges_u: np.ndarray  # real + fake, evaluation population
    heldout_edges_v: np.ndarray
    total_edges: int             # E = |unique edges| pre-split


def generate_sets(num_nodes: int, u: np.ndarray, v: np.ndarray,
                  heldout_ratio: float, seed: int = 12345) -> DataSplit:
    """Split shuffled unique edges into training/held-out + fake
    non-edges: training_len = ceil((1 - ratio/2) * E); fakes are uniform
    non-edges excluded from every real edge and from each other."""
    e = len(u)
    training_len = int(np.ceil((1.0 - heldout_ratio / 2.0) * e))
    heldout_len = e - training_len
    heldout_u, heldout_v = u[:heldout_len], v[:heldout_len]
    training_u, training_v = u[heldout_len:], v[heldout_len:]

    existing = set(pack_edges(u, v).tolist())
    rng = np.random.RandomState(seed)
    fake_u = np.empty(heldout_len, VERTEX_DTYPE)
    fake_v = np.empty(heldout_len, VERTEX_DTYPE)
    count = 0
    rounds = 0
    while count < heldout_len:
        rounds += 1
        if rounds > 200:
            raise ValueError(
                f"generate_sets: found only {count}/{heldout_len} fake "
                "non-edges after 200 rejection rounds — the graph is "
                "too dense for this heldout_ratio")
        need = heldout_len - count
        ra = rng.randint(0, num_nodes, size=2 * need + 16)
        rb = rng.randint(0, num_nodes, size=2 * need + 16)
        keep = ra != rb
        cu, cv = canonicalize(ra[keep], rb[keep])
        for x, y in zip(cu, cv):
            key = int(pack_edges(x, y))
            if key in existing:
                continue
            existing.add(key)
            fake_u[count], fake_v[count] = x, y
            count += 1
            if count == heldout_len:
                break

    return DataSplit(
        num_nodes=num_nodes,
        training_u=training_u,
        training_v=training_v,
        heldout_u=heldout_u,
        heldout_v=heldout_v,
        heldout_edges_u=np.concatenate([heldout_u, fake_u]).astype(
            VERTEX_DTYPE),
        heldout_edges_v=np.concatenate([heldout_v, fake_v]).astype(
            VERTEX_DTYPE),
        total_edges=e,
    )


def make_training_ppx_edges(
    split: DataSplit, ratio: float, seed: int = 777
) -> Tuple[np.ndarray, np.ndarray]:
    """Evaluation population for TRAINING perplexity: ``ratio`` of the
    training edges, plus that count times (N(N-1)/2) / E sampled
    non-edges (outside training and held-out)."""
    n = split.num_nodes
    e = split.total_edges
    total = n * (n - 1) // 2
    num_links = int(ratio * len(split.training_u))
    num_non_links = int(num_links * total / float(e))
    eu = [split.training_u[:num_links]]
    ev = [split.training_v[:num_links]]
    existing = set(pack_edges(
        np.concatenate([split.training_u, split.heldout_u]),
        np.concatenate([split.training_v, split.heldout_v]),
    ).tolist())
    rng = np.random.RandomState(seed)
    fu = np.empty(num_non_links, VERTEX_DTYPE)
    fv = np.empty(num_non_links, VERTEX_DTYPE)
    count = 0
    rounds = 0
    while count < num_non_links:
        rounds += 1
        if rounds > 200:
            raise ValueError(
                f"make_training_ppx_edges: found only {count}/"
                f"{num_non_links} non-edges after 200 rejection rounds "
                "— the graph is too dense for this ratio")
        need = num_non_links - count
        ra = rng.randint(0, n, size=2 * need + 16)
        rb = rng.randint(0, n, size=2 * need + 16)
        keep = ra != rb
        cu, cv = canonicalize(ra[keep], rb[keep])
        for x, y in zip(cu, cv):
            if int(pack_edges(x, y)) in existing:
                continue
            fu[count], fv[count] = x, y
            count += 1
            if count == num_non_links:
                break
    eu.append(fu)
    ev.append(fv)
    return (np.concatenate(eu).astype(VERTEX_DTYPE),
            np.concatenate(ev).astype(VERTEX_DTYPE))


def dump_dataset(path: str, num_nodes: int, heldout_ratio: float,
                 u: np.ndarray, v: np.ndarray, fmt: str = "npz") -> None:
    """Compressed dataset cache. ``fmt="npz"`` (default) is the native
    cache; ``fmt="ref"`` writes the reference's on-disk layout: a gzip
    stream of uint64 N, float32 heldout_ratio, uint64 count, then count
    little-endian uint64 (u<<32|v)-packed edges. (A gzip header carries
    a time stamp: two dumps of one graph differ in bytes 4-8, their
    decompressed streams are equal.)"""
    if fmt == "ref":
        packed = np.ascontiguousarray(pack_edges(u, v), "<u8")
        with gzip.open(path, "wb") as f:
            f.write(np.uint64(num_nodes).astype("<u8").tobytes())
            f.write(np.float32(heldout_ratio).astype("<f4").tobytes())
            f.write(np.uint64(packed.size).astype("<u8").tobytes())
            f.write(packed.tobytes())
        return
    if fmt != "npz":
        raise ValueError(f"unknown dataset cache format {fmt!r}")
    with open(path, "wb") as f:     # the path as given: no .npz appended
        np.savez_compressed(
            f,
            num_nodes=np.int64(num_nodes),
            heldout_ratio=np.float64(heldout_ratio),
            edges=pack_edges(u, v),
        )


def load_dataset(path: str) -> Tuple[int, float, np.ndarray, np.ndarray]:
    """Load a cached dataset: (N, heldout_ratio, u, v). The format is
    sniffed from the file magic: PK (zip) -> npz cache, 1f 8b (gzip) ->
    the reference's binary layout (see dump_dataset)."""
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        with gzip.open(path, "rb") as f:
            head = f.read(20)
            if len(head) != 20:
                raise IOError(f"{path}: truncated reference cache header")
            num_nodes = int(np.frombuffer(head[0:8], "<u8")[0])
            ratio = float(np.frombuffer(head[8:12], "<f4")[0])
            count = int(np.frombuffer(head[12:20], "<u8")[0])
            body = f.read(count * 8)
            if len(body) != count * 8:
                raise IOError(f"{path}: reference cache holds "
                              f"{len(body) // 8} edges, header says "
                              f"{count}")
            u, v = unpack_edges(np.frombuffer(body, "<u8"))
        return num_nodes, ratio, u, v
    z = np.load(path)
    u, v = unpack_edges(z["edges"])
    return int(z["num_nodes"]), float(z["heldout_ratio"]), u, v
