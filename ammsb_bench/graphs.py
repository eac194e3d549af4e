"""The cells' graphs: a frozen numpy copy of the port's power-law
surrogate generator, and the per-run edge order drawn from the seed.

``powerlaw_edges`` is ``mcmc_ammsb_tpu_torch.data.synthetic_powerlaw_edges``
(with ``renumber_dedup_shuffle``) as it stood when the benchmark was
written, so a change to the program cannot change the benchmark's input.
A configuration's graph is fixed by its own parameters and seed, as a
SNAP file is; it is cached in ``.cache/graphs/`` inside the checkout,
keyed by those parameters. The run's seed draws the order of the edge
list, which decides the held-out split, and every other seed of the run
(``run_seeds``).
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np

CACHE_DIR = Path(__file__).resolve().parent / ".cache" / "graphs"

_MASK64 = (1 << 64) - 1


def _pack(u, v) -> np.ndarray:
    return (np.asarray(u, np.uint64) << np.uint64(32)) | np.asarray(
        v, np.uint64)


def _unpack(e):
    e = np.asarray(e, np.uint64)
    return ((e >> np.uint64(32)).astype(np.int32),
            (e & np.uint64(0xFFFFFFFF)).astype(np.int32))


def renumber_dedup_shuffle(a, b, shuffle_seed: int = 0):
    """Vertex renumber to [0, N), self-loop drop, dedup, shuffle."""
    keep = a != b
    a, b = a[keep], b[keep]
    uniq, inv = np.unique(np.concatenate([a, b]), return_inverse=True)
    n = len(uniq)
    a = inv[: len(a)].astype(np.int32)
    b = inv[len(b):].astype(np.int32)
    packed = np.unique(_pack(np.minimum(a, b), np.maximum(a, b)))
    np.random.RandomState(shuffle_seed).shuffle(packed)
    u, v = _unpack(packed)
    return n, u, v


def powerlaw_edges(num_nodes: int, avg_degree: float, exponent: float,
                   max_degree: int, num_communities: int,
                   intra_fraction: float, seed: int):
    """A degree-corrected planted partition whose degrees follow a
    truncated power law: (N, u, v), canonical (u < v), deduped, shuffled,
    isolated nodes dropped."""
    rng = np.random.RandomState(seed)
    theta = rng.pareto(exponent - 1.0, num_nodes) + 1.0
    for _ in range(4):
        scale = avg_degree * num_nodes / theta.sum()
        theta = np.minimum(theta, max_degree / scale)
    p_global = theta / theta.sum()
    total = int(num_nodes * avg_degree) // 2
    a = rng.choice(num_nodes, size=total, p=p_global)
    labels = rng.randint(0, num_communities, num_nodes)
    b = rng.choice(num_nodes, size=total, p=p_global)
    intra = rng.rand(total) < intra_fraction
    order = np.argsort(labels, kind="stable")
    lab_sorted = labels[order]
    cum = np.cumsum(theta[order])
    cum0 = np.concatenate([[0.0], cum])
    seg_lo = np.searchsorted(lab_sorted, np.arange(num_communities))
    seg_hi = np.searchsorted(lab_sorted, np.arange(num_communities) + 1)
    c_edge = labels[a]
    lo, hi = seg_lo[c_edge], seg_hi[c_edge]
    redir = intra & (hi - lo >= 2)
    r = rng.rand(int(redir.sum()))
    mass = cum0[lo[redir]] + r * (cum0[hi[redir]] - cum0[lo[redir]])
    pos = np.searchsorted(cum, mass, side="left")
    pos = np.clip(pos, lo[redir], hi[redir] - 1)
    b[redir] = order[pos]
    return renumber_dedup_shuffle(a, b, shuffle_seed=seed + 1)


def _graph_args(graph: dict) -> dict:
    return {"num_nodes": int(graph["nodes"]),
            "avg_degree": float(graph["avg_degree"]),
            "exponent": float(graph["exponent"]),
            "max_degree": int(graph["max_degree"]),
            "num_communities": int(graph["communities"]),
            "intra_fraction": float(graph["intra_fraction"]),
            "seed": int(graph["seed"])}


def load_graph(graph: dict, cache_dir: Path = CACHE_DIR):
    """The configuration's graph (N, u, v), from the cache when it holds
    it, else generated and cached. Returns (N, u, v, cache_hit)."""
    args = _graph_args(graph)
    key = hashlib.sha256(json.dumps(args, sort_keys=True).encode()
                         ).hexdigest()[:16]
    path = Path(cache_dir) / f"powerlaw-{key}.npz"
    if path.exists():
        with np.load(path) as z:
            return int(z["n"]), z["u"], z["v"], True
    n, u, v = powerlaw_edges(**args)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, n=np.int64(n), u=u, v=v)
    os.replace(tmp, path)
    return n, u, v, False


def _splitmix(x: int) -> int:
    z = x & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def sub_seed(seed: int, i: int) -> int:
    """A 64-bit seed for purpose ``i`` of the run seeded ``seed``: every
    bit of ``seed`` counts, however large it is."""
    return _splitmix(seed + (i + 1) * 0x9E3779B97F4A7C15)


def run_seeds(seed: int) -> dict:
    """Every seed of one run, drawn from ``--seed``: the edge order, the
    held-out split's non-edges, and the program's init and stream seeds
    (31-bit halves where the program packs a pair)."""
    h = [sub_seed(seed, i) for i in range(10)]
    low = [x & 0x7FFFFFFF for x in h]
    return {"order": h[0], "split": h[1] & 0xFFFFFFFF,
            "init": h[2] >> 1,
            "phi": (low[3], low[4]), "beta": (low[5], low[6]),
            "neighbor": (low[7], low[8]), "sample": low[9]}


def ordered_edges(u: np.ndarray, v: np.ndarray, order_seed: int):
    """The edge list in the run's order: its first edges are held out."""
    perm = np.random.default_rng(order_seed).permutation(len(u))
    return (np.ascontiguousarray(u[perm]), np.ascontiguousarray(v[perm]))
