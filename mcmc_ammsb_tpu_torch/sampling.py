"""Host-side minibatch sampling: the six reference strategies and the
prefetch thread (counterpart of ``mcmc_ammsb_tpu/sampling.py``, pure
numpy: nothing here touches torch or the device).

The strategies over the training CSR, each with the importance weight
("scale") that the beta gradient consumes:

  NodeLink    -> N
  NodeNonLink -> 2E / m
  Node        -> fair coin between the two
  BFLink      -> E / m
  BFNonLink   -> (N(N-1)/2 - E) / m
  BF          -> fair coin

Batches are padded to the static shapes ``max_batch_edges`` /
``max_batch_nodes``; padded lanes hold id 0 and a false mask (the
device samplers pad node lanes with the sentinel N instead: consumers
go by the mask, never by the id).

``PrefetchingSampler`` is a producer thread that keeps two batches (or
chunks) ready, so host sampling of chunk t+1 overlaps device compute of
chunk t. ``sample_many`` runs in the native C++ library
(``native.sample_batches``) when it is built.
"""

from __future__ import annotations

import dataclasses
import queue as queue_mod
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from mcmc_ammsb_tpu_torch.config import Config, SampleStrategy
from mcmc_ammsb_tpu_torch.data import DataSplit, Graph
from mcmc_ammsb_tpu_torch.types import VERTEX_DTYPE, canonicalize, pack_edges


class SamplerExhausted(RuntimeError):
    """A rejection-sampling loop ran out of retry budget: the graph
    cannot supply the requested minibatch (e.g. a near-complete graph
    asked for more non-links than exist). The native sampler returns
    rc=-4 for the same condition, so both host paths fail the same
    way."""


@dataclasses.dataclass
class MiniBatch:
    """One padded minibatch (host numpy)."""

    edges_u: np.ndarray    # [max_batch_edges] int32
    edges_v: np.ndarray    # [max_batch_edges]
    edge_mask: np.ndarray  # [max_batch_edges] bool
    nodes: np.ndarray      # [max_batch_nodes] int32 (deduped endpoints)
    node_mask: np.ndarray  # [max_batch_nodes] bool
    weight: np.float32     # strategy importance weight


class MiniBatchSampler:
    """Stateful host sampler over the training graph.

    Chunked sampling (``sample_many``) runs in the native C++ sampler
    (``native.sample_batches``) when it is built and falls back to the
    numpy strategies below. ``cfg.host_sampler`` forces one path
    ("native" raises when the build fails, "numpy"; "auto" probes the
    toolchain). ``sample`` (one batch) is always numpy. The two routes
    draw different batches from the same seed: the native route seeds
    each call with ``seed0 * 0x9E3779B9 + call_count``.
    """

    def __init__(self, cfg: Config, graph: Graph, split: DataSplit,
                 seed: Optional[int] = None):
        self.cfg = cfg
        self.graph = graph
        self.seed0 = cfg.sample_seed if seed is None else seed
        self.rng = np.random.RandomState(self.seed0)
        # membership oracles for the NodeNonLink exclusion
        self._heldout_sorted = np.sort(
            pack_edges(split.heldout_u, split.heldout_v))
        self._heldout = set(self._heldout_sorted.tolist())
        if cfg.host_sampler == "numpy":
            self.use_native = False
        else:
            from mcmc_ammsb_tpu_torch import native
            self.use_native = native.available()
            if cfg.host_sampler == "native" and not self.use_native:
                raise RuntimeError(
                    "native sampler requested but the C++ build is "
                    f"unavailable ({native.build_error})")
        self._native_call_count = 0

    # -- strategies --------------------------------------------------------

    def _budget(self, extra: int = 0) -> int:
        """Rejection-retry budget, the native path's (100*(m+N)+1000
        attempts, then rc=-4): pathological inputs (near-complete graphs, m close to the
        number of possible non-links, all-isolated node sets) fail
        loudly instead of spinning forever."""
        return 100 * (self.graph.num_nodes + extra) + 1000

    def _exhausted(self, what: str) -> "SamplerExhausted":
        return SamplerExhausted(
            f"{what}: retry budget exhausted after "
            f"{self._budget(self.cfg.mini_batch_size)} attempts — the "
            "graph cannot supply this minibatch (native sampler "
            "returns rc=-4 for the same condition)")

    def _node_link(self) -> Tuple[np.ndarray, np.ndarray, float]:
        g = self.graph
        for _ in range(self._budget()):
            u = self.rng.randint(g.num_nodes)
            nbrs = g.neighbors_of(u)
            if len(nbrs):
                break
        else:
            raise self._exhausted("NodeLink (no non-isolated pivot)")
        uu = np.full(len(nbrs), u, VERTEX_DTYPE)
        eu, ev = canonicalize(uu, nbrs.astype(VERTEX_DTYPE))
        return eu, ev, float(self.cfg.N)

    def _node_non_link(self) -> Tuple[np.ndarray, np.ndarray, float]:
        cfg, g = self.cfg, self.graph
        m = cfg.mini_batch_size
        u = self.rng.randint(g.num_nodes)
        chosen_v = set()
        eu = np.empty(m, VERTEX_DTYPE)
        ev = np.empty(m, VERTEX_DTYPE)
        count = 0
        attempts = 0
        budget = self._budget(m)
        while count < m:
            attempts += 1
            if attempts > budget:
                raise self._exhausted(
                    f"NodeNonLink (found {count}/{m} non-links at "
                    f"pivot {u})")
            v = self.rng.randint(g.num_nodes)
            if v == u or v in chosen_v:
                continue
            a, b = (u, v) if u < v else (v, u)
            if g.has_edge(a, b) or int(pack_edges(a, b)) in self._heldout:
                continue
            chosen_v.add(v)
            eu[count], ev[count] = a, b
            count += 1
        return eu, ev, 2.0 * cfg.E / m

    def _fresh_pivot(self, seen_u) -> int:
        for _ in range(self._budget()):
            u = self.rng.randint(self.graph.num_nodes)
            if u not in seen_u:
                return u
        raise self._exhausted("BF (no unseen pivot left)")

    def _bf_link(self) -> Tuple[np.ndarray, np.ndarray, float]:
        cfg, g = self.cfg, self.graph
        m = cfg.mini_batch_size
        seen_u, q, edges = set(), [], {}
        attempts = 0
        budget = self._budget(m)
        while len(edges) < m:
            attempts += 1
            if attempts > budget:
                raise self._exhausted(
                    f"BFLink (found {len(edges)}/{m} edges)")
            if not q:
                q.append(self._fresh_pivot(seen_u))
            u = q.pop(0)
            if u in seen_u:
                continue
            seen_u.add(u)
            for v in g.neighbors_of(u):
                if len(edges) >= m:
                    break
                q.append(int(v))
                a, b = (u, int(v)) if u < v else (int(v), u)
                edges[(a, b)] = None
        eu = np.fromiter((e[0] for e in edges), VERTEX_DTYPE, len(edges))
        ev = np.fromiter((e[1] for e in edges), VERTEX_DTYPE, len(edges))
        return eu, ev, float(cfg.E) / m

    def _bf_non_link(self) -> Tuple[np.ndarray, np.ndarray, float]:
        cfg, g = self.cfg, self.graph
        m = cfg.mini_batch_size
        seen_u, q, edges = set(), [], {}
        attempts = 0
        budget = self._budget(m)
        while len(edges) < m:
            attempts += 1
            if attempts > budget:
                raise self._exhausted(
                    f"BFNonLink (found {len(edges)}/{m} non-links)")
            if not q:
                q.append(self._fresh_pivot(seen_u))
            u = q.pop(0)
            if u in seen_u:
                continue
            seen_u.add(u)
            nbrs = set(g.neighbors_of(u).tolist())
            for _ in range(32):
                if len(edges) >= m:
                    break
                for _ in range(self._budget()):
                    v = self.rng.randint(g.num_nodes)
                    if v != u and v not in nbrs:
                        break
                else:
                    raise self._exhausted(
                        f"BFNonLink (pivot {u} is adjacent to every "
                        "other node)")
                q.append(v)
                a, b = (u, v) if u < v else (v, u)
                edges[(a, b)] = None
        eu = np.fromiter((e[0] for e in edges), VERTEX_DTYPE, len(edges))
        ev = np.fromiter((e[1] for e in edges), VERTEX_DTYPE, len(edges))
        return eu, ev, (cfg.N * (cfg.N - 1) / 2.0 - cfg.E) / m

    def _sample_raw(self) -> Tuple[np.ndarray, np.ndarray, float]:
        s = self.cfg.strategy
        if s == SampleStrategy.NODE:
            s = (SampleStrategy.NODE_LINK if self.rng.randint(2)
                 else SampleStrategy.NODE_NON_LINK)
        elif s == SampleStrategy.BF:
            s = (SampleStrategy.BF_LINK if self.rng.randint(2)
                 else SampleStrategy.BF_NON_LINK)
        if s == SampleStrategy.NODE_LINK:
            return self._node_link()
        if s == SampleStrategy.NODE_NON_LINK:
            return self._node_non_link()
        if s == SampleStrategy.BF_LINK:
            return self._bf_link()
        if s == SampleStrategy.BF_NON_LINK:
            return self._bf_non_link()
        raise ValueError(s)

    # -- padded batch assembly --------------------------------------------

    def sample(self) -> MiniBatch:
        eu, ev, weight = self._sample_raw()
        return pad_batch(self.cfg, eu, ev, weight)

    def sample_many(self, count: int) -> "StackedBatches":
        """Sample ``count`` minibatches stacked along a leading axis:
        one chunk of the scanned training loop."""
        if self.use_native:
            return self._sample_many_native(count)
        batches = [self.sample() for _ in range(count)]
        return StackedBatches(
            edges_u=np.stack([b.edges_u for b in batches]),
            edges_v=np.stack([b.edges_v for b in batches]),
            edge_mask=np.stack([b.edge_mask for b in batches]),
            nodes=np.stack([b.nodes for b in batches]),
            node_mask=np.stack([b.node_mask for b in batches]),
            weight=np.asarray([b.weight for b in batches], np.float32),
        )

    def _sample_many_native(self, count: int) -> "StackedBatches":
        from mcmc_ammsb_tpu_torch import native

        cfg, g = self.cfg, self.graph
        self._native_call_count += 1
        seed = (self.seed0 * 0x9E3779B9 + self._native_call_count)
        eu, ev, em, nd, nm, w = native.sample_batches(
            g.offsets, g.cols, g.num_nodes, self._heldout_sorted,
            cfg.strategy.value, cfg.mini_batch_size,
            float(cfg.N), float(cfg.E), count,
            cfg.max_batch_edges, cfg.max_batch_nodes, seed,
        )
        return StackedBatches(eu, ev, em, nd, nm, w)


@dataclasses.dataclass
class StackedBatches:
    edges_u: np.ndarray    # [S, max_batch_edges]
    edges_v: np.ndarray
    edge_mask: np.ndarray
    nodes: np.ndarray      # [S, max_batch_nodes]
    node_mask: np.ndarray
    weight: np.ndarray     # [S]


def pad_batch(cfg: Config, eu: np.ndarray, ev: np.ndarray,
              weight: float) -> MiniBatch:
    """Pad a raw edge list to static shapes; the node list is the
    sorted, deduplicated endpoints."""
    ne = len(eu)
    cap_e, cap_n = cfg.max_batch_edges, cfg.max_batch_nodes
    if ne > cap_e:
        raise ValueError(f"minibatch of {ne} edges exceeds capacity {cap_e}")
    edges_u = np.zeros(cap_e, VERTEX_DTYPE)
    edges_v = np.zeros(cap_e, VERTEX_DTYPE)
    edges_u[:ne], edges_v[:ne] = eu, ev
    edge_mask = np.arange(cap_e) < ne

    uniq = np.unique(np.concatenate([eu, ev]))
    nn = len(uniq)
    if nn > cap_n:
        raise ValueError(f"{nn} minibatch nodes exceed capacity {cap_n}")
    nodes = np.zeros(cap_n, VERTEX_DTYPE)
    nodes[:nn] = uniq
    node_mask = np.arange(cap_n) < nn
    return MiniBatch(edges_u, edges_v, edge_mask, nodes, node_mask,
                     np.float32(weight))


class PrefetchingSampler:
    """Producer-thread wrapper: keeps ``depth`` batches ready.

    CUDA launches are asynchronous, so a depth-2 host queue hides the
    sampling behind device work as long as the sampler keeps up.

    Producer exceptions propagate to the consumer (re-raised from
    ``get``), and ``drain()`` quiesces the thread and hands back every
    produced-but-unconsumed item, in production order: the in-flight
    state a checkpoint must capture for a bit-exact resume.
    """

    def __init__(self, sampler: MiniBatchSampler, depth: int = 2,
                 chunk: int = 1):
        self._sampler = sampler
        self._chunk = chunk
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error = None
        self._held = []
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self):
        while not self._stop.is_set():
            try:
                item = (self._sampler.sample() if self._chunk == 1
                        else self._sampler.sample_many(self._chunk))
            except BaseException as e:  # surface instead of deadlock
                self._error = e
                self._q.put(_ProducerFailed(e))
                return
            while True:
                if self._stop.is_set():
                    # drawn but not queued: drain() hands it back last,
                    # so the sampler's stream position loses nothing
                    self._held = [item]
                    return
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue_mod.Full:
                    continue

    def get(self):
        item = self._q.get()
        if isinstance(item, _ProducerFailed):
            raise RuntimeError("sampling producer failed") from item.error
        return item

    def drain(self):
        """Stop the producer and return the unconsumed in-flight items,
        in production order."""
        self._stop.set()
        self._thread.join()
        pending = []
        try:
            while True:
                item = self._q.get_nowait()
                if isinstance(item, _ProducerFailed):
                    raise RuntimeError("sampling producer failed") \
                        from item.error
                pending.append(item)
        except queue_mod.Empty:
            pass
        return pending + self._held

    def close(self):
        self._stop.set()
        self._thread.join()
        try:
            while True:
                self._q.get_nowait()
        except queue_mod.Empty:
            pass


class _ProducerFailed:
    def __init__(self, error: BaseException):
        self.error = error
