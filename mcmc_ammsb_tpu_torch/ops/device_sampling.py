"""On-device minibatch sampling (counterpart of
``mcmc_ammsb_tpu/ops/device_sampling.py``), all six strategies.

  NodeLink    — one random non-isolated node, all of its training
                edges, weight N (degree-capped with a Horvitz-Thompson
                reweight under ``ds_link_cap``)
  NodeNonLink — m distinct non-links at one random node, excluding
                training and held-out edges, weight 2E/m_eff
  Node        — a fair coin per step between the two ("random"), or
                strict alternation ("alternate")
  BFLink      — breadth-first training-edge collection from a random
                pivot, weight E/m_eff
  BFNonLink   — breadth-first non-link collection (32 draws per expanded
                node, training edges rejected), weight (N(N-1)/2 - E)/m_eff
  BF          — the coin between the two, "random" or "alternate"

Everything is batched over the step axis with a fixed number of masked
redraw rounds, as in the JAX package. The breadth-first family replays
the host FIFO walk in ``ds_bf_rounds`` rounds of up to ``ds_bf_pops``
pops (``_bf_expand``). Its random draws come from a ``BFDraws`` (the
pivot draws and the BFNonLink candidate draws of every round, drawn in
one block from the sample generator by ``draw_bf``), so a test can hand
it the JAX package's own ``fold_in`` draws instead.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mcmc_ammsb_tpu_torch import rng
from mcmc_ammsb_tpu_torch.config import Config, SampleStrategy
from mcmc_ammsb_tpu_torch.ops.edgeset import EdgeSet
from mcmc_ammsb_tpu_torch.utils.profiling import stage


class DeviceSamples(NamedTuple):
    """A stacked batch of S device-sampled minibatches."""

    edges_u: torch.Tensor    # [S, E_cap] int32
    edges_v: torch.Tensor
    edge_mask: torch.Tensor  # [S, E_cap] bool
    nodes: torch.Tensor      # [S, B_cap] int32 (deduped; padded with N)
    node_mask: torch.Tensor  # [S, B_cap] bool
    weight: torch.Tensor     # [S] f32


class BFDraws(NamedTuple):
    """The random draws of one block of breadth-first expansions: for
    every round r, the pivot draw and its two redraws ``pivot[r]`` [3, S],
    and, for BFNonLink, the candidate draw and its ``ds_nonlink_rounds``
    redraws ``cand[r]`` [1 + rounds, S, P, 32] (JAX: ``fold_in(kr, t)``
    and ``fold_in(fold_in(kr, 9), t)`` of the round key kr)."""

    pivot: torch.Tensor                  # [R, 3, S] int32 in [0, N)
    cand: Optional[torch.Tensor] = None  # [R, 1 + rounds, S, P, 32]


#: Candidate draws per expanded node of BFNonLink (the host sampler's
#: per-expansion budget).
BF_NONLINK_DRAWS = 32


def draw_bf(cfg: Config, gen: torch.Generator, s_len: int, device,
            non_link: bool) -> BFDraws:
    """Every draw of ``s_len`` breadth-first expansions from ``gen``, in
    one block (two launches)."""
    r, p = cfg.ds_bf_rounds, cfg.ds_bf_pops
    pivot = rng.randint(gen, cfg.N, (r, 3, s_len), device)
    cand = (rng.randint(gen, cfg.N, (r, 1 + cfg.ds_nonlink_rounds, s_len,
                                     p, BF_NONLINK_DRAWS), device)
            if non_link else None)
    return BFDraws(pivot, cand)


class Adjacency(NamedTuple):
    """Training CSR (offsets [N+1], cols [2E]) on the device."""

    offsets: torch.Tensor
    cols: torch.Tensor

    def degree(self, u: torch.Tensor) -> torch.Tensor:
        u = u.long()
        return (self.offsets[u + 1] - self.offsets[u]).to(torch.int32)

    def row_gather(self, u: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
        idx = self.offsets[u.long()][..., None] + off
        return self.cols[idx.clamp(0, self.cols.shape[0] - 1)]


def _pad_last(x: torch.Tensor, pad: int, value) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, pad), value=value)


def _structural_nodes(cfg: Config, eu, ev, mask, pivot):
    """Deduped node list of a Node-family draw without sorting: lane 0 =
    pivot, lane 1+i = edge lane i's other endpoint; masked lanes hold
    the sentinel N."""
    partners = eu + ev - pivot[..., None]
    nodes = torch.cat([pivot[..., None], partners], dim=-1)
    nmask = torch.cat([torch.ones_like(mask[..., :1]), mask], dim=-1)
    nodes = torch.where(nmask, nodes, torch.full_like(nodes, cfg.N))
    b_cap = cfg.max_batch_nodes
    if nodes.shape[-1] < b_cap:
        pad = b_cap - nodes.shape[-1]
        nodes = _pad_last(nodes, pad, cfg.N)
        nmask = _pad_last(nmask, pad, False)
    else:
        nodes = nodes[..., :b_cap]
        nmask = nmask[..., :b_cap]
    return nodes, nmask


def _sample_node_link_batch(cfg: Config, adj: Adjacency,
                            gen: torch.Generator, s_len: int,
                            rounds: int | None = None):
    """[S] NodeLink draws: random non-isolated pivots (masked redraw
    rounds) + their CSR rows; with ``ds_link_cap`` hub rows are
    subsampled with replacement, keep-first deduped and reweighted by
    N / (1 - (1 - 1/d)^e_cap)."""
    if rounds is None:
        rounds = cfg.ds_link_rounds
    dev = adj.cols.device
    e_cap = cfg.max_batch_edges
    u = rng.randint(gen, cfg.N, (s_len,), dev)
    for _ in range(rounds):
        redraw = rng.randint(gen, cfg.N, (s_len,), dev)
        u = torch.where(adj.degree(u) == 0, redraw, u)
    deg = adj.degree(u)                                       # [S]
    lane = torch.arange(e_cap, dtype=torch.int32, device=dev)
    in_row = lane.expand(s_len, e_cap)
    valid = lane < deg[:, None]
    weight = torch.full((s_len,), float(cfg.N), dtype=torch.float32,
                        device=dev)
    if cfg.ds_link_cap and cfg.max_fan_out > e_cap:
        take_all = deg <= e_cap
        degf = deg.float().clamp(min=1.0)
        uni = torch.rand((s_len, e_cap), generator=gen, device=dev)
        off = torch.floor(uni * degf[:, None]).to(torch.int32)
        off = torch.minimum(off, deg[:, None] - 1)
        earlier = torch.ones(e_cap, e_cap, dtype=torch.bool,
                             device=dev).tril(-1)
        dup = torch.any((off[:, :, None] == off[:, None, :]) & earlier,
                        dim=-1)
        in_row = torch.where(take_all[:, None], in_row, off)
        valid = torch.where(take_all[:, None], valid,
                            (deg[:, None] > 0) & ~dup)
        p_inc = 1.0 - (1.0 - 1.0 / degf) ** e_cap
        weight = torch.where(take_all, weight,
                             cfg.N / p_inc.clamp(min=1e-30))
    v = adj.row_gather(u, in_row)
    eu = torch.minimum(u[:, None], v)
    ev = torch.maximum(u[:, None], v)
    return eu, ev, valid, weight, u


def _sample_node_non_link_batch(cfg: Config, training_set: EdgeSet,
                                heldout_set: EdgeSet,
                                gen: torch.Generator, s_len: int,
                                rounds: int | None = None):
    """[S] NodeNonLink draws; residual bad lanes after the redraw rounds
    are masked and the 2E/m_eff weight keeps the estimator unbiased
    (weight * m_eff == 2E exactly)."""
    if rounds is None:
        rounds = cfg.ds_nonlink_rounds
    dev = training_set.device
    m = cfg.mini_batch_size
    e_cap = cfg.max_batch_edges
    u = rng.randint(gen, cfg.N, (s_len,), dev)
    v = rng.randint(gen, cfg.N, (s_len, m), dev)
    earlier = torch.ones(m, m, dtype=torch.bool, device=dev).tril(-1)

    def bad_lanes(v):
        a = torch.minimum(u[:, None], v)
        b = torch.maximum(u[:, None], v)
        hit = training_set.has_edges(a, b) | heldout_set.has_edges(a, b)
        dup = torch.any((v[:, :, None] == v[:, None, :]) & earlier, dim=-1)
        return (v == u[:, None]) | hit | dup

    for _ in range(rounds):
        redraw = rng.randint(gen, cfg.N, (s_len, m), dev)
        v = torch.where(bad_lanes(v), redraw, v)
    ok = ~bad_lanes(v)
    eu = torch.minimum(u[:, None], v)
    ev = torch.maximum(u[:, None], v)
    pad = e_cap - m
    if pad:
        eu = _pad_last(eu, pad, 0)
        ev = _pad_last(ev, pad, 0)
        ok = _pad_last(ok, pad, False)
    m_eff = ok.sum(-1).float()
    weight = 2.0 * cfg.E / m_eff.clamp(min=1.0)
    return eu, ev, ok, weight, u


def _extract_nodes(cfg: Config, eu, ev, mask):
    """Deduped node list of batches without a shared pivot (the BF
    family): sort, blank repeats to the sentinel N, sort again so the
    unique ids form a prefix; [S, B_cap] ids and their mask."""
    sentinel = cfg.N
    ids = torch.cat([torch.where(mask, eu, sentinel),
                     torch.where(mask, ev, sentinel)], dim=-1)
    if ids.shape[-1] < cfg.max_batch_nodes:
        ids = _pad_last(ids, cfg.max_batch_nodes - ids.shape[-1], sentinel)
    s = torch.sort(ids, dim=-1).values
    dup = torch.cat([torch.zeros_like(s[..., :1], dtype=torch.bool),
                     s[..., 1:] == s[..., :-1]], dim=-1)
    s = torch.sort(torch.where(dup, sentinel, s), dim=-1).values
    uniq = s[..., :cfg.max_batch_nodes]
    return uniq, uniq != sentinel


def _compose_rows(buf: torch.Tensor, values: torch.Tensor,
                  dst: torch.Tensor) -> torch.Tensor:
    """``buf`` [S, W] with ``values[s, l]`` written at column ``dst[s, l]``
    (ordered append into fresh slots). Lanes with ``dst >= W`` are
    dropped, never clamped into the last column: the scatter goes into a
    [S, W + 1] copy whose last column is cut off. Kept ``dst`` are unique
    per row. (JAX composes a one-hot product on the TPU's matrix unit.)"""
    width = buf.shape[1]
    out = torch.cat([buf, buf.new_zeros(buf.shape[0], 1)], dim=1)
    out.scatter_(1, dst.long().clamp(0, width), values.to(buf.dtype))
    return out[:, :width]


def _keep_first_dups(num_nodes: int, a: torch.Tensor, b: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """True for valid lanes whose (a, b) pair already appeared at an
    EARLIER valid lane of the same row: one stable sort of the int64 key
    a*(N+1)+b (it overflows int32 from N = 46,340 on: a, b < N), equal
    neighbours marked, then scattered back to lane order. Invalid lanes
    get unique keys above every pair's."""
    s_len, lanes = a.shape
    pos = torch.arange(lanes, device=a.device).expand(s_len, lanes)
    key = torch.where(valid, a.long() * (num_nodes + 1) + b.long(),
                      (num_nodes + 1) ** 2 + pos)
    skey, order = torch.sort(key, dim=1, stable=True)
    dup = torch.cat([torch.zeros_like(skey[:, :1], dtype=torch.bool),
                     skey[:, 1:] == skey[:, :-1]], dim=1)
    return torch.zeros_like(dup).scatter_(1, order, dup) & valid


def _bf_expand(cfg: Config, draws: BFDraws, s_len: int, cand_fn,
               cand_width: int):
    """The breadth-first expansion engine of the device BF family: the
    host FIFO walk (pop u, skip it when seen, emit u's candidate edges in
    order, dict-deduped, stopping at m, push u's candidates; an empty
    queue gets a fresh unseen pivot), replayed for S steps at once in
    ``ds_bf_rounds`` rounds that each pop up to ``ds_bf_pops`` entries
    but never past the round-start tail, so the pops are the host's in
    its order. The queue holds q_cap = 1 + (R-1)*P entries, all that can
    ever be popped: pushes past it are dropped by design.

    ``cand_fn(r, u, expand) -> (v [S,P,C], cand_valid [S,P,C])`` gives
    each popped node's candidate partners in round r. Returns (eu, ev,
    edge_mask, m_eff) with [S, m] buffers."""
    S, P, R = s_len, cfg.ds_bf_pops, cfg.ds_bf_rounds
    m = cfg.mini_batch_size
    q_cap = 1 + (R - 1) * P
    dev = draws.pivot.device
    i32 = torch.int32

    qbuf = torch.zeros(S, q_cap, dtype=i32, device=dev)
    head = torch.zeros(S, dtype=i32, device=dev)
    tail = torch.zeros(S, dtype=i32, device=dev)
    seen = torch.zeros(S, q_cap, dtype=i32, device=dev)   # expanded nodes
    xcnt = torch.zeros(S, dtype=i32, device=dev)
    ebuf_a = torch.zeros(S, m, dtype=i32, device=dev)
    ebuf_b = torch.zeros(S, m, dtype=i32, device=dev)
    ecnt = torch.zeros(S, dtype=i32, device=dev)
    lane_x = torch.arange(q_cap, dtype=i32, device=dev)
    lane_m = torch.arange(m, dtype=i32, device=dev)
    lane_p = torch.arange(P, dtype=i32, device=dev)
    earlier = torch.ones(P, P, dtype=torch.bool, device=dev).tril(-1)

    def cumsum(x):
        return torch.cumsum(x.to(i32), dim=1, dtype=i32)

    for r in range(R):
        # empty queue: a fresh pivot at the tail, redrawn (twice at most)
        # while it was expanded already
        need = (tail == head) & (ecnt < m)
        pivot = draws.pivot[r, 0]
        for t in range(2):
            hit = ((pivot[:, None] == seen)
                   & (lane_x[None, :] < xcnt[:, None])).any(1)
            pivot = torch.where(hit, draws.pivot[r, t + 1], pivot)
        qbuf = _compose_rows(qbuf, pivot[:, None],
                             torch.where(need, tail, q_cap)[:, None])
        tail = torch.clamp(tail + need.to(i32), max=q_cap)

        # pop the next (up to) P entries, FIFO
        offs = head[:, None] + lane_p[None, :]
        pop_valid = offs < tail[:, None]
        u = torch.gather(qbuf, 1, offs.clamp(max=q_cap - 1).long())
        was_seen = ((u[:, :, None] == seen[:, None, :])
                    & (lane_x[None, None, :] < xcnt[:, None, None])).any(2)
        dup_pop = ((u[:, :, None] == u[:, None, :]) & pop_valid[:, None, :]
                   & earlier[None]).any(2)
        expand = pop_valid & ~was_seen & ~dup_pop
        head = head + torch.minimum(torch.full_like(head, P), tail - head)
        dstx = xcnt[:, None] + cumsum(expand) - 1
        seen = _compose_rows(seen, u, torch.where(expand, dstx, q_cap))
        xcnt = xcnt + expand.sum(1, dtype=i32)

        # the candidate edge stream, pop order x in-row order
        v, cvalid = cand_fn(r, u, expand)
        vf = v.reshape(S, P * cand_width)
        cvalid = cvalid.reshape(S, P * cand_width)
        uf = u.repeat_interleave(cand_width, dim=1)
        a = torch.minimum(uf, vf)
        b = torch.maximum(uf, vf)
        dup_buf = ((a[:, :, None] == ebuf_a[:, None, :])
                   & (b[:, :, None] == ebuf_b[:, None, :])
                   & (lane_m[None, None, :] < ecnt[:, None, None])).any(2)
        fresh = cvalid & ~dup_buf & ~_keep_first_dups(cfg.N, a, b, cvalid)
        before = ecnt[:, None] + cumsum(fresh) - fresh.to(i32)
        keep = fresh & (before < m)
        dst_e = torch.where(keep, before, m)
        ebuf_a = _compose_rows(ebuf_a, a, dst_e)
        ebuf_b = _compose_rows(ebuf_b, b, dst_e)
        ecnt = ecnt + keep.sum(1, dtype=i32)

        # queue pushes: every candidate emitted while the edge dict was
        # still short of m (the host pushes before its dict dedup)
        push = cvalid & (before < m)
        dst_q = tail[:, None] + cumsum(push) - 1
        dst_q = torch.where(push & (dst_q < q_cap), dst_q, q_cap)
        qbuf = _compose_rows(qbuf, vf, dst_q)
        tail = torch.clamp(tail + push.sum(1, dtype=i32), max=q_cap)

    mask = lane_m[None, :] < ecnt[:, None]
    return ebuf_a, ebuf_b, mask, ecnt


def _pad_bf(cfg: Config, eu, ev, mask):
    pad = cfg.max_batch_edges - eu.shape[1]
    if pad:
        eu, ev = _pad_last(eu, pad, 0), _pad_last(ev, pad, 0)
        mask = _pad_last(mask, pad, False)
    return eu, ev, mask


def _bf_weight(total: float, m_eff: torch.Tensor) -> torch.Tensor:
    """total / max(m_eff, 1) in float32, a true division (torch's
    ``scalar / tensor`` multiplies by the reciprocal)."""
    m = m_eff.float().clamp(min=1.0)
    return torch.full_like(m, total) / m


def _sample_bf_link_batch(cfg: Config, adj: Adjacency, draws: BFDraws,
                          s_len: int):
    """[S] BFLink draws: breadth-first training-edge collection from a
    random pivot, weight E/m_eff. A popped node's candidates are its CSR
    row truncated at 2m, which is exact at any degree: the host walk
    consumes at most m row positions of one expansion before its edge
    dict is full (the JAX package's proof)."""
    r_cap = max(1, min(cfg.max_fan_out, 2 * cfg.mini_batch_size))
    lane = torch.arange(r_cap, dtype=torch.int32, device=draws.pivot.device)

    def cand_fn(r, u, expand):
        uc = u.clamp(max=cfg.N - 1)
        v = adj.row_gather(uc, lane.expand(*u.shape, r_cap))
        cvalid = expand[..., None] & (lane < adj.degree(uc)[..., None])
        return v, cvalid

    eu, ev, mask, m_eff = _bf_expand(cfg, draws, s_len, cand_fn, r_cap)
    eu, ev, mask = _pad_bf(cfg, eu, ev, mask)
    return eu, ev, mask, _bf_weight(float(cfg.E), m_eff)


def _sample_bf_non_link_batch(cfg: Config, training_set: EdgeSet,
                              draws: BFDraws, s_len: int):
    """[S] BFNonLink draws: each popped node contributes up to 32
    uniform non-partners (self and TRAINING edges rejected, with
    ``ds_nonlink_rounds`` masked redraws; the held-out set is not
    consulted, as on the host), weight (N(N-1)/2 - E)/m_eff."""

    def cand_fn(r, u, expand):
        def bad(v):
            a = torch.minimum(u[..., None], v)
            b = torch.maximum(u[..., None], v)
            return (v == u[..., None]) | training_set.has_edges(a, b)

        v = draws.cand[r, 0]
        for t in range(cfg.ds_nonlink_rounds):
            v = torch.where(bad(v), draws.cand[r, t + 1], v)
        return v, expand[..., None] & ~bad(v)

    eu, ev, mask, m_eff = _bf_expand(cfg, draws, s_len, cand_fn,
                                     BF_NONLINK_DRAWS)
    eu, ev, mask = _pad_bf(cfg, eu, ev, mask)
    return eu, ev, mask, _bf_weight(cfg.N * (cfg.N - 1) / 2.0 - cfg.E,
                                    m_eff)


def _interleave_steps(link, non, n_link: int, n_non: int, period: int):
    """Merge two per-step draw blocks so steps 0,2,4,... take the
    ``link`` rows and 1,3,5,... the ``non`` rows (``period`` draws per
    step)."""
    def mix(a, b):
        tail = a.shape[1:]
        a2 = a.reshape(n_link, period, *tail)
        b2 = b.reshape(n_non, period, *tail)
        out = torch.stack([a2[:n_non], b2], dim=1).reshape(
            2 * n_non * period, *tail)
        if n_link > n_non:     # odd step count: trailing link step
            out = torch.cat([out, a2[n_non:].reshape(period, *tail)])
        return out

    return tuple(mix(a, b) for a, b in zip(link, non))


def _alternate(link_fn, non_fn, s_len: int, alt_period: int):
    """Strict link / non-link alternation by step: each sampler runs at
    half volume (``link_fn(n)``, ``non_fn(n)`` draw n batches)."""
    if s_len % alt_period:
        raise ValueError(f"s_len={s_len} must be a multiple of "
                         f"alt_period={alt_period}")
    n_steps = s_len // alt_period
    n_link, n_non = (n_steps + 1) // 2, n_steps // 2
    link = link_fn(n_link * alt_period)
    if n_non == 0:
        return link
    return _interleave_steps(link, non_fn(n_non * alt_period), n_link,
                             n_non, alt_period)


def _coin(gen: torch.Generator, link, non, s_len: int, device):
    """The per-step fair coin between two full-volume draws: a row
    select of every field."""
    coin = torch.rand((s_len,), generator=gen, device=device) < 0.5
    return tuple(torch.where(coin.view(-1, *([1] * (a.dim() - 1))), a, b)
                 for a, b in zip(link, non))


def sample_minibatches_device(cfg: Config, training_set: EdgeSet,
                              heldout_set: EdgeSet, gen: torch.Generator,
                              s_len: int, adjacency: Adjacency,
                              alt_period: int = 1) -> DeviceSamples:
    """Draw ``s_len`` minibatches (one per step) in one block.
    ``adjacency`` is the training CSR on the device; ``alt_period`` is
    the number of draws per step (the chain count of the flat chain
    engine), by which ``node_coin='alternate'`` alternates."""
    st = cfg.strategy
    bf_family = st in (SampleStrategy.BF, SampleStrategy.BF_LINK,
                       SampleStrategy.BF_NON_LINK)
    if (st != SampleStrategy.NODE_NON_LINK
            and not bf_family         # BF batches hold <= m edges
            and not cfg.ds_link_cap
            and cfg.max_batch_edges < cfg.max_fan_out):
        raise ValueError(
            f"batch edge capacity {cfg.max_batch_edges} cannot hold the "
            f"max fan-out {cfg.max_fan_out}; NodeLink batches would be "
            "silently truncated")
    dev = adjacency.cols.device

    def node_link(n):
        with stage("ds_link"):
            return _sample_node_link_batch(cfg, adjacency, gen, n)

    def node_non(n):
        with stage("ds_nonlink"):
            return _sample_node_non_link_batch(cfg, training_set,
                                               heldout_set, gen, n)

    def bf_link(n):
        with stage("ds_bf_link"):
            return _sample_bf_link_batch(
                cfg, adjacency, draw_bf(cfg, gen, n, dev, False), n)

    def bf_non(n):
        with stage("ds_bf_nonlink"):
            return _sample_bf_non_link_batch(
                cfg, training_set, draw_bf(cfg, gen, n, dev, True), n)

    link_fn, non_fn = (bf_link, bf_non) if bf_family else (node_link,
                                                           node_non)
    if st in (SampleStrategy.NODE_LINK, SampleStrategy.BF_LINK):
        out = link_fn(s_len)
    elif st in (SampleStrategy.NODE_NON_LINK, SampleStrategy.BF_NON_LINK):
        out = non_fn(s_len)
    elif cfg.node_coin == "alternate":
        out = _alternate(link_fn, non_fn, s_len, alt_period)
    else:
        out = _coin(gen, link_fn(s_len), non_fn(s_len), s_len, dev)
    with stage("ds_extract_nodes"):
        if bf_family:
            # BF batches span many expanded nodes: the sort dedup
            eu, ev, mask, weight = out
            nodes, node_mask = _extract_nodes(cfg, eu, ev, mask)
        else:
            eu, ev, mask, weight, pivot = out
            nodes, node_mask = _structural_nodes(cfg, eu, ev, mask, pivot)
    return DeviceSamples(eu, ev, mask, nodes, node_mask, weight)


def sample_minibatch_device(cfg: Config, training_set: EdgeSet,
                            heldout_set: EdgeSet, gen: torch.Generator,
                            adjacency: Adjacency) -> DeviceSamples:
    """One minibatch (the S = 1 case of ``sample_minibatches_device``,
    without the leading axis; the JAX package's single-step wrapper)."""
    s = sample_minibatches_device(cfg, training_set, heldout_set, gen, 1,
                                  adjacency)
    return DeviceSamples(*(x[0] for x in s))
