"""Multi-GPU training over a ('data', 'model') mesh of torch.distributed
ranks (counterpart of ``mcmc_ammsb_tpu/parallel/sharded.py``).

Layout (one process per GPU; ``mesh.py``):

  pi [N_pad, K]   — rows sharded over 'model': rank (d, m) holds rows
                    [m*R, (m+1)*R), R = N_pad / M; replicated over 'data'.
  phi_sum [N_pad] — sharded like pi's rows.
  theta/beta [K]  — replicated everywhere (they are tiny).
  minibatch       — nodes and edges sharded over 'data'.
  heldout eval    — edges + running ppx state sharded over 'data'.

Collectives per step (NCCL on cards, gloo on the CPU):
  * row fetch:   masked local gather + all-reduce(SUM) over the model
                 group — the standard distributed embedding lookup; one
                 all-reduce carries a step's node and neighbor rows and
                 their phi sums ([rows, K+1]).
  * write-back:  an all-gather of the staged rows (with their sums, ids
                 and mask packed in one float32 buffer, ids as bit views)
                 over the data group; each model shard applies the rows
                 that land in its range (the node list is globally
                 deduplicated, so writes are collision-free).

With bfloat16 pi storage (``cfg.pi_dtype``) only the local rows are
bf16: the fetch upcasts them to float32 before the all-reduce (a masked
row plus zeros is exact in float32, and gloo's bf16 collectives are not
relied on), every collective carries float32, and the write-back rounds
to nearest-even (``ops/phi.scatter_rows``).
  * beta grads:  all-reduce of per-edge partial gradients over the data
                 group.

theta/beta updates are computed redundantly on every rank from identical
sums and identical generator states, so replicated state stays
bit-identical without a broadcast.

Random streams. The port's streams are stateful generators
(``rng.Streams``), not keys folded by step and shard index, so the JAX
law "fold the data index into the key" becomes "add it to the seed
pair's second word": the phi noise of data shard d comes from
``generator((phi_seed[0], phi_seed[1] + d))``, and so do private
neighbor draws; the shared neighbor draws, the theta noise and the
device sampler use the single-GPU seeds on every rank. Data shard 0's
streams are the single-GPU ``Learner``'s, so a (1, M) mesh runs the
``Learner``'s trajectory, up to the order of the float reductions. Every
rank keeps all D phi streams: the windowed path draws lane d*B_local+j
from shard d's stream, as the unwindowed path does on rank d.

The windowed path (``_sharded_windowed_scan``): each window is ONE row
fetch of all T*(B+n) read rows over the model group, then ONE launch of
the window kernel (``csrc/window_kernel.cu``) on the fetched rows as its
table — node and neighbor ids are remapped to slots of that table, one
slot per distinct id (``window_slots``), so the kernel's self-exclusion
(a neighbor equal to the node) and its last-write-wins write-back see
ids as before — then
a purely local write-back of the kept rows to the shard. Every rank runs
the window of the whole global batch (it is tiny), as JAX's windowed
sharded path does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from mcmc_ammsb_tpu_torch import native, rng
from mcmc_ammsb_tpu_torch.config import Config, PhiImpl, RngBackend
from mcmc_ammsb_tpu_torch.data import (DataSplit, Graph,
                                       make_training_ppx_edges)
from mcmc_ammsb_tpu_torch.learner import (DeviceBatch, Learner, TrainState,
                                          edge_lanes, gamma_draws, gamma_rows,
                                          hoist_operands, pi_storage_dtype)
from mcmc_ammsb_tpu_torch.ops import beta as beta_ops
from mcmc_ammsb_tpu_torch.ops import perplexity as ppx_ops
from mcmc_ammsb_tpu_torch.ops import phi as phi_ops
from mcmc_ammsb_tpu_torch.ops.device_sampling import (
    Adjacency, sample_minibatches_device)
from mcmc_ammsb_tpu_torch.ops.edgeset import build_edge_set
from mcmc_ammsb_tpu_torch.ops.window import (_advance, index_operands,
                                             iter_windows,
                                             window_apply_cuda,
                                             window_core_torch)
from mcmc_ammsb_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from mcmc_ammsb_tpu_torch.parallel.partitioned import (
    build_sharded_csr, make_training_ppx_edges_partitioned)
from mcmc_ammsb_tpu_torch.sampling import MiniBatchSampler
from mcmc_ammsb_tpu_torch.utils.profiling import stage
from mcmc_ammsb_tpu_torch.utils.timing import StageTimers


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class ShardCtx(NamedTuple):
    """What the step bodies read besides the state: the config, the
    mesh, the rows of a model shard and the training edge set (a
    replicated ``EdgeSet`` or the rank's ``ShardedCSR``)."""

    cfg: Config
    mesh: Mesh
    rows_per_shard: int
    edge_set: object


def fold_seed(pair, d: int):
    """A seed pair with the data-shard index added to its second word
    (the port's counterpart of JAX's ``fold_in(key, d)``); d = 0 leaves
    it as it is."""
    return (int(pair[0]), int(pair[1]) + d)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _owned(mesh: Mesh, rows_per_shard: int, idx: torch.Tensor):
    """(local row, owned) of global row ids ``idx`` on this model shard;
    the local row is clamped into the shard."""
    local = idx.long() - mesh.m_idx * rows_per_shard
    ok = (local >= 0) & (local < rows_per_shard)
    return local.clamp(0, rows_per_shard - 1), ok


def _fetch(mesh: Mesh, rows_per_shard: int, idx: torch.Tensor, *tables):
    """Cross-shard gather of ``tables`` (this shard's rows of each, [R] or
    [R, K]) at global row ids ``idx``: a local masked gather and ONE
    all-reduce over the model group of the tables' rows side by side, in
    float32 (compute stays float32 whatever the storage). A row id
    outside every shard (the sentinel N when M divides N) comes back as
    zeros. Returns one tensor per table, shaped ``idx.shape + row``."""
    li, ok = _owned(mesh, rows_per_shard, idx.reshape(-1))
    cols = [t[li].float().reshape(li.shape[0], -1) for t in tables]
    buf = (cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)) * ok.to(
        torch.float32)[:, None]
    dist.all_reduce(buf, group=mesh.model_group)
    out, at = [], 0
    for t, c in zip(tables, cols):
        out.append(buf[:, at:at + c.shape[1]].contiguous().reshape(
            *idx.shape, *t.shape[1:]))
        at += c.shape[1]
    return out


def _fetch_rows(mesh: Mesh, rows_per_shard: int, pi_local: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``_fetch_rows``: pi's rows at ``idx``."""
    return _fetch(mesh, rows_per_shard, idx, pi_local)[0]


def _fetch_scalars(mesh: Mesh, rows_per_shard: int, x_local: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``_fetch_scalars``: phi_sum at ``idx``."""
    return _fetch(mesh, rows_per_shard, idx, x_local)[0]


def _gather_data(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """All-gather over the data group, concatenated on dim 0 in data-index
    order."""
    out = x.new_empty((mesh.shape[DATA_AXIS] * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=mesh.data_group)
    return out


def _apply_rows(mesh: Mesh, rows_per_shard: int, s: TrainState,
                nodes, mask, rows, sums) -> TrainState:
    """Write the rows of the unmasked lanes that land in this shard's
    range into the local pi and phi_sum, in place (the write-back of the
    JAX package's ``.at[safe].set(mode="drop")``)."""
    local, ok = _owned(mesh, rows_per_shard, nodes)
    pi, phi_sum = phi_ops.scatter_rows(s.pi, s.phi_sum, local, ok & mask,
                                       rows, sums)
    return s._replace(pi=pi, phi_sum=phi_sum)


def _write_back(mesh: Mesh, rows_per_shard: int, s: TrainState, nodes,
                mask, rows, sums):
    """The write-back of a data-sharded step: all-gather the staged rows
    of every data shard over the data group (rows, sums, ids and mask in
    one float32 buffer: the ids travel as bit views), then each model
    shard applies the rows in its range. Returns (state, the gathered
    mask, the gathered rows) — the beta stage reads the endpoint rows
    from the gathered staging buffer."""
    k = rows.shape[1]
    packed = torch.cat([rows.float(), sums.float()[:, None],
                        nodes.to(torch.int32).contiguous().view(
                            torch.float32)[:, None],
                        mask.to(torch.float32)[:, None]], dim=1)
    g = _gather_data(mesh, packed)
    g_rows, g_sums = g[:, :k], g[:, k]
    g_nodes = g[:, k + 1].contiguous().view(torch.int32)
    g_mask = g[:, k + 2] > 0.5
    s = _apply_rows(mesh, rows_per_shard, s, g_nodes, g_mask, g_rows, g_sums)
    return s, g_mask, g_rows


# ---------------------------------------------------------------------------
# Step bodies
# ---------------------------------------------------------------------------

def _sharded_step_body(ctx: ShardCtx, s: TrainState, x) -> TrainState:
    """One SGRLD step on the hoisted operands of this rank's data shard
    (per-rank view of the JAX scan body's step): fetch, phi update,
    write-back over the data group, beta gradients summed over the data
    group, the replicated theta step."""
    cfg, mesh, rps = ctx.cfg, ctx.mesh, ctx.rows_per_shard
    batch, nbrs, y_n, n_phi, n_beta, y_e, lane_u, lane_v = x
    b_local = batch.nodes.shape[0]
    with stage("pi_gather"):
        idx = torch.cat([batch.nodes, nbrs.reshape(-1)])
        rows_all, sums_all = _fetch(mesh, rps, idx, s.pi, s.phi_sum)
        pi_n, phis = rows_all[:b_local], sums_all[:b_local]
        pi_nb = rows_all[b_local:].reshape(nbrs.shape[0],
                                           cfg.num_node_sample, cfg.K)
    with stage("phi_update"):
        nbr_mask = (nbrs != batch.nodes[:, None]
                    if cfg.shared_neighbors else None)
        rows, sums = phi_ops.phi_update_core(
            cfg, pi_n, phis, pi_nb, y_n, s.beta, s.step_count, n_phi,
            nbr_mask)
    with stage("pi_scatter"):
        s, g_mask, g_rows = _write_back(mesh, rps, s, batch.nodes,
                                        batch.node_mask, rows, sums)
    with stage("beta_grads"):
        # masked lanes hold non-finite staging garbage: 1/K before the
        # lane gathers, so NaN * 0 never reaches the grads
        rows_safe = torch.where(g_mask[:, None], g_rows, 1.0 / cfg.K)
        grads = beta_ops.beta_gradients_core(
            cfg, s.theta, s.beta, rows_safe[lane_u.long()],
            rows_safe[lane_v.long()], y_e, batch.edge_mask).contiguous()
        dist.all_reduce(grads, group=mesh.data_group)
    beta_count = s.beta_count + 1
    with stage("theta_update"):
        theta, beta = beta_ops.theta_step(cfg, s.theta, grads, batch.weight,
                                          beta_count, n_beta)
    return s._replace(theta=theta, beta=beta, step_count=s.step_count + 1,
                      beta_count=beta_count)


def _sharded_scan_body(ctx: ShardCtx, streams: rng.Streams, state: TrainState,
                       batches: DeviceBatch) -> TrainState:
    """S steps on this rank's data shard of S minibatches ([S, B_local]).

    The state-independent operands of all S steps are drawn in one block
    per stream before the loop (``learner.hoist_operands``): neighbor
    draws (one shared set per step, identical on every rank, or private
    per node from this data shard's stream), membership labels, this
    shard's phi noise, the replicated theta noise; the edge-endpoint lane
    maps point into the all-gathered global node list, whose staged rows
    the write-back gathers."""
    mesh = ctx.mesh
    s_len, b_local = batches.nodes.shape
    xs = hoist_operands(ctx.cfg, ctx.edge_set, batches, streams)
    with stage("edge_lanes"):
        g_nodes = _gather_data(mesh, batches.nodes).reshape(
            mesh.shape[DATA_AXIS], s_len, b_local).transpose(0, 1).reshape(
            s_len, -1)
        lanes = edge_lanes(batches._replace(nodes=g_nodes))
    xs = (*xs[:6], *lanes)
    for i in range(s_len):
        state = _sharded_step_body(ctx, state, index_operands(xs, i))
    return state


def _sharded_global_step_body(ctx: ShardCtx, s: TrainState, x
                              ) -> TrainState:
    """One SGRLD step on hoisted GLOBAL-batch operands — the tail body of
    the windowed path. Every rank computes the whole (tiny) global
    minibatch; only the row fetch is collective and only the local row
    range is written."""
    cfg, mesh, rps = ctx.cfg, ctx.mesh, ctx.rows_per_shard
    batch, nbrs, y_n, n_phi, n_beta, y_e, lane_u, lane_v = x
    nbrs2 = nbrs.reshape(-1, cfg.num_node_sample)             # [1, n]
    b_cap = batch.nodes.shape[0]
    with stage("pi_gather"):
        rows_all, sums_all = _fetch(
            mesh, rps, torch.cat([batch.nodes, nbrs2.reshape(-1)]), s.pi,
            s.phi_sum)
        pi_n, phis = rows_all[:b_cap], sums_all[:b_cap]
        pi_nb = rows_all[b_cap:].reshape(nbrs2.shape[0],
                                         cfg.num_node_sample, cfg.K)
    with stage("phi_update"):
        nbr_mask = nbrs2 != batch.nodes[:, None]       # shared draws only
        rows, sums = phi_ops.phi_update_core(
            cfg, pi_n, phis, pi_nb, y_n, s.beta, s.step_count, n_phi,
            nbr_mask)
    with stage("pi_scatter"):
        s = _apply_rows(mesh, rps, s, batch.nodes, batch.node_mask, rows,
                        sums)
    beta_count = s.beta_count + 1
    with stage("beta_grads"):
        rows_safe = torch.where(batch.node_mask[:, None], rows, 1.0 / cfg.K)
        grads = beta_ops.beta_gradients_core(
            cfg, s.theta, s.beta, rows_safe[lane_u.long()],
            rows_safe[lane_v.long()], y_e, batch.edge_mask)
    with stage("theta_update"):
        theta, beta = beta_ops.theta_step(cfg, s.theta, grads, batch.weight,
                                          beta_count, n_beta)
    return s._replace(theta=theta, beta=beta, step_count=s.step_count + 1,
                      beta_count=beta_count)


def window_slots(read_idx: torch.Tensor, num_ids: int) -> torch.Tensor:
    """[R] int32: a table slot for each read lane, one per distinct row id
    (ids in [0, num_ids)), so two lanes share a slot exactly when they
    share an id. Each lane writes its own index into a map of the ids and
    reads back the one that stayed: which of the lanes of an id wins the
    write does not matter, since they all fetched the same row. Three
    launches, no host wait."""
    lanes = torch.arange(read_idx.shape[0], dtype=torch.int32,
                         device=read_idx.device)
    slot_of = torch.empty(num_ids, dtype=torch.int32, device=read_idx.device)
    slot_of[read_idx.long()] = lanes
    return slot_of[read_idx.long()]


def sharded_window_apply(ctx: ShardCtx, state: TrainState, xs_t, mcode,
                         keep) -> TrainState:
    """One window of the global batch on this rank: ONE row fetch of its
    T*(B+n) read rows over the model group, then the window — ONE launch
    of the window kernel on the fetched rows as its table (a CUDA state,
    ``--window-impl pallas``), or the plain ``window_core_torch`` on them
    — then the local write-back of the kept rows in this shard's range."""
    cfg, mesh, rps = ctx.cfg, ctx.mesh, ctx.rows_per_shard
    batch = xs_t[0]
    t_win, b_cap = batch.nodes.shape
    read = torch.cat([batch.nodes, xs_t[1][:, 0, :]], dim=1)  # [T, B+n]
    with stage("pi_gather"):
        g, sums = _fetch(mesh, rps, read.reshape(-1), state.pi,
                         state.phi_sum)
        # sentinel (masked) lanes read row N, which lies outside every
        # shard when M divides N: a zero row and a zero phi_sum, whose
        # staged rows would be NaN. They never reach pi (the kept rows
        # exclude them; the beta stage selects 1/K), so flooring the
        # fetched sums, as the JAX package does, changes nothing else.
        sums = torch.where(sums > 0.0, sums, 1.0)
    if state.pi.is_cuda and cfg.window_impl != "jnp":
        with stage("window_prep"):
            slots = window_slots(read.reshape(-1), cfg.N + 1).reshape(
                read.shape)
            xs_k = (batch._replace(nodes=slots[:, :b_cap].contiguous()),
                    slots[:, None, b_cap:].contiguous(), *xs_t[2:])
        with stage("window_kernel"):
            out = window_apply_cuda(cfg, state._replace(pi=g, phi_sum=sums),
                                    xs_k, mcode, keep,
                                    table_rows=g.shape[0])
        node_slot = slots[:, :b_cap].reshape(-1).long()
        rows_flat, sums_flat = g[node_slot], sums[node_slot]
    else:
        with stage("window_kernel"):
            rows_flat, sums_flat, theta, beta = window_core_torch(
                cfg, state, xs_t, g.reshape(t_win, -1, cfg.K),
                sums.reshape(t_win, -1)[:, :b_cap], mcode)
        out = _advance(state, t_win, theta=theta, beta=beta)
    with stage("pi_scatter"):
        s = _apply_rows(mesh, rps, state, batch.nodes.reshape(-1),
                        keep.reshape(-1), rows_flat, sums_flat)
    return out._replace(pi=s.pi, phi_sum=s.phi_sum)


def _sharded_windowed_scan(ctx: ShardCtx, streams: rng.Streams, phi_streams,
                           state: TrainState, batches: DeviceBatch
                           ) -> TrainState:
    """T-step windowed sharded loop on the global batch: per window ONE
    collective row fetch and ONE window-kernel launch
    (``sharded_window_apply``) instead of three collectives per step; the
    steps after the last whole window run ``_sharded_global_step_body``.
    Per-lane semantics (noise streams, shared draws, membership, eps_t)
    are the data-sharded unwindowed body's, so the trajectory matches it
    up to float reduction order. The phi noise of global lane
    d*B_local+j comes from data shard d's stream: the draw rank d makes
    for its lane j in the unwindowed path."""
    xs = hoist_operands(ctx.cfg, ctx.edge_set, batches,
                        streams._replace(phi=phi_streams))
    for xs_t, mcode, keep in iter_windows(ctx.cfg, xs, xs[1][:, 0, :]):
        state = sharded_window_apply(ctx, state, xs_t, mcode, keep)
    s_len, t_win = xs[1].shape[0], ctx.cfg.window
    for i in range(s_len - s_len % t_win, s_len):
        state = _sharded_global_step_body(ctx, state, index_operands(xs, i))
    return state


def shard_batches(mesh: Mesh, batches: DeviceBatch) -> DeviceBatch:
    """This rank's data shard of S global minibatches: the d-th B/D node
    lanes and E/D edge lanes of every step (the weights are per step)."""
    d, n_data = mesh.d_idx, mesh.shape[DATA_AXIS]

    def part(x):
        per = x.shape[1] // n_data
        return x[:, d * per:(d + 1) * per].contiguous()

    return DeviceBatch(edges_u=part(batches.edges_u),
                       edges_v=part(batches.edges_v),
                       edge_mask=part(batches.edge_mask),
                       nodes=part(batches.nodes),
                       node_mask=part(batches.node_mask),
                       weight=batches.weight)


def _sharded_fused_scan(ctx: ShardCtx, streams: rng.Streams, phi_streams,
                        heldout_set, adjacency, state: TrainState,
                        num_steps: int) -> TrainState:
    """Fully fused sharded chunk: every rank draws the identical global
    batch from identically seeded sampler streams (cheaper than a
    broadcast), then runs its data shard through the scan body, or with
    ``cfg.window > 1`` the windowed path on the whole global batch."""
    cfg = ctx.cfg
    with stage("device_sampling"):
        ds = sample_minibatches_device(cfg, ctx.edge_set, heldout_set,
                                       streams.sample, num_steps, adjacency)
    batches = DeviceBatch(*ds)
    if cfg.window > 1 and cfg.shared_neighbors:
        return _sharded_windowed_scan(ctx, streams, phi_streams, state,
                                      batches)
    return _sharded_scan_body(ctx, streams, state,
                              shard_batches(ctx.mesh, batches))


def _sharded_ppx_body(ctx: ShardCtx, train: bool, label_set, eu, ev, mask,
                      state: TrainState):
    """Perplexity over this rank's slice of the population: partial
    likelihood sums and counts, reduced over the data group. ``train``:
    the training-perplexity population and its running averages, labels
    from the training set; else the held-out ones."""
    cfg, mesh, rps = ctx.cfg, ctx.mesh, ctx.rows_per_shard
    per_edge = state.train_ppx_per_edge if train else state.ppx_per_edge
    count = (state.train_ppx_count if train else state.ppx_count) + 1
    h = eu.shape[0]
    rows = _fetch_rows(mesh, rps, state.pi, torch.cat([eu, ev]))
    y = label_set.has_edges(eu, ev) & mask
    res = ppx_ops.perplexity_core(cfg, rows[:h], rows[h:], y, mask,
                                  state.beta, per_edge, count)
    liks = torch.stack([res.link_likelihood, res.non_link_likelihood])
    counts = torch.stack([res.link_count, res.non_link_count]).to(
        torch.int64)
    dist.all_reduce(liks, group=mesh.data_group)
    dist.all_reduce(counts, group=mesh.data_group)
    neg_avg = -(liks[0] + liks[1]) / (counts[0] + counts[1]).to(liks.dtype)
    if train:
        state = state._replace(train_ppx_per_edge=res.ppx_per_edge,
                               train_ppx_count=count)
    else:
        state = state._replace(ppx_per_edge=res.ppx_per_edge,
                               ppx_count=count)
    return state, ppx_ops.PpxResult(res.ppx_per_edge, neg_avg, liks[0],
                                    liks[1], counts[0], counts[1])


# ---------------------------------------------------------------------------
# Orchestration
# ---------------------------------------------------------------------------

def check_sharded_config(cfg: Config) -> None:
    """The JAX ShardedLearner's guards (sharded.py:592-620)."""
    if cfg.shared_neighbors and cfg.phi_impl != PhiImpl.JNP:
        raise ValueError("shared_neighbors requires phi_impl=jnp")
    if cfg.pi_dtype != "float32" and cfg.phi_impl != PhiImpl.JNP:
        raise ValueError("pi_dtype=bfloat16 requires phi_impl=jnp")
    if cfg.rng_backend != RngBackend.NATIVE:
        raise ValueError(
            "ShardedLearner requires rng_backend=native: the reference "
            "RNG's per-thread streams are single-device semantics (one "
            "xorshift128+ state per minibatch lane) and have no meaningful "
            "partitioning across a data-sharded batch")
    if cfg.window > 1:
        if not (cfg.shared_neighbors and cfg.device_sampling):
            raise ValueError(
                "window > 1 on ShardedLearner requires shared_neighbors "
                "and device_sampling (the windowed sharded path fuses the "
                "device-sampled global batch; the host-sampled path "
                "pre-shards batches over the data axis)")
        if cfg.window_impl not in ("pallas", "jnp"):
            raise ValueError(f"unknown window_impl {cfg.window_impl!r} "
                             "(pallas | jnp)")


def _padded_population(u: np.ndarray, v: np.ndarray, n_data: int,
                       d: int, device):
    """A population padded to a multiple of the data axis and this data
    shard's slice of it: (u, v, mask) tensors on ``device``."""
    n = len(u)
    n_pad = _round_up(max(n, 1), n_data)
    pu = np.zeros(n_pad, np.int32)
    pu[:n] = u
    pv = np.zeros(n_pad, np.int32)
    pv[:n] = v
    mask = np.arange(n_pad) < n
    per = n_pad // n_data
    sl = slice(d * per, (d + 1) * per)
    return (torch.from_numpy(pu[sl].copy()).to(device),
            torch.from_numpy(pv[sl].copy()).to(device),
            torch.from_numpy(mask[sl].copy()).to(device))


def init_local_state(cfg: Config, lo: int, hi: int, n_padded: int,
                     heldout_size: int, train_ppx_size: int,
                     device) -> TrainState:
    """The rows [lo, hi) of ``learner.init_state``'s state (native RNG):
    theta from the host stream, then the pi blocks that overlap the rows
    drawn and normalized on ``device`` as the single-GPU init does
    (``learner.gamma_rows``), then cast to pi's storage dtype, so the
    shard holds exactly the single-GPU rows; rows past N (padding to the
    model axis) are 1/K with phi_sum 1."""
    k = cfg.K
    theta = gamma_draws(cfg, rng.host_gamma_rng(cfg), (k, 2), device)
    pi = torch.full((hi - lo, k), 1.0 / k, dtype=pi_storage_dtype(cfg),
                    device=device)
    phi_sum = torch.ones(hi - lo, device=device)
    real = min(cfg.N, hi) - lo
    if real > 0:
        gamma_rows(cfg, device, out=(pi[:real], phi_sum[:real]),
                   rows=(lo, lo + real))
    if cfg.theta_init == "libstdc++":
        theta = torch.from_numpy(native.ref_theta_init(
            cfg.eta0, cfg.eta1, cfg.init_seed, 2 * k).reshape(k, 2)).to(
            device=device, dtype=torch.float32)
    return TrainState(
        pi=pi, phi_sum=phi_sum, theta=theta,
        beta=theta[:, 1] / (theta[:, 0] + theta[:, 1]),
        step_count=1, beta_count=0,
        ppx_per_edge=torch.zeros(heldout_size, device=device),
        ppx_count=0,
        train_ppx_per_edge=torch.zeros(train_ppx_size, device=device),
        train_ppx_count=0)


class ShardedLearner(Learner):
    """Multi-GPU learner with ``Learner``'s surface (``run``,
    ``run_with_ppx``, ``heldout_perplexity``, ``training_perplexity``,
    ``print_stats``, the stage profile), one per rank of ``mesh``; every
    rank of the mesh makes the same calls in the same order (they are
    collectives).

    Capacities are padded to the data axis and pi's rows to the model
    axis (padding rows 1/K). ``state`` holds this rank's shard: pi
    [N_pad/M, K], phi_sum, the replicated theta/beta, and its slice of
    the held-out (and training-perplexity) running averages. Host-sampled
    (``cfg.device_sampling`` off), every rank's sampler is seeded alike,
    so each draws the same global batch and keeps its data shard; with
    ``steps_per_call`` 1 a step is a one-step chunk of the scan body (the
    JAX step body re-fetches the edge endpoints' rows from the new pi;
    the scan body reads the same values from the staged rows).
    ``cfg.phi_impl`` is not read: the sharded bodies run the plain phi
    update, as the JAX package's do."""

    def __init__(self, cfg: Config, graph: Optional[Graph],
                 split: Optional[DataSplit], mesh: Mesh,
                 prefetch: bool = True, partitioned=None):
        if not mesh.member:
            raise ValueError(f"rank {mesh.rank} is outside the "
                             f"{mesh.shape[DATA_AXIS]}x"
                             f"{mesh.shape[MODEL_AXIS]} mesh")
        self.mesh = mesh
        n_data, n_model = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
        self.n_data, self.n_model = n_data, n_model
        self.partitioned = partitioned
        if partitioned is not None:
            if graph is not None or split is not None:
                raise ValueError("pass either (graph, split) or "
                                 "partitioned=, not both")
            if not cfg.device_sampling:
                raise ValueError(
                    "partitioned mode requires device_sampling: host "
                    "minibatch sampling needs the full host graph, which "
                    "no process holds")
        check_sharded_config(cfg)
        self.device = mesh.device
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        cfg = cfg.replace(
            batch_edges_cap=_round_up(cfg.max_batch_edges, n_data),
            batch_nodes_cap=_round_up(cfg.max_batch_nodes, n_data))
        self.cfg = cfg
        self.graph, self.split = graph, split
        self.n_padded = _round_up(cfg.N, n_model)
        self.rows_per_shard = self.n_padded // n_model
        lo = mesh.m_idx * self.rows_per_shard
        dev = self.device

        if partitioned is not None:
            self.training_set = build_sharded_csr(
                mesh, cfg.N, self.rows_per_shard, partitioned.shards,
                partitioned.cols_cap)
            ho_u, ho_v = partitioned.heldout_u, partitioned.heldout_v
            ev_u = partitioned.heldout_edges_u
            ev_v = partitioned.heldout_edges_v
        else:
            self.training_set = build_edge_set(
                cfg.edgeset_backend, cfg.N, graph.edges_u, graph.edges_v,
                dev)
            ho_u, ho_v = split.heldout_u, split.heldout_v
            ev_u, ev_v = split.heldout_edges_u, split.heldout_edges_v
        self.heldout_set = build_edge_set(cfg.edgeset_backend, cfg.N, ho_u,
                                          ho_v, dev)
        if len(ev_u) == 0:
            raise ValueError("no held-out edges: heldout_ratio too small "
                             "for this graph")
        self.heldout_u, self.heldout_v, self.heldout_mask = (
            _padded_population(ev_u, ev_v, n_data, mesh.d_idx, dev))
        self.train_ppx_u = self.train_ppx_v = self.train_ppx_mask = None
        if cfg.calc_train_ppx:
            if partitioned is not None:
                tu, tv = make_training_ppx_edges_partitioned(
                    partitioned, cfg.training_ppx_ratio)
            else:
                tu, tv = make_training_ppx_edges(split,
                                                 cfg.training_ppx_ratio)
            self.train_ppx_u, self.train_ppx_v, self.train_ppx_mask = (
                _padded_population(tu, tv, n_data, mesh.d_idx, dev))

        self.ctx = ShardCtx(cfg, mesh, self.rows_per_shard, self.training_set)
        self.phi_streams = [rng.generator(fold_seed(cfg.phi_seed, d), dev)
                            for d in range(n_data)]
        self.streams = rng.Streams(
            phi=self.phi_streams[mesh.d_idx],
            beta=rng.generator(cfg.beta_seed, dev),
            neighbor=rng.generator(
                cfg.neighbor_seed if cfg.shared_neighbors
                else fold_seed(cfg.neighbor_seed, mesh.d_idx), dev),
            sample=rng.generator((cfg.sample_seed, 0x5A), dev))
        self.state = init_local_state(
            cfg, lo, lo + self.rows_per_shard, self.n_padded,
            self.heldout_u.shape[0],
            0 if self.train_ppx_u is None else self.train_ppx_u.shape[0],
            dev)
        if partitioned is not None:
            # no host sampler exists (device sampling is mandatory); the
            # sampler adjacency IS the sharded CSR
            self._init_pipeline(None, prefetch=False)
            self.adjacency = self.training_set
        else:
            self._init_pipeline(
                None if cfg.device_sampling
                else MiniBatchSampler(cfg, graph, split), prefetch)
            self.adjacency = Adjacency(
                torch.as_tensor(graph.offsets, device=dev),
                torch.as_tensor(graph.cols, dtype=torch.int32, device=dev))
        self.timers = StageTimers()
        self.last_ppx_stats = {}

    @classmethod
    def from_partitioned(cls, cfg: Config, pdata, mesh: Mesh
                         ) -> "ShardedLearner":
        """Multi-process capacity construction from this process's
        ``partitioned.PartitionedData``: the model-row-sharded training
        CSR for membership AND sampling, replicated small held-out
        structures, no host Graph anywhere. The trajectory is the
        replicated-graph engine's on the same dataset, bit for bit."""
        return cls(cfg, None, None, mesh, partitioned=pdata)

    # -- the model (Learner's hooks) ----------------------------------------

    def _train_chunk(self, state, num_steps: int):
        return _sharded_fused_scan(self.ctx, self.streams, self.phi_streams,
                                   self.heldout_set, self.adjacency, state,
                                   num_steps)

    def _scan_chunk(self, state, batches: DeviceBatch):
        return _sharded_scan_body(self.ctx, self.streams, state,
                                  shard_batches(self.mesh, batches))

    def _run_single(self, max_iters: int) -> None:
        self._run_scanned(max_iters, 1)

    def _evaluate(self, state):
        return _sharded_ppx_body(self.ctx, False, self.heldout_set,
                                 self.heldout_u, self.heldout_v,
                                 self.heldout_mask, state)

    def _evaluate_train(self, state):
        if self.train_ppx_u is None:
            return state, None
        state, res = _sharded_ppx_body(self.ctx, True, self.training_set,
                                       self.train_ppx_u, self.train_ppx_v,
                                       self.train_ppx_mask, state)
        return state, res.neg_avg_log

    def print_stage_profile(self, log=print, iters=None) -> None:
        """The traced per-stage table of this rank's share of the sharded
        loop (the pi_gather and pi_scatter stages include their
        collectives); no unfused fallback. Every rank must call it (it
        trains); the CLI prints rank 0's."""
        from mcmc_ammsb_tpu_torch.utils import profiling

        prof = self.fused_stage_profile(iters)
        if prof["source"] == "none" or prof["total_op_seconds"] <= 0:
            log("trace captured no attributable device ops")
            return
        profiling.format_stage_table(prof, prof["steps"], log)

    # -- checkpoints ---------------------------------------------------------

    def shard_layout(self) -> dict:
        """The state fields split across ranks, as (group, this rank's
        index in it): the global field is the concatenation on dim 0 of
        the group's local tensors in index order (``checkpoint.py`` writes
        and reads the global field)."""
        m = self.mesh
        return {"pi": (m.model_group, m.m_idx),
                "phi_sum": (m.model_group, m.m_idx),
                "ppx_per_edge": (m.data_group, m.d_idx),
                "train_ppx_per_edge": (m.data_group, m.d_idx)}

    def dtensor_layout(self) -> dict:
        """The split fields as DTensors for the directory checkpoint:
        {field: (the mesh's DeviceMesh, placements)}: pi's rows and
        phi_sum sharded over 'model' and replicated over 'data', the
        running averages the other way round."""
        from torch.distributed.tensor import Replicate, Shard

        mesh = self.mesh.device_mesh
        rows = (mesh, [Replicate(), Shard(0)])
        edges = (mesh, [Shard(0), Replicate()])
        return {"pi": rows, "phi_sum": rows, "ppx_per_edge": edges,
                "train_ppx_per_edge": edges}

    def stream_generators(self) -> dict:
        """This rank's generators by name: the four ``rng.Streams`` and
        the data shards' phi streams."""
        gens = dict(zip(self.streams._fields, self.streams))
        gens.update({f"phi{d}": g for d, g in enumerate(self.phi_streams)})
        return gens
