"""Rank functions of the multi-rank tests (test_torch_parallel_mesh.py,
test_torch_sharded.py, test_torch_chains_sharded.py,
test_torch_partitioned.py). ``parallel.dryrun.spawn`` runs each on n gloo
ranks, each in its own process, and returns what every rank returned.
This module imports torch, numpy and the port, never JAX: the ranks are
the port's processes; the tests hold their results against the JAX
package in the parent."""

from __future__ import annotations

import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from mcmc_ammsb_tpu_torch import testing
from mcmc_ammsb_tpu_torch.config import Config
from mcmc_ammsb_tpu_torch.data import Graph, generate_sets, synthetic_edges
from mcmc_ammsb_tpu_torch.learner import TrainState
from mcmc_ammsb_tpu_torch.ops import window
from mcmc_ammsb_tpu_torch.parallel import partitioned as part
from mcmc_ammsb_tpu_torch.parallel import sharded
from mcmc_ammsb_tpu_torch.parallel.dryrun import gather_rows
from mcmc_ammsb_tpu_torch.parallel.mesh import make_mesh


# ---------------------------------------------------------------------------
# Seeded problems (the tests build the same ones for the JAX side)
# ---------------------------------------------------------------------------

def collective_case(seed: int, n_data: int, n_model: int):
    """Arrays of the fetch / write-back check: pi [N_pad, K] and phi_sum
    of N = 37 rows padded to the model axis, row ids to fetch (the
    sentinel N among them) and staged rows to write back, B per data
    shard with a mask."""
    r = np.random.default_rng(seed)
    n, k, lanes, b = 37, 5, 12, 6
    n_pad = -(-n // n_model) * n_model
    pi = r.random((n_pad, k)).astype(np.float32)
    phi = (1.0 + r.random(n_pad)).astype(np.float32)
    idx = r.integers(0, n + 1, n_data * lanes).astype(np.int32)
    idx[::lanes] = n                     # the sentinel, in every shard
    # globally deduplicated, as the minibatch node list is
    nodes = r.permutation(n)[: n_data * b].astype(np.int32)
    mask = r.random(n_data * b) < 0.7
    rows = r.random((n_data * b, k)).astype(np.float32)
    sums = (1.0 + r.random(n_data * b)).astype(np.float32)
    return dict(n=n, k=k, n_pad=n_pad, pi=pi, phi=phi, idx=idx, nodes=nodes,
                mask=mask, rows=rows, sums=sums)


def graph_case(seed: int, num_nodes: int = 120, k: int = 8, **cfg_kw):
    """(cfg, graph, split) of a small random graph."""
    n, u, v = synthetic_edges(num_nodes, 8, seed=seed)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=seed + 1)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    base = dict(K=k, mini_batch_size=8, num_node_sample=8)
    base.update(cfg_kw)
    cfg = Config(**base).finalize(n, split.total_edges, graph.max_fan_out)
    return cfg, graph, split


def query_case(seed: int, num_nodes: int, n_data: int, lanes: int = 40):
    """Membership / degree / row-gather queries, ``lanes`` per data
    shard, half of them true edges."""
    r = np.random.default_rng(seed)
    u = r.integers(0, num_nodes, n_data * lanes).astype(np.int32)
    v = r.integers(0, num_nodes, n_data * lanes).astype(np.int32)
    off = r.integers(0, 6, (n_data * lanes, 4)).astype(np.int32)
    return u, v, off


def _slice(x, d, n_data):
    per = len(x) // n_data
    return x[d * per:(d + 1) * per]


# ---------------------------------------------------------------------------
# Rank functions
# ---------------------------------------------------------------------------

def collectives(seed: int, n_data: int, n_model: int) -> dict:
    """``_fetch_rows``, ``_fetch_scalars`` and the write-back on this
    rank's shards of ``collective_case``."""
    c = collective_case(seed, n_data, n_model)
    mesh = make_mesh(n_data, n_model, device="cpu")
    d, m = mesh.d_idx, mesh.m_idx
    rps = c["n_pad"] // n_model
    lo = m * rps
    pi = torch.tensor(c["pi"][lo:lo + rps])
    phi = torch.tensor(c["phi"][lo:lo + rps])
    idx = torch.tensor(_slice(c["idx"], d, n_data))
    rows = sharded._fetch_rows(mesh, rps, pi, idx)
    sums = sharded._fetch_scalars(mesh, rps, phi, idx)
    state = TrainState(pi=pi.clone(), phi_sum=phi.clone(), theta=None,
                       beta=None, step_count=1, beta_count=0,
                       ppx_per_edge=None, ppx_count=0)
    state, _, _ = sharded._write_back(
        mesh, rps, state, torch.tensor(_slice(c["nodes"], d, n_data)),
        torch.tensor(_slice(c["mask"], d, n_data)),
        torch.tensor(_slice(c["rows"], d, n_data)),
        torch.tensor(_slice(c["sums"], d, n_data)))
    return dict(d=d, m=m, rows=rows.numpy(), sums=sums.numpy(),
                pi=state.pi.numpy(), phi=state.phi_sum.numpy())


def csr_queries(seed: int, n_data: int, n_model: int) -> dict:
    """``ShardedCSR`` answers on this rank's data slice of
    ``query_case`` over the training graph of ``graph_case``."""
    cfg, graph, _ = graph_case(seed)
    mesh = make_mesh(n_data, n_model, device="cpu")
    rps = -(-cfg.N // n_model)
    shards = {m: part._csr_slice(graph.edges_u, graph.edges_v,
                                 min(m * rps, cfg.N),
                                 min((m + 1) * rps, cfg.N))
              for m in range(n_model)}
    cap = max(len(s.cols) for s in shards.values())
    csr = part.build_sharded_csr(mesh, cfg.N, rps, shards, cap)
    u, v, off = query_case(seed, cfg.N, n_data)
    d = mesh.d_idx
    tu = torch.tensor(_slice(u, d, n_data))
    tv = torch.tensor(_slice(v, d, n_data))
    return dict(d=d, has=csr.has_edges(tu, tv).numpy(),
                has2=csr.has_edges(tu[:, None], tv[None, :8]).numpy(),
                deg=csr.degree(tu).numpy(),
                rows=csr.row_gather(tu, torch.tensor(
                    _slice(off, d, n_data))).numpy())


def window_case_local(case: dict, mesh, rps: int):
    """The window case's state as this rank's model shard, and its
    operands."""
    state, xs = testing.window_case_torch(case, "cpu")
    n, k = case["n_nodes"], state.pi.shape[1]
    n_pad = rps * mesh.shape["model"]
    pi = torch.full((n_pad, k), 1.0 / k)
    pi[:n] = state.pi
    phi = torch.ones(n_pad)
    phi[:n] = state.phi_sum
    lo = mesh.m_idx * rps
    return state._replace(pi=pi[lo:lo + rps].clone(),
                          phi_sum=phi[lo:lo + rps].clone()), xs


def sharded_window(seed: int, shape, n_data: int, n_model: int) -> dict:
    """One window of ``testing.window_case`` through
    ``sharded.sharded_window_apply`` (the plain window on the CPU): the
    global pi and phi_sum after it, theta and beta."""
    case = testing.window_case(seed, *shape)
    cfg = testing.window_case_config(case)
    mesh = make_mesh(n_data, n_model, device="cpu")
    rps = -(-case["n_nodes"] // n_model)
    state, xs = window_case_local(case, mesh, rps)
    nodes, mask, nbrs = xs[0].nodes, xs[0].node_mask, xs[1][:, 0, :]
    mcode = window._correction_codes(cfg, nodes, mask, nbrs)
    keep = window._last_write_wins(nodes, mask, cfg.window)
    ctx = sharded.ShardCtx(cfg, mesh, rps, None)
    out = sharded.sharded_window_apply(ctx, state, xs, mcode, keep)
    group = mesh.model_group

    def full(x):
        o = x.new_empty((n_model * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(o, x.contiguous(), group=group)
        return o.numpy()[: case["n_nodes"]]

    return dict(pi=full(out.pi), phi=full(out.phi_sum),
                theta=out.theta.numpy(), beta=out.beta.numpy(),
                step_count=out.step_count)


def ppx_of_state(arrays: dict, seed: int, n_data: int, n_model: int,
                 k: int) -> float:
    """The sharded held-out perplexity of a state given as global arrays
    (pi [N, K], beta), twice (the running average)."""
    cfg, graph, split = graph_case(seed, k=k)
    mesh = make_mesh(n_data, n_model, device="cpu")
    lrn = sharded.ShardedLearner(cfg, graph, split, mesh, prefetch=False)
    lo = mesh.m_idx * lrn.rows_per_shard
    pi = np.full((lrn.n_padded, cfg.K), 1.0 / cfg.K, np.float32)
    pi[:cfg.N] = arrays["pi"]
    lrn.state = lrn.state._replace(
        pi=torch.tensor(pi[lo:lo + lrn.rows_per_shard]),
        beta=torch.tensor(arrays["beta"]))
    return [lrn.heldout_perplexity(), lrn.heldout_perplexity()]


def _global(lrn) -> dict:
    n = lrn.cfg.N
    return dict(pi=gather_rows(lrn)[:n], phi=gather_rows(lrn, "phi_sum")[:n],
                theta=lrn.state.theta.numpy().copy(),
                beta=lrn.state.beta.numpy().copy(), step=lrn.step_count)


def trajectories(seed: int, n_data: int, n_model: int, ck_dir: str) -> dict:
    """The sharded engine's own invariants on one mesh: windowed ==
    unwindowed (their globals), the fused ppx series == the host loop,
    theta after a chunk on this rank, resume bit-exact (run, save, run ==
    restore, run), host-sampled chunks train."""
    from mcmc_ammsb_tpu_torch.checkpoint import (load_checkpoint,
                                                 save_checkpoint)

    cfg, graph, split = graph_case(seed, device_sampling=True,
                                   shared_neighbors=True, steps_per_call=24)
    mesh = make_mesh(n_data, n_model, device="cpu")

    def make(**kw):
        return sharded.ShardedLearner(cfg.replace(**kw), graph, split, mesh,
                                      prefetch=False)

    out = {}
    seq, win = make(), make(window=4, window_impl="jnp")
    for lrn in (seq, win):      # the same chunks: 23 steps, then one
        lrn.run(23)             # 5 windows + 3 tail steps
        lrn.run(1)
    out["seq"], out["win"] = _global(seq), _global(win)
    out["ppx_seq"] = seq.heldout_perplexity()
    out["ppx_win"] = win.heldout_perplexity()

    a, b = make(steps_per_call=40), make(steps_per_call=40)
    series = a.run_with_ppx(40, 10)
    loop = []
    for _ in series:
        b.run(10)
        loop.append((b.heldout_perplexity(), b.last_ppx_stats))
    out["series"] = [(ev["step"], ev["ppx"], ev["link_count"],
                      ev["non_link_likelihood"]) for ev in series]
    out["loop"] = [(p, st["link_count"], st["non_link_likelihood"])
                   for p, st in loop]
    out["series_pi_equal"] = bool(np.array_equal(gather_rows(a),
                                                 gather_rows(b)))
    out["theta_rank"] = a.state.theta.numpy().copy()

    path = os.path.join(ck_dir, "sharded.npz")
    c1 = make(window=4)
    c1.run(24)
    save_checkpoint(path, c1)
    c1.run(24)
    c2 = make(window=4)
    load_checkpoint(path, c2)
    c2.run(24)
    out["resume"] = (_global(c1), _global(c2))
    out["resume_ppx"] = (c1.heldout_perplexity(), c2.heldout_perplexity())

    host = sharded.ShardedLearner(
        cfg.replace(device_sampling=False, shared_neighbors=False,
                    steps_per_call=5, host_sampler="numpy"),
        graph, split, mesh)
    p0 = host.heldout_perplexity()
    host.run(40)
    out["host_ppx"] = (p0, host.heldout_perplexity())
    path = os.path.join(ck_dir, "host.npz")
    save_checkpoint(path, host)
    host.run(10)
    h2 = sharded.ShardedLearner(host.cfg, graph, split, mesh)
    load_checkpoint(path, h2)
    h2.run(10)
    out["host_resume_equal"] = bool(np.array_equal(gather_rows(host),
                                                   gather_rows(h2)))
    host.close()
    h2.close()
    return out


def model_invisible(seed: int, n_model: int, window: int) -> dict:
    """(1, n_model) and (1, 1) (rank 0 alone, a subset mesh) on the same
    device-sampled run: their globals."""
    cfg, graph, split = graph_case(seed, device_sampling=True,
                                   shared_neighbors=True, steps_per_call=30,
                                   window=window)
    wide = sharded.ShardedLearner(cfg, graph, split,
                                  make_mesh(1, n_model, device="cpu"))
    wide.run(30)
    out = {"wide": _global(wide), "wide_ppx": wide.heldout_perplexity()}
    base_mesh = make_mesh(1, 1, allow_subset=True, device="cpu")
    if base_mesh.member:
        base = sharded.ShardedLearner(cfg, graph, split, base_mesh)
        base.run(30)
        out["base"] = _global(base)
        out["base_ppx"] = base.heldout_perplexity()
    dist.barrier()
    return out


def mesh_layout(n_data: int, n_model: int) -> dict:
    """This rank's coordinates and its groups' ranks."""
    mesh = make_mesh(n_data, n_model, device="cpu")
    return dict(rank=mesh.rank, d=mesh.d_idx, m=mesh.m_idx,
                data=dist.get_process_group_ranks(mesh.data_group),
                model=dist.get_process_group_ranks(mesh.model_group),
                default=make_mesh(device="cpu").shape)


def mesh_errors() -> list:
    """The messages of the meshes a 2-rank world refuses, and the
    membership of a subset mesh."""
    msgs = []
    for shape in ((1, 1), (2, 2)):
        try:
            make_mesh(*shape, device="cpu")
        except ValueError as e:
            msgs.append(str(e))
    sub = make_mesh(1, 1, allow_subset=True, device="cpu")
    return msgs + [sub.member]


def vocab(path: str) -> np.ndarray:
    """``multihost.global_vocab`` over this rank's byte range of a SNAP
    file."""
    from mcmc_ammsb_tpu_torch.parallel import multihost

    rank, world = dist.get_rank(), dist.get_world_size()
    start, end = multihost.byte_ranges(path, world)[rank]
    u, v = multihost.load_snap_edges_range(path, start, end)
    return multihost.global_vocab(np.concatenate([u, v]))


def coordinator_start(port: int) -> tuple:
    """``multihost.initialize`` through the JAX CLI's flags (a TCP
    rendezvous at 127.0.0.1:port): rank, world size, backend, and an
    all-reduced sum."""
    from mcmc_ammsb_tpu_torch.parallel import multihost

    rank = int(os.environ["RANK"])
    started = multihost.initialize(f"127.0.0.1:{port}", 2, rank, "cpu")
    t = torch.tensor([rank + 1])
    dist.all_reduce(t)
    out = (started, dist.get_rank(), dist.get_world_size(),
           dist.get_backend(), int(t))
    dist.destroy_process_group()
    return out


def run_cli(argv) -> tuple:
    """``cli.main(argv)`` on this rank: (rc, the messages it logged)."""
    from mcmc_ammsb_tpu_torch import cli

    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger("mcmc_ammsb_tpu_torch")
    logger.addHandler(Keep())
    rc = cli.main(list(argv))
    return rc, records


def cli_learner(argv, device="cpu"):
    """The learner ``cli.main(argv)`` trains, built as the CLI builds it
    (in a rank of a group for the multi-rank flags), on ``device``."""
    from mcmc_ammsb_tpu_torch import cli

    args = cli.build_arg_parser().parse_args(list(argv) + ["--device",
                                                           device])
    cli.resolve_fast_defaults(args)
    cfg = cli.config_from_args(args)
    if args.num_chains > 1:
        cfg = cfg.replace(device_sampling=True)
    nn, deg = (int(x) for x in args.synthetic.split(","))
    n, u, v = synthetic_edges(nn, deg, seed=1)
    split = generate_sets(n, u, v, args.heldout_ratio)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = cli.resolve_kernel_window(
        args, cfg.finalize(n, split.total_edges, graph.max_fan_out),
        torch.device(device))
    return cli.make_learner(args, cfg, graph, split, device)


def restore_and_save(argv, path: str, out: str) -> int:
    """This rank's share of ``load_checkpoint(path)`` into the CLI's
    learner for ``argv``, saved again to ``out`` (rank 0 writes the
    global state): the restored step."""
    from mcmc_ammsb_tpu_torch.checkpoint import (load_checkpoint,
                                                 save_checkpoint)

    lrn = cli_learner(argv)
    load_checkpoint(path, lrn)
    save_checkpoint(out, lrn)
    lrn.close()
    return lrn.step_count


def theta_bits(seed: int, n_data: int, n_model: int) -> bytes:
    """theta after a device-sampled chunk, as bytes (bit-equality across
    ranks)."""
    cfg, graph, split = graph_case(seed, device_sampling=True,
                                   shared_neighbors=True, steps_per_call=20)
    lrn = sharded.ShardedLearner(cfg, graph, split,
                                 make_mesh(n_data, n_model, device="cpu"))
    lrn.run(20)
    return lrn.state.theta.numpy().tobytes()


def bf16_runs(seed: int, n_data: int, n_model: int, ck_dir: str) -> dict:
    """bfloat16 pi on the mesh: the unwindowed and the windowed run
    (their globals, pi's dtype, the held-out ppx), and run, save, run ==
    restore, run in both checkpoint backends."""
    from mcmc_ammsb_tpu_torch.checkpoint import (load_checkpoint,
                                                 save_checkpoint)

    cfg, graph, split = graph_case(seed, device_sampling=True,
                                   shared_neighbors=True, steps_per_call=24,
                                   pi_dtype="bfloat16")
    mesh = make_mesh(n_data, n_model, device="cpu")

    def make(window):
        return sharded.ShardedLearner(cfg.replace(window=window), graph,
                                      split, mesh)

    out = {}
    for w in (0, 4):
        lrn = make(w)
        p0 = lrn.heldout_perplexity()
        lrn.run(24)
        lrn.run(24)
        out[f"w{w}"] = dict(_global(lrn), dtype=str(lrn.state.pi.dtype),
                            ppx=(p0, lrn.heldout_perplexity()))
    for backend in ("npz", "orbax"):
        path = os.path.join(ck_dir, f"bf16_{backend}")
        c1 = make(4)
        c1.run(24)
        save_checkpoint(path, c1, backend=backend)
        c1.run(24)
        c2 = make(4)
        load_checkpoint(path, c2)
        c2.run(24)
        out[f"resume_{backend}"] = (_global(c1), _global(c2),
                                    str(c2.state.pi.dtype))
    return out


def dir_checkpoints(seed: int, n_data: int, n_model: int,
                    ck_dir: str) -> dict:
    """The directory backend on the mesh, each rank writing and reading
    its own rows: run, save, run == restore, run (synchronous, then
    asynchronous with training going on before the finalize), and the
    chain engine on a chain mesh of every rank."""
    from mcmc_ammsb_tpu_torch.checkpoint import (load_checkpoint,
                                                 save_checkpoint,
                                                 wait_for_async_saves)
    from mcmc_ammsb_tpu_torch.parallel.chains_sharded import (
        ShardedChainLearner, make_chain_mesh)

    cfg, graph, split = graph_case(seed, device_sampling=True,
                                   shared_neighbors=True, steps_per_call=24,
                                   window=4)
    mesh = make_mesh(n_data, n_model, device="cpu")
    out = {}
    for mode in ("sync", "async"):
        path = os.path.join(ck_dir, f"dir_{mode}")
        c1 = sharded.ShardedLearner(cfg, graph, split, mesh)
        c1.run(24)
        save_checkpoint(path, c1, backend="orbax", async_save=mode == "async")
        c1.run(24)                 # the in-place updates of a live save
        wait_for_async_saves()
        c2 = sharded.ShardedLearner(cfg, graph, split, mesh)
        load_checkpoint(path, c2)
        restored_step = c2.step_count
        c2.run(24)
        out[mode] = (_global(c1), _global(c2), restored_step,
                     sorted(os.listdir(path)))
    cmesh = make_chain_mesh(dist.get_world_size(), device="cpu")
    path = os.path.join(ck_dir, "dir_chains")
    ch = ShardedChainLearner(cfg.replace(steps_per_call=10), graph, split,
                             4, cmesh)
    ch.run(20)
    save_checkpoint(path, ch, backend="orbax")
    ch.run(20)
    again = ShardedChainLearner(ch.cfg, graph, split, 4, cmesh)
    load_checkpoint(path, again)
    again.run(20)
    out["chains"] = all(
        np.array_equal(ch._gather(getattr(ch.state, f)).numpy(),
                       again._gather(getattr(again.state, f)).numpy())
        for f in ("pi", "phi_sum", "theta", "beta", "ppx_per_edge"))
    return out


def reference_export(seed: int, n_data: int, n_model: int,
                     path: str) -> dict:
    """``refckpt.export_learner`` of a trained sharded learner with a
    training-perplexity population of 63 edges, which the data axis pads
    (rank 0 writes the gathered state at the true population sizes): the
    global state the file should hold and the padded sizes."""
    from mcmc_ammsb_tpu_torch import refckpt

    cfg, graph, split = graph_case(seed, device_sampling=True,
                                   steps_per_call=5, calc_train_ppx=True,
                                   training_ppx_ratio=0.01)
    lrn = sharded.ShardedLearner(cfg, graph, split,
                                 make_mesh(n_data, n_model, device="cpu"))
    lrn.run(10)
    lrn.heldout_perplexity()
    lrn.training_perplexity()
    refckpt.export_learner(path, lrn, graph, split)
    return dict(_global(lrn),
                padded=(int(lrn.heldout_u.shape[0]) * n_data,
                        int(lrn.train_ppx_u.shape[0]) * n_data),
                ppx_per_edge=gather_rows(lrn, "ppx_per_edge"),
                train_ppx_per_edge=gather_rows(lrn, "train_ppx_per_edge"))


# ---------------------------------------------------------------------------
# Chains
# ---------------------------------------------------------------------------

def chains(seed: int, n_groups: int, ck_dir: str) -> dict:
    """The chain engine on a G-rank chain mesh: initial chains, training,
    R-hat, resume, the guard of whole chains per rank."""
    from mcmc_ammsb_tpu_torch.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
    from mcmc_ammsb_tpu_torch.parallel.chains_sharded import (
        ShardedChainLearner, make_chain_mesh)

    cfg, graph, split = graph_case(seed, device_sampling=True,
                                   shared_neighbors=True, steps_per_call=10,
                                   window=4)
    mesh = make_chain_mesh(n_groups, device="cpu")
    out = {}
    lrn = ShardedChainLearner(cfg, graph, split, 4, mesh)
    out["init_pi"] = lrn._gather(lrn.state.pi).numpy().copy()
    p0 = lrn.heldout_perplexity()
    lrn.run(60)
    out["ppx"] = (p0, lrn.heldout_perplexity())
    out["rhat"] = lrn.beta_rhat(draws=2)
    path = os.path.join(ck_dir, "chains.npz")
    save_checkpoint(path, lrn)
    lrn.run(20)
    again = ShardedChainLearner(cfg, graph, split, 4, mesh)
    load_checkpoint(path, again)
    again.run(20)
    out["resume_equal"] = bool(
        np.array_equal(lrn._gather(lrn.state.pi).numpy(),
                       again._gather(again.state.pi).numpy())
        and np.array_equal(lrn._gather(lrn.state.theta).numpy(),
                           again._gather(again.state.theta).numpy()))
    try:
        ShardedChainLearner(cfg, graph, split, 3, mesh)
    except ValueError as e:
        out["guard"] = str(e)
    return out


# ---------------------------------------------------------------------------
# Partitioned ingest
# ---------------------------------------------------------------------------

def ingest(path: str, n_data: int, n_model: int, ratio: float,
           seed: int) -> dict:
    """``partitioned_ingest`` of a SNAP file on this rank, and the
    ``_allgather_concat`` of packed keys above 2^32."""
    mesh = make_mesh(n_data, n_model, device="cpu")
    pd = part.partitioned_ingest(mesh, heldout_ratio=ratio, seed=seed,
                                 path=path)
    keys = part._pack(np.array([dist.get_rank() + 70000], np.int64),
                      np.array([5], np.int64))
    return dict(m=mesh.m_idx, pd=pd._asdict(),
                keys=part._allgather_concat(keys))


def partitioned_vs_replicated(path: str, n_data: int, n_model: int,
                              seed: int) -> dict:
    """A partitioned run against the replicated engine on the same
    dataset (``to_datasplit``) and mesh, and the training-perplexity
    populations of both builders."""
    from mcmc_ammsb_tpu_torch.data import make_training_ppx_edges

    mesh = make_mesh(n_data, n_model, device="cpu")
    pd = part.partitioned_ingest(mesh, heldout_ratio=0.1, seed=seed,
                                 path=path)
    graph, split = part.to_datasplit(pd)
    cfg = Config(K=8, mini_batch_size=8, num_node_sample=8,
                 device_sampling=True, shared_neighbors=True,
                 steps_per_call=12, window=4, calc_train_ppx=True,
                 training_ppx_ratio=0.05).finalize(
        pd.num_nodes, pd.num_edges, pd.max_fan_out)
    a = sharded.ShardedLearner.from_partitioned(cfg, pd, mesh)
    b = sharded.ShardedLearner(cfg, graph, split, mesh)
    out = {}
    for name, lrn in (("part", a), ("repl", b)):
        p0 = lrn.heldout_perplexity()
        lrn.run(24)
        out[name] = dict(_global(lrn), ppx=(p0, lrn.heldout_perplexity()),
                         train_ppx=lrn.training_perplexity())
    tp = part.make_training_ppx_edges_partitioned(pd, 0.05)
    tr = make_training_ppx_edges(split, 0.05)
    out["train_pop_equal"] = bool(np.array_equal(tp[0], tr[0])
                                  and np.array_equal(tp[1], tr[1]))
    return out


def suite(calls) -> dict:
    """Several rank functions in one spawn, in order: {name: result} for
    ``calls`` of (name, function name, args)."""
    return {name: globals()[fn](*args) for name, fn, args in calls}


def skip_collective() -> int:
    """Rank 0 all-reduces, rank 1 skips it and stays alive: rank 0 waits
    in the collective."""
    import time

    t = torch.ones(1)
    if dist.get_rank() == 0:
        dist.all_reduce(t)
    else:
        time.sleep(600)
    return int(t)
