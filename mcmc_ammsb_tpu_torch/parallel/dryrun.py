"""Multi-rank runs on the CPU: ``spawn`` starts n gloo ranks, each its own
process, under a deadline of its own; ``dryrun_multichip`` is the torch
twin of the JAX package's ``__graft_entry__.dryrun_multichip``.

  python -m mcmc_ammsb_tpu_torch.parallel.dryrun 4

``spawn`` runs ``fn(*args)`` (an importable module-level function) in n
processes that first join one gloo process group through a ``file://``
store in a scratch directory (no TCP port), and returns their results in
rank order. A rank that skips a collective or orders them differently
hangs the others; so the parent waits until ``timeout`` seconds and then
kills every rank and raises, with the tail of each rank's errors.
"""

from __future__ import annotations

import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Callable, List, Sequence

import numpy as np


def free_port() -> int:
    """A TCP port of 127.0.0.1 that is free now (for a rendezvous on this
    host)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(fn: Callable, world_size: int, args: Sequence = (),
          timeout: float = 60.0, workdir: str = None,
          launcher: bool = False) -> List:
    """``fn(*args)`` on ``world_size`` gloo ranks of one process group:
    the list of their return values in rank order. Raises RuntimeError if
    a rank fails and TimeoutError (after killing every rank) when
    ``timeout`` seconds pass first. With ``launcher`` the ranks do not
    join a group: each gets torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT`` of a
    free port) and ``fn`` starts the group itself."""
    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="mcmc_spawn_")
    spec = os.path.join(workdir, "spec.pkl")
    with open(spec, "wb") as f:
        pickle.dump({"fn": (fn.__module__, fn.__qualname__),
                     "args": tuple(args), "world": world_size,
                     "init": (None if launcher else
                              "file://" + os.path.join(workdir, "store")),
                     "sys_path": list(sys.path)}, f)
    port = str(free_port()) if launcher else None
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    procs = []
    try:
        for rank in range(world_size):
            if launcher:
                env.update(RANK=str(rank), LOCAL_RANK=str(rank),
                           WORLD_SIZE=str(world_size),
                           LOCAL_WORLD_SIZE=str(world_size),
                           MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
            with open(os.path.join(workdir, f"rank{rank}.err"), "wb") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "mcmc_ammsb_tpu_torch.parallel.dryrun", "--rank-worker",
                     spec, str(rank)],
                    stdout=err, stderr=subprocess.STDOUT, env=dict(env),
                    start_new_session=True))
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            raise TimeoutError(
                f"{world_size} ranks of {fn.__qualname__} did not finish in "
                f"{timeout} s:\n" + _tails(workdir, world_size)) from None
        if any(p.returncode for p in procs):
            raise RuntimeError(
                f"{fn.__qualname__}: rank exit codes "
                f"{[p.returncode for p in procs]}:\n"
                + _tails(workdir, world_size))
        out = []
        for rank in range(world_size):
            with open(os.path.join(workdir, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:             # no rank outlives the call
            if p.poll() is None:
                p.kill()
                p.wait()
        if own:
            shutil.rmtree(workdir, ignore_errors=True)


def _tails(workdir: str, world_size: int) -> str:
    parts = []
    for rank in range(world_size):
        with open(os.path.join(workdir, f"rank{rank}.err"), "rb") as f:
            text = f.read().decode(errors="replace")
        parts.append(f"--- rank {rank} ---\n{text[-3000:]}")
    return "\n".join(parts)


def _rank_worker(spec_path: str, rank: int) -> None:
    """One rank of ``spawn``: join the group, run the function, pickle
    its result next to the spec."""
    import importlib

    import torch
    import torch.distributed as dist

    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    sys.path[:0] = [p for p in spec["sys_path"] if p not in sys.path]
    torch.set_num_threads(1)
    module, qualname = spec["fn"]
    fn = importlib.import_module(module)
    for part in qualname.split("."):
        fn = getattr(fn, part)
    if spec["init"] is None:       # the function starts the group
        result = fn(*spec["args"])
    else:
        dist.init_process_group("gloo", init_method=spec["init"],
                                world_size=spec["world"], rank=rank)
        try:
            result = fn(*spec["args"])
        finally:
            dist.destroy_process_group()
    out = os.path.join(os.path.dirname(spec_path), f"rank{rank}.pkl")
    with open(out + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out + ".tmp", out)


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------

def tiny_problem(seed: int = 0):
    """The JAX dry run's problem: (cfg, graph, split), N = 256, K = 16."""
    from mcmc_ammsb_tpu_torch.config import Config
    from mcmc_ammsb_tpu_torch.data import Graph, generate_sets, synthetic_edges

    n, u, v = synthetic_edges(num_nodes=256, avg_degree=8, seed=seed)
    split = generate_sets(n, u, v, heldout_ratio=0.1, seed=seed + 1)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = Config(K=16, mini_batch_size=8, num_node_sample=8)
    return cfg.finalize(n, split.total_edges, graph.max_fan_out), graph, split


def gather_rows(learner, name: str = "pi"):
    """A sharded learner's global ``name`` field ([N_pad, ...], the model
    shards in order; bf16 pi as float32) on every rank of its model
    group."""
    import torch
    import torch.distributed as dist

    group, _ = learner.shard_layout()[name]
    x = getattr(learner.state, name)
    if x.dtype == torch.bfloat16:
        x = x.float()              # losslessly, as the checkpoint does
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],
                       *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out.cpu().numpy() if isinstance(out, torch.Tensor) else out


def _dryrun_rank(n: int) -> str:
    """Every rank of the dry run: the JAX dry run's contracts on n gloo
    ranks."""
    import torch
    import torch.distributed as dist

    from mcmc_ammsb_tpu_torch.learner import Learner
    from mcmc_ammsb_tpu_torch.parallel.chains_sharded import (
        ShardedChainLearner, make_chain_mesh)
    from mcmc_ammsb_tpu_torch.parallel.mesh import make_mesh
    from mcmc_ammsb_tpu_torch.parallel.sharded import ShardedLearner

    # the JAX gate's third shape; a 2-D one where n has a proper divisor
    # (the JAX gate takes (1, 4) again at n = 4)
    a_mid = next(c for c in (4, 2, 1) if n % c == 0 and (c < n or c == 1))
    shapes = []
    for shape in [(n, 1), (1, n), (n // a_mid, a_mid)]:
        if shape not in shapes:
            shapes.append(shape)
    cfg, graph, split = tiny_problem()
    fused_cfg = cfg.replace(device_sampling=True, steps_per_call=4)
    # the single-GPU evaluator on the identical init
    single = Learner(cfg, graph, split, "cpu", prefetch=False)
    ppx_single = single.heldout_perplexity()
    single.close()
    reports = []
    for n_data, n_model in shapes:
        mesh = make_mesh(n_data, n_model, device="cpu")
        learner = ShardedLearner(cfg, graph, split, mesh, prefetch=False)
        ppx0 = learner.heldout_perplexity()
        np.testing.assert_allclose(ppx0, ppx_single, rtol=1e-5)
        learner.run(1)
        assert learner.step_count == 2
        # the fused eval series over two calls of 4 steps
        fused = ShardedLearner(fused_cfg, graph, split, mesh)
        series = fused.run_with_ppx(4, 2) + fused.run_with_ppx(4, 2)
        assert len(series) == 4 and fused.step_count == 9
        assert all(np.isfinite(ev["ppx"]) for ev in series)
        reports.append(f"({n_data}x{n_model}) ppx0={ppx0:.4f} "
                       f"fused[{series[-1]['ppx']:.4f}]")
        learner.close()

    # model sharding is invisible: (1,n) reproduces (1,1)
    base_mesh = make_mesh(1, 1, allow_subset=True, device="cpu")
    wide = ShardedLearner(fused_cfg, graph, split,
                          make_mesh(1, n, device="cpu"))
    wide.run(12)
    pi_wide = gather_rows(wide)[:cfg.N]
    pw = wide.heldout_perplexity()
    if base_mesh.member:
        base = ShardedLearner(fused_cfg, graph, split, base_mesh)
        base.run(12)
        np.testing.assert_allclose(base.state.pi.numpy()[:cfg.N], pi_wide,
                                   rtol=2e-4, atol=1e-7)
        np.testing.assert_allclose(base.state.theta.numpy(),
                                   wide.state.theta.numpy(),
                                   rtol=2e-4, atol=1e-7)
        np.testing.assert_allclose(base.heldout_perplexity(), pw,
                                   rtol=1e-4)

    # bfloat16 pi storage composes with the mesh
    mesh = make_mesh(*shapes[-1], device="cpu")
    bf = ShardedLearner(fused_cfg.replace(pi_dtype="bfloat16"), graph,
                        split, mesh)
    bf.run(8)
    assert bf.state.pi.dtype == torch.bfloat16
    assert np.isfinite(bf.heldout_perplexity())

    # the windowed path reproduces the unwindowed one on the (a,b) mesh
    wcfg = fused_cfg.replace(shared_neighbors=True, window=4,
                             steps_per_call=12)
    seqw = ShardedLearner(wcfg.replace(window=0), graph, split, mesh)
    winw = ShardedLearner(wcfg, graph, split, mesh)
    seqw.run(12)
    winw.run(12)
    np.testing.assert_allclose(gather_rows(winw)[:cfg.N],
                               gather_rows(seqw)[:cfg.N],
                               rtol=2e-4, atol=1e-7)

    # chains over the ranks: deterministic, windowed == sequential,
    # finite per-chain evaluations
    groups = 2 if n >= 2 else 1
    cmesh = make_chain_mesh(groups, device="cpu")
    if cmesh.member:
        ccfg = cfg.replace(device_sampling=True, shared_neighbors=True,
                           steps_per_call=8)
        shc = ShardedChainLearner(ccfg, graph, split, 4, cmesh)
        shc2 = ShardedChainLearner(ccfg, graph, split, 4, cmesh)
        shw = ShardedChainLearner(ccfg.replace(window=4), graph, split, 4,
                                  cmesh)
        for lrn in (shc, shc2, shw):
            lrn.run(8)
        np.testing.assert_array_equal(shc.state.pi.numpy(),
                                      shc2.state.pi.numpy())
        np.testing.assert_allclose(shw.state.pi.numpy(),
                                   shc.state.pi.numpy(),
                                   rtol=5e-4, atol=1e-7)
        ppx_c = shc.heldout_perplexity()
        assert ppx_c.shape == (4,) and np.isfinite(ppx_c).all()
    dist.barrier()
    return "; ".join(reports)


def dryrun_multichip(n_ranks: int, timeout: float = 120.0) -> str:
    """The JAX dry run's gate on ``n_ranks`` gloo ranks of this host's
    CPU: the (n,1), (1,n) and (a,b) meshes train and run the fused eval
    series across two calls, the sharded evaluator equals the single-GPU
    ``Learner``'s held-out ppx on the identical state, (1,n) reproduces
    (1,1), bfloat16 pi trains on the (a,b) mesh, the windowed path
    reproduces the unwindowed one, and the
    chain mesh is deterministic with windowed == sequential chains.
    Raises on a broken contract; returns rank 0's report."""
    return spawn(_dryrun_rank, n_ranks, (n_ranks,), timeout=timeout)[0]


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--rank-worker":
        _rank_worker(sys.argv[2], int(sys.argv[3]))
    else:
        print(dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1
                               else 4))
