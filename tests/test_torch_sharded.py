"""The row-sharded learner of the port (``parallel/sharded.py``) against
the JAX package's ``parallel/sharded.py``, and its own invariants.

Multi-rank cases run on 2 or 4 gloo ranks (``parallel.dryrun.spawn``,
each spawn under its own deadline; the rank functions are in
torch_dist_workers.py); the JAX side runs in this process on the 8
virtual CPU devices of conftest.py:

  * ``_fetch_rows``, ``_fetch_scalars`` and the write-back on a (1,2) and
    a (2,2) world equal JAX's functions inside ``shard_map`` exactly;
  * one sharded window on an injected operand tuple equals JAX's
    single-device window (gather, jnp core, scatter) to a normwise rtol
    of 1e-5;
  * the sharded evaluator on a JAX Learner's state equals its held-out
    perplexity to rtol 1e-5;
  * JAX's invariants in the port: (1,2) reproduces (1,1) (rtol 2e-4),
    windowed == unwindowed (rtol 2e-4), the fused ppx series == the host
    loop (exactly), theta bit-equal on every rank, resume bit-exact, the
    guards; and (1,1) runs the single-GPU Learner's trajectory bit for
    bit on the CPU.
"""

import logging
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

import torch_dist_workers as W
from mcmc_ammsb_tpu import data as jax_data
from mcmc_ammsb_tpu.learner import Learner as JaxLearner
from mcmc_ammsb_tpu.ops import window as jax_window
from mcmc_ammsb_tpu.parallel import sharded as jsh
from mcmc_ammsb_tpu_torch import cli, testing
from mcmc_ammsb_tpu_torch.config import PhiImpl, RngBackend
from mcmc_ammsb_tpu_torch.learner import Learner
from mcmc_ammsb_tpu_torch.parallel.dryrun import spawn
from mcmc_ammsb_tpu_torch.parallel.mesh import make_mesh
from mcmc_ammsb_tpu_torch.parallel.sharded import ShardedLearner
from torch_parity import assert_normwise, jax_config, jax_window_case

SEED = 5
WINDOW_SHAPE = (4, 9, 8, 8, 16)
TINY = ["--synthetic", "300,8", "-k", "8", "-m", "8", "-n", "8",
        "-x", "60", "-i", "20", "--steps-per-call", "40", "--window", "4",
        "--device", "cpu"]


@pytest.fixture(scope="module")
def mesh22(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("ck22"))
    jl = _jax_learner()
    arrays = {"pi": np.asarray(jl.state.pi), "beta": np.asarray(jl.state.beta)}
    calls = [("coll", "collectives", (SEED, 2, 2)),
             ("window", "sharded_window", (SEED, WINDOW_SHAPE, 2, 2)),
             ("ppx", "ppx_of_state", (arrays, SEED, 2, 2, 8)),
             ("theta", "theta_bits", (SEED, 2, 2)),
             ("traj", "trajectories", (SEED, 2, 2, ck))]
    out = spawn(W.suite, 4, (calls,), timeout=150)
    return out, [jl.heldout_perplexity(), jl.heldout_perplexity()]


@pytest.fixture(scope="module")
def mesh12():
    calls = [("coll", "collectives", (SEED, 1, 2)),
             ("window", "sharded_window", (SEED, WINDOW_SHAPE, 1, 2)),
             ("inv0", "model_invisible", (SEED, 2, 0)),
             ("inv4", "model_invisible", (SEED, 2, 4))]
    return spawn(W.suite, 2, (calls,), timeout=120)


@pytest.fixture
def world1():
    """A process group of size 1 in this process (the CLI's own group
    at world size 1)."""
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    yield
    dist.destroy_process_group()


def _jax_learner():
    n, u, v = jax_data.synthetic_edges(120, 8, seed=SEED)
    split = jax_data.generate_sets(n, u, v, heldout_ratio=0.1, seed=SEED + 1)
    graph = jax_data.Graph.from_edges(n, split.training_u, split.training_v)
    cfg, tgraph, tsplit = W.graph_case(SEED)
    np.testing.assert_array_equal(graph.cols, tgraph.cols)
    np.testing.assert_array_equal(split.heldout_edges_u,
                                  tsplit.heldout_edges_u)
    return JaxLearner(jax_config(cfg), graph, split, prefetch=False)


def _jax_collectives(c, n_data, n_model):
    """JAX's _fetch_rows / _fetch_scalars and its write-back
    (sharded.py:143-155) inside shard_map on a (D, M) mesh."""
    mesh = jax.make_mesh((n_data, n_model), ("data", "model"),
                         devices=jax.devices()[:n_data * n_model])
    rps = c["n_pad"] // n_model

    def body(pi, phi, idx, nodes, mask, rows, sums):
        got_rows = jsh._fetch_rows(pi, idx, rps)
        got_sums = jsh._fetch_scalars(phi, idx, rps)
        m_idx = jax.lax.axis_index("model")
        g_nodes = jax.lax.all_gather(nodes, "data").reshape(-1)
        g_mask = jax.lax.all_gather(mask, "data").reshape(-1)
        g_rows = jax.lax.all_gather(rows, "data").reshape(-1, c["k"])
        g_sums = jax.lax.all_gather(sums, "data").reshape(-1)
        local = g_nodes - m_idx * rps
        ok = (local >= 0) & (local < rps) & g_mask
        safe = jnp.where(ok, local, rps)
        return (got_rows, got_sums, pi.at[safe].set(g_rows, mode="drop"),
                phi.at[safe].set(g_sums, mode="drop"))

    f = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P("model", None), P("model"), P("data"), P("data"),
                  P("data"), P("data", None), P("data")),
        out_specs=(P("data", None), P("data"), P("model", None),
                   P("model")), check_vma=False)
    return [np.asarray(x) for x in f(
        jnp.asarray(c["pi"]), jnp.asarray(c["phi"]), jnp.asarray(c["idx"]),
        jnp.asarray(c["nodes"]), jnp.asarray(c["mask"]),
        jnp.asarray(c["rows"]), jnp.asarray(c["sums"]))]


def _results(out, name):
    return [r[name] for r in out]


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_fetch_and_write_back_match_jax_shard_map(shape, mesh12, mesh22):
    """Every rank's fetched rows and sums equal JAX's for its data shard,
    and its pi / phi_sum shard after the write-back equals JAX's for its
    model shard, exactly (sums of one owner's value and zeros; the
    sentinel N fetches a zero row)."""
    n_data, n_model = (int(x) for x in shape.split("x"))
    out = mesh12 if shape == "1x2" else mesh22[0]
    c = W.collective_case(SEED, n_data, n_model)
    rows, sums, pi, phi = _jax_collectives(c, n_data, n_model)
    rps = c["n_pad"] // n_model
    per = rows.shape[0] // n_data
    assert (c["idx"] == c["n"]).any() and not c["mask"].all()
    for r in _results(out, "coll"):
        d, m = r["d"], r["m"]
        np.testing.assert_array_equal(r["rows"], rows[d * per:(d + 1) * per])
        np.testing.assert_array_equal(r["sums"], sums[d * per:(d + 1) * per])
        np.testing.assert_array_equal(r["pi"], pi[m * rps:(m + 1) * rps])
        np.testing.assert_array_equal(r["phi"], phi[m * rps:(m + 1) * rps])


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_sharded_window_matches_jax_window(shape, mesh12, mesh22):
    """One sharded window (one row fetch over the model ranks, the window
    on the fetched rows, the local write-back) on every rank equals the
    JAX package's single-device window — its gather, jnp core and
    scatter — on the same operand tuple: pi, phi_sum, theta, beta to a
    normwise rtol of 1e-5 (JAX's sharded window is replicated compute,
    so this is its parity too)."""
    out = mesh12 if shape == "1x2" else mesh22[0]
    case = testing.window_case(SEED, *WINDOW_SHAPE)
    jcfg = jax_config(testing.window_case_config(case))
    js, jxs = jax_window_case(case)
    jbatch, jnbrs = jxs[0], jxs[1][:, 0, :]
    g, sums = jax_window._window_gather(jcfg, js, jbatch, jnbrs)
    mcode = jax_window._correction_codes(jcfg, jbatch.nodes,
                                         jbatch.node_mask, jnbrs)
    rows, rsums, theta, beta = jax_window._window_core_jnp(
        jcfg, js, jxs, g, sums, mcode)
    keep = jax_window._last_write_wins(jbatch.nodes, jbatch.node_mask,
                                       WINDOW_SHAPE[0])
    pi, phi = jax_window._window_scatter(jcfg, js, jbatch, keep, rows, rsums)
    assert int(np.asarray(mcode).max()) > 0
    for r in _results(out, "window"):
        assert r["step_count"] == case["step_count"] + WINDOW_SHAPE[0]
        for f, want in (("pi", pi), ("phi", phi), ("theta", theta),
                        ("beta", beta)):
            assert_normwise(r[f], want, rtol=1e-5, atol=1e-8, what=f)


def test_sharded_evaluator_matches_jax_learner(mesh22):
    """The (2,2) evaluator on the JAX Learner's initial state (pi and
    beta carried across) gives its held-out perplexity, twice (the
    running averages), to rtol 1e-5."""
    out, want = mesh22
    for r in _results(out, "ppx"):
        np.testing.assert_allclose(r, want, rtol=1e-5)


@pytest.mark.parametrize("window", [0, 4])
def test_model_axis_is_invisible(window, mesh12):
    """With the data axis at 1 the random streams coincide, so a (1,2)
    run reproduces the (1,1) run to JAX's tolerance
    (tests/test_sharded.py:97-118): pi, theta, held-out ppx."""
    res = _results(mesh12, f"inv{window}")
    base, wide = res[0]["base"], res[0]["wide"]
    np.testing.assert_allclose(wide["pi"], base["pi"], rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(wide["theta"], base["theta"], rtol=2e-4,
                               atol=1e-7)
    np.testing.assert_allclose(res[0]["wide_ppx"], res[0]["base_ppx"],
                               rtol=1e-4)
    # both ranks of the (1,2) run hold the same global state
    np.testing.assert_array_equal(res[1]["wide"]["pi"], wide["pi"])


def test_windowed_matches_unwindowed(mesh22):
    """window=4 (5 windows + 3 tail steps, then one more call) on the
    (2,2) mesh reproduces the unwindowed sharded trajectory: the same
    per-lane streams, the float reduction order aside (rtol 2e-4)."""
    for r in _results(mesh22[0], "traj"):
        seq, win = r["seq"], r["win"]
        assert seq["step"] == win["step"] == 25
        np.testing.assert_allclose(win["pi"], seq["pi"], rtol=2e-4,
                                   atol=1e-7)
        np.testing.assert_allclose(win["theta"], seq["theta"], rtol=2e-4,
                                   atol=1e-7)
        np.testing.assert_allclose(r["ppx_win"], r["ppx_seq"], rtol=1e-4)


def test_fused_series_matches_host_loop(mesh22):
    """run_with_ppx (four evaluations every 10 steps) equals run(10) +
    heldout_perplexity() four times, exactly, with the same final pi."""
    for r in _results(mesh22[0], "traj"):
        assert [s[0] for s in r["series"]] == [11, 21, 31, 41]
        for (_, ppx, links, nll), (p, l2, n2) in zip(r["series"], r["loop"]):
            assert (ppx, links, nll) == (p, l2, n2)
        assert r["series_pi_equal"]


def test_theta_bit_equal_on_every_rank(mesh22):
    """theta and beta are replicated by identical sums and streams, with
    no broadcast: every rank holds the same bits after a chunk."""
    bits = _results(mesh22[0], "theta")
    assert len(set(bits)) == 1
    thetas = [r["theta_rank"].tobytes() for r in _results(mesh22[0],
                                                          "traj")]
    assert len(set(thetas)) == 1


@pytest.mark.parametrize("kind", ["device-sampled", "host-sampled"])
def test_resume_bit_exact(kind, mesh22):
    """Run, save (rank 0 writes the global state and every rank's
    streams), run == restore (each rank reads its rows), run: bit-equal
    global state and perplexity; host-sampled with the pending batches
    of the prefetch pipeline."""
    for r in _results(mesh22[0], "traj"):
        if kind == "host-sampled":
            assert r["host_resume_equal"]
            continue
        a, b = r["resume"]
        for f in ("pi", "phi", "theta", "beta", "step"):
            np.testing.assert_array_equal(a[f], b[f])
        assert r["resume_ppx"][0] == r["resume_ppx"][1]


def test_host_sampled_trains(mesh22):
    """Host-sampled chunks (every rank draws the same global batch and
    keeps its data shard): the held-out ppx falls."""
    for r in _results(mesh22[0], "traj"):
        p0, p1 = r["host_ppx"]
        assert np.isfinite([p0, p1]).all() and p1 < p0


@pytest.mark.parametrize("kw", [
    dict(window=4),
    dict(window=0),
    dict(window=0, device_sampling=False, shared_neighbors=False,
         steps_per_call=5, host_sampler="numpy"),
])
def test_mesh_1x1_is_the_learner(kw, world1):
    """A (1,1) mesh runs the single-GPU Learner's trajectory bit for bit
    on the CPU: data shard 0's streams are the Learner's, a size-1
    all-reduce changes nothing, and masked lanes never reach the state."""
    base = dict(device_sampling=True, shared_neighbors=True,
                steps_per_call=20)
    base.update(kw)
    cfg, graph, split = W.graph_case(SEED, **base)
    single = Learner(cfg, graph, split, "cpu", prefetch=False)
    lrn = ShardedLearner(cfg, graph, split, make_mesh(1, 1, device="cpu"),
                         prefetch=False)
    assert single.heldout_perplexity() == lrn.heldout_perplexity()
    single.run(40)
    lrn.run(40)
    for f in ("pi", "phi_sum", "theta", "beta"):
        assert torch.equal(getattr(lrn.state, f), getattr(single.state, f)), f
    assert single.heldout_perplexity() == lrn.heldout_perplexity()
    single.close()
    lrn.close()


@pytest.mark.parametrize("kw, error, match", [
    (dict(rng_backend=RngBackend.REFERENCE), ValueError, "native"),
    (dict(window=4, device_sampling=False), ValueError, "window"),
    (dict(window=4, shared_neighbors=False), ValueError, "shared_neighbors"),
    (dict(window=4, window_impl="mosaic"), ValueError, "window_impl"),
    (dict(pi_dtype="bfloat16", phi_impl=PhiImpl.PALLAS,
          shared_neighbors=False), ValueError,
     "pi_dtype=bfloat16 requires phi_impl=jnp"),
])
def test_sharded_guards_raise(kw, error, match, world1):
    """The JAX ShardedLearner's guards (sharded.py:592-620) raise as
    its own do; bfloat16 pi trains sharded (tests/test_torch_bf16.py)
    and is refused, as in JAX, only with --phi-impl pallas."""
    base = dict(device_sampling=True, shared_neighbors=True)
    base.update(kw)
    cfg, graph, split = W.graph_case(SEED, **base)
    with pytest.raises(error, match=match):
        ShardedLearner(cfg, graph, split, make_mesh(1, 1, device="cpu"))


def test_partitioned_needs_device_sampling(world1):
    cfg, graph, split = W.graph_case(SEED, device_sampling=False)
    mesh = make_mesh(1, 1, device="cpu")
    with pytest.raises(ValueError, match="device_sampling"):
        ShardedLearner(cfg, None, None, mesh, partitioned=object())
    with pytest.raises(ValueError, match="not both"):
        ShardedLearner(cfg.replace(device_sampling=True), graph, split,
                       mesh, partitioned=object())


def _ppx(messages):
    return {int(m.group(1)): float(m.group(2)) for m in
            (re.fullmatch(r"ppx\[(\d+)\] = (\S+)", msg) for msg in messages)
            if m}


def test_cli_mesh_1x1_in_one_process(caplog):
    """`--mesh 1,1` from a plain process: the CLI starts a group of size
    1 itself (gloo with --device cpu), trains, ends the group, and logs
    the single-GPU run's ppx series."""
    with caplog.at_level(logging.INFO, logger="mcmc_ammsb_tpu_torch"):
        assert cli.main(TINY + ["--mesh", "1,1"]) == 0
        sharded_msgs = [r.getMessage() for r in caplog.records]
        caplog.clear()
        assert cli.main(TINY) == 0
        single_msgs = [r.getMessage() for r in caplog.records]
    assert not dist.is_initialized()
    assert any(m.startswith("torch.distributed: rank 0 of 1 (gloo)")
               for m in sharded_msgs)
    assert _ppx(sharded_msgs) == _ppx(single_msgs)
    assert sorted(_ppx(sharded_msgs)) == [0, 20, 40, 60]


def test_cli_mesh_2x2_on_four_ranks():
    """`--mesh 2,2 --device cpu` on 4 ranks started as torchrun starts
    them (env RANK, WORLD_SIZE, MASTER_ADDR/PORT): rc 0 everywhere, ppx
    falls, and only rank 0 logs the series and the stats table."""
    out = spawn(W.run_cli, 4, (TINY + ["--mesh", "2,2"],), timeout=120,
                launcher=True)
    for rank, (rc, msgs) in enumerate(out):
        assert rc == 0
        ppx = _ppx(msgs)
        if rank == 0:
            assert sorted(ppx) == [0, 20, 40, 60]
            assert ppx[60] < ppx[0]
            assert any(m.startswith("mesh: data=2 model=2") for m in msgs)
            assert any(m.startswith("TOTAL") for m in msgs)
        else:
            assert not ppx and not any(m.startswith("TOTAL") for m in msgs)


def test_cli_mesh_profile_and_checkpoint(caplog, tmp_path):
    """`--mesh 1,1 --profile` prints the traced stage table of the
    sharded loop (its fetch in pi_gather); `--checkpoint` then
    `--restore` resumes from the sharded checkpoint at step 301 (60
    steps, then the profile's 40 + 200) and its first evaluation is
    finite."""
    ck = str(tmp_path / "mesh.npz")
    with caplog.at_level(logging.INFO, logger="mcmc_ammsb_tpu_torch"):
        assert cli.main(TINY + ["--mesh", "1,1", "--profile",
                                "--checkpoint", ck]) == 0
        first = [r.getMessage() for r in caplog.records]
        caplog.clear()
        assert cli.main(TINY + ["--mesh", "1,1", "--restore", ck]) == 0
        second = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("fused per-step stage profile") for m in first)
    assert any(m.startswith("PI_GATHER") for m in first)
    assert any(m.startswith(f"checkpoint saved to {ck}") for m in first)
    assert any(m == f"restored checkpoint {ck} (step=301)" for m in second)
    assert np.isfinite(list(_ppx(second).values())).all()


def test_window_slots_map_ids_to_one_slot_each():
    """Two read lanes share a table slot exactly when they read the same
    row id, and a slot is a lane that reads that id."""
    from mcmc_ammsb_tpu_torch.parallel.sharded import window_slots

    ids = torch.tensor(np.random.default_rng(0).integers(0, 40, 300))
    slots = window_slots(ids, 41).long()
    assert torch.equal(ids[slots], ids)
    same_id = ids[:, None] == ids[None, :]
    assert torch.equal(slots[:, None] == slots[None, :], same_id)


def test_table_mode_is_the_window_on_fetched_rows(world1):
    """What the kernel path does — the window on the fetched rows as a
    table, node and neighbor ids remapped to their slots, the kept rows
    written into the table and copied back — here with the plain ops in
    place of the kernel, equals the plain window on the fetched rows
    (--window-impl jnp) bit for bit: the remap keeps the self-exclusion
    of a neighbor equal to its node and the last-write-wins rows."""
    from mcmc_ammsb_tpu_torch.ops import phi as phi_ops
    from mcmc_ammsb_tpu_torch.ops import window
    from mcmc_ammsb_tpu_torch.parallel import sharded

    case = testing.window_case(SEED, 6, 9, 8, 8, 16)
    cfg = testing.window_case_config(case)
    state, xs = testing.window_case_torch(case, "cpu")
    batch, nbrs = xs[0], xs[1][:, 0, :]
    b_cap = batch.nodes.shape[1]
    mcode = window._correction_codes(cfg, batch.nodes, batch.node_mask,
                                     nbrs)
    keep = window._last_write_wins(batch.nodes, batch.node_mask, cfg.window)
    ctx = sharded.ShardCtx(cfg.replace(window_impl="jnp"),
                           make_mesh(1, 1, device="cpu"), cfg.N, None)
    fresh = state._replace(pi=state.pi.clone(), phi_sum=state.phi_sum.clone())
    want = sharded.sharded_window_apply(ctx, fresh, xs, mcode, keep)

    read = torch.cat([batch.nodes, nbrs], dim=1)
    g, sums = sharded._fetch(ctx.mesh, cfg.N, read.reshape(-1), state.pi,
                             state.phi_sum)
    sums = torch.where(sums > 0.0, sums, 1.0)
    slots = sharded.window_slots(read.reshape(-1), cfg.N + 1).reshape(
        read.shape)
    assert (nbrs[:, None, :] == batch.nodes[:, :, None]).any()
    nodes_k = slots[:, :b_cap]
    xs_k = (batch._replace(nodes=nodes_k), slots[:, None, b_cap:], *xs[2:])
    rows, rsums, theta, beta = window.window_core_torch(
        cfg, state, xs_k, g[slots.long()], sums[nodes_k.long()], mcode)
    table, table_sums = phi_ops.scatter_rows(
        g.clone(), sums.clone(), nodes_k.reshape(-1), keep.reshape(-1),
        rows, rsums)
    got = sharded._apply_rows(
        ctx.mesh, cfg.N, state, batch.nodes.reshape(-1), keep.reshape(-1),
        table[nodes_k.reshape(-1).long()],
        table_sums[nodes_k.reshape(-1).long()])
    for a, b in ((got.pi, want.pi), (got.phi_sum, want.phi_sum),
                 (theta, want.theta), (beta, want.beta)):
        assert torch.equal(a, b)
