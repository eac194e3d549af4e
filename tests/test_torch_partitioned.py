"""Partitioned ingest and the model-row-sharded CSR of the port
(``parallel/partitioned.py``) against the JAX package's.

The hash split, the fake non-links, the shard CSR slices and the whole
``partitioned_ingest`` of a SNAP file — parsed by byte range on 4 gloo
ranks — give the JAX package's arrays exactly (JAX runs it in one
process on the 8 virtual CPU devices); ``ShardedCSR``'s membership,
degree and row-gather answers on a (2,2) world equal JAX's inside
``shard_map`` exactly; packed keys above 2^32 cross the ranks intact; a
partitioned run equals the replicated engine on the same dataset bit for
bit, as does the training-perplexity population. Each spawn runs under
its own deadline."""

import logging
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

import torch_dist_workers as W
from mcmc_ammsb_tpu.parallel import make_mesh as jax_make_mesh
from mcmc_ammsb_tpu.parallel import partitioned as jpart
from mcmc_ammsb_tpu_torch import cli
from mcmc_ammsb_tpu_torch.data import synthetic_edges
from mcmc_ammsb_tpu_torch.parallel import partitioned as part
from mcmc_ammsb_tpu_torch.parallel.dryrun import spawn
from mcmc_ammsb_tpu_torch.parallel.mesh import make_mesh

SEED = 4
RATIO = 0.1
TINY = ["-k", "8", "-m", "8", "-n", "8", "-x", "60", "-i", "20",
        "--steps-per-call", "40", "--window", "4", "--device", "cpu"]


@pytest.fixture(scope="module")
def snap_file(tmp_path_factory):
    """A 300-node random graph as a SNAP file (raw ids spread out, a
    comment line, one self-loop)."""
    n, u, v = synthetic_edges(300, 8, seed=SEED)
    lines = ["# nodes 300"] + [f"{3 * a + 11}\t{3 * b + 11}"
                               for a, b in zip(u, v)] + ["5\t5"]
    path = tmp_path_factory.mktemp("part") / "graph.txt"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def ranks22(snap_file):
    calls = [("ingest", "ingest", (snap_file, 2, 2, RATIO, SEED)),
             ("csr", "csr_queries", (SEED, 2, 2)),
             ("run", "partitioned_vs_replicated", (snap_file, 2, 2, SEED))]
    return spawn(W.suite, 4, (calls,), timeout=150)


@pytest.fixture
def world1():
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    yield
    dist.destroy_process_group()


def _jax_mesh(n_data, n_model):
    return jax_make_mesh(n_data, n_model, allow_subset=True)


def _assert_pdata_equal(got: dict, want, m=None):
    for f in ("num_nodes", "num_edges", "max_fan_out", "cols_cap"):
        assert got[f] == getattr(want, f), f
    for f in ("heldout_u", "heldout_v", "fake_u", "fake_v"):
        assert got[f].dtype == getattr(want, f).dtype, f
        np.testing.assert_array_equal(got[f], getattr(want, f), err_msg=f)
    shards = [m] if m is not None else sorted(want.shards)
    assert sorted(got["shards"]) == shards
    for s in shards:
        for a, b in zip(got["shards"][s], want.shards[s]):
            np.testing.assert_array_equal(a, b)


def test_hash_split_matches_jax():
    """splitmix64, the packing (keys above 2^32) and the held-out rule
    are the JAX package's bit for bit."""
    r = np.random.default_rng(0)
    u = r.integers(0, 1 << 31, 5000)
    v = r.integers(0, 1 << 31, 5000)
    packed = part._pack(u, v)
    assert (packed > (1 << 32)).any()
    np.testing.assert_array_equal(packed, jpart._pack(u, v))
    np.testing.assert_array_equal(part._splitmix64(packed),
                                  jpart._splitmix64(packed))
    for a, b in zip(part._unpack(packed), jpart._unpack(packed)):
        np.testing.assert_array_equal(a, b)
    for ratio, seed in ((0.1, 7), (0.4, 12345)):
        np.testing.assert_array_equal(
            part.heldout_link_mask(u, v, ratio, seed),
            jpart.heldout_link_mask(u, v, ratio, seed))


def test_csr_slice_and_fake_nonlinks_match_jax():
    n, u, v = synthetic_edges(300, 8, seed=SEED)
    for lo, hi in ((0, 150), (150, 300), (300, 300)):
        for a, b in zip(part._csr_slice(u, v, lo, hi),
                        jpart._csr_slice(u, v, lo, hi)):
            np.testing.assert_array_equal(a, b)
    packed = np.unique(part._pack(u, v))
    for ranges in ([(0, n)], [(0, 100), (200, 300)]):
        got = part.sample_fake_nonlinks(n, 120, 8, packed, ranges)
        want = jpart.sample_fake_nonlinks(n, 120, 8, packed, ranges)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_ingest_one_rank_matches_jax(snap_file, world1):
    """partitioned_ingest on a (1,1) mesh == JAX's on a (1,1) mesh, and
    the training-perplexity population of the partitioned builder ==
    JAX's, exactly."""
    pd = part.partitioned_ingest(make_mesh(1, 1, device="cpu"),
                                 heldout_ratio=RATIO, seed=SEED,
                                 path=snap_file)
    want = jpart.partitioned_ingest(_jax_mesh(1, 1), heldout_ratio=RATIO,
                                    seed=SEED, path=snap_file)
    _assert_pdata_equal(pd._asdict(), want)
    assert pd.local_parse_edges == want.local_parse_edges
    for a, b in zip(part.make_training_ppx_edges_partitioned(pd, 0.05),
                    jpart.make_training_ppx_edges_partitioned(want, 0.05)):
        np.testing.assert_array_equal(a, b)


def test_ingest_four_ranks_matches_jax(snap_file, ranks22):
    """Four ranks each parse a quarter of the file by byte range; every
    rank's dataset view (its model shard's CSR, the replicated held-out
    links and fake non-links, N, E, the max degree and the column cap)
    equals JAX's one-process ingest on a (2,2) mesh."""
    want = jpart.partitioned_ingest(_jax_mesh(2, 2), heldout_ratio=RATIO,
                                    seed=SEED, path=snap_file)
    parsed = 0
    for r in ranks22:
        got = r["ingest"]
        _assert_pdata_equal(got["pd"], want, m=got["m"])
        parsed += got["pd"]["local_parse_edges"]
    # every line parsed by exactly one rank
    assert parsed == want.local_parse_edges


def test_packed_keys_above_2_32_cross_ranks(ranks22):
    """_allgather_concat moves uint64 keys as int64 bit views: the u half
    (above 2^32) arrives intact, in rank order, on every rank."""
    want = part._pack(np.arange(4) + 70000, np.full(4, 5))
    assert (want > (1 << 32)).all()
    for r in ranks22:
        assert r["ingest"]["keys"].dtype == np.uint64
        np.testing.assert_array_equal(r["ingest"]["keys"], want)


def test_sharded_csr_matches_jax_shard_map(ranks22):
    """has_edges (flat and broadcast), degree and row_gather of every
    rank's data slice == JAX's ShardedCSR inside shard_map on a (2,2)
    mesh, exactly (integer sums of the owner's answer)."""
    cfg, graph, _ = W.graph_case(SEED)
    mesh = _jax_mesh(2, 2)
    rps = -(-cfg.N // 2)
    shards = {m: jpart._csr_slice(graph.edges_u, graph.edges_v,
                                  min(m * rps, cfg.N),
                                  min((m + 1) * rps, cfg.N))
              for m in range(2)}
    cap = max(len(s.cols) for s in shards.values())
    csr = jpart.build_sharded_csr(mesh, cfg.N, rps, shards, cap)
    u, v, off = W.query_case(SEED, cfg.N, 2)

    def body(c, u, v, off):
        return (c.has_edges(u, v), c.has_edges(u[:, None], v[None, :8]),
                c.degree(u), c.row_gather(u, off))

    f = jax.shard_map(body, mesh=mesh,
                      in_specs=(csr.spec(), P("data"), P("data"),
                                P("data", None)),
                      out_specs=(P("data"), P("data", None), P("data"),
                                 P("data", None)), check_vma=False)
    has, has2, deg, rows = (np.asarray(x) for x in f(
        csr, jnp.asarray(u), jnp.asarray(v), jnp.asarray(off)))
    assert has.any() or has2.any()
    per = len(u) // 2
    for r in ranks22:
        got, d = r["csr"], r["csr"]["d"]
        sl = slice(d * per, (d + 1) * per)
        np.testing.assert_array_equal(got["has"], has[sl])
        np.testing.assert_array_equal(got["has2"], has2[sl])
        np.testing.assert_array_equal(got["deg"], deg[sl])
        np.testing.assert_array_equal(got["rows"], rows[sl])


def test_partitioned_run_equals_replicated_run(ranks22):
    """ShardedLearner.from_partitioned (the sharded CSR answers
    membership and the device sampler's adjacency) and the replicated
    engine on the same dataset and mesh: bit-equal pi, theta, held-out
    and training perplexity after 24 windowed steps
    (tests/test_partitioned.py:138); the training-perplexity populations
    of the two builders are equal."""
    for r in ranks22:
        a, b = r["run"]["part"], r["run"]["repl"]
        for f in ("pi", "phi", "theta", "beta", "ppx", "train_ppx"):
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
        assert a["ppx"][1] < a["ppx"][0]
        assert r["run"]["train_pop_equal"]


@pytest.mark.parametrize("flags, message", [
    (["--synthetic", "300,8", "--mesh", "1,1"], "requires --file"),
    (["--mesh", "", "--file", "x"], "requires --mesh"),
    (["--mesh", "1,1", "--file", "x", "--no-device-sampling"],
     "requires device sampling"),
])
def test_cli_partitioned_guards(flags, message, caplog):
    with caplog.at_level(logging.INFO, logger="mcmc_ammsb_tpu_torch"):
        assert cli.main(["--partitioned-ingest"] + TINY + flags) == 1
    assert any(message in r.getMessage() for r in caplog.records)


def test_cli_partitioned_ingest_two_ranks(snap_file):
    """`--partitioned-ingest --file graph.txt --mesh 1,2` on 2 ranks
    started as torchrun starts them: rank 0 logs the ingest line and a
    falling ppx series."""
    out = spawn(W.run_cli, 2, (TINY + ["--partitioned-ingest", "--file",
                                       snap_file, "--mesh", "1,2"],),
                timeout=120, launcher=True)
    assert [rc for rc, _ in out] == [0, 0]
    msgs = out[0][1]
    assert any(m.startswith("partitioned ingest in ") for m in msgs)
    ppx = {int(m.group(1)): float(m.group(2)) for m in
           (re.fullmatch(r"ppx\[(\d+)\] = (\S+)", x) for x in msgs) if m}
    assert sorted(ppx) == [0, 20, 40, 60] and ppx[60] < ppx[0]
