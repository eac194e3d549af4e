"""The port's mesh and process start-up (``parallel/mesh.py``,
``parallel/multihost.py``) and the CPU dry run (``parallel/dryrun.py``).

The byte-range ETL (``byte_ranges``, ``load_snap_edges_range``,
``renumber_edges``, ``shard_csr``, ``global_vocab``) gives the JAX
package's arrays exactly; the mesh lays rank r = d*M + m out with JAX's
defaults and refuses what JAX refuses, with its wording; the process
group starts through torchrun's environment or the JAX CLI's
--coordinator flags. Multi-rank cases run on gloo ranks, each spawn
under its own deadline."""

import numpy as np
import pytest
import torch.distributed as dist

import torch_dist_workers as W
from mcmc_ammsb_tpu.parallel import multihost as jmh
from mcmc_ammsb_tpu_torch.parallel import multihost
from mcmc_ammsb_tpu_torch.parallel.dryrun import (dryrun_multichip,
                                                  free_port, spawn)
from mcmc_ammsb_tpu_torch.parallel.mesh import make_mesh


@pytest.fixture(scope="module")
def snap_file(tmp_path_factory):
    """A SNAP file with comments, self-loops, duplicate and reversed
    pairs, extra columns, a blank line and sparse raw ids."""
    r = np.random.default_rng(3)
    lines = ["# Directed graph", "% another comment style"]
    for _ in range(400):
        a, b = (int(x) * 7 + 1000 for x in r.integers(0, 90, 2))
        lines.append(f"{a}\t{b}" + ("\t1" if r.random() < 0.1 else ""))
        if r.random() < 0.1:
            lines.append(f"{b} {a}")
        if r.random() < 0.05:
            lines.append("")
    path = tmp_path_factory.mktemp("snap") / "graph.txt"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def two_ranks(snap_file):
    calls = [("errors", "mesh_errors", ()),
             ("vocab", "vocab", (snap_file,))]
    return spawn(W.suite, 2, (calls,), timeout=90)


@pytest.mark.parametrize("num_ranges", [1, 2, 3, 7])
def test_byte_ranges_and_range_parse_match_jax(snap_file, num_ranges):
    """The ranges and each range's raw edges are JAX's exactly."""
    ranges = multihost.byte_ranges(snap_file, num_ranges)
    assert ranges == jmh.byte_ranges(snap_file, num_ranges)
    for start, end in ranges:
        got = multihost.load_snap_edges_range(snap_file, start, end)
        want = jmh.load_snap_edges_range(snap_file, start, end)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_renumber_and_shard_csr_match_jax(snap_file):
    """renumber_edges against the shared vocabulary and the CSR of each
    of three row shards are JAX's exactly."""
    u, v = multihost.load_snap_edges_range(snap_file, 0, 1 << 30)
    vocab = multihost.global_vocab(np.concatenate([u, v]))
    np.testing.assert_array_equal(vocab,
                                  jmh.global_vocab(np.concatenate([u, v])))
    ru, rv = multihost.renumber_edges(u, v, vocab)
    ju, jv = jmh.renumber_edges(u, v, vocab)
    np.testing.assert_array_equal(ru, ju)
    np.testing.assert_array_equal(rv, jv)
    n = len(vocab)
    for lo, hi in ((0, n // 3), (n // 3, 2 * n // 3), (2 * n // 3, n)):
        for g, w in zip(multihost.shard_csr(n, ru, rv, lo, hi),
                        jmh.shard_csr(n, ru, rv, lo, hi)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_global_vocab_over_two_ranks_matches_jax(snap_file, two_ranks):
    """Each rank parses its byte range; the all-gathered vocabulary is
    the JAX package's over the whole file, on both ranks."""
    u, v = jmh.load_snap_edges_range(snap_file, 0, 1 << 30)
    want = jmh.global_vocab(np.concatenate([u, v]))
    for r in two_ranks:
        np.testing.assert_array_equal(r["vocab"], want)


def test_mesh_refusals_on_two_ranks(two_ranks):
    """A 2-rank world refuses a (1,1) mesh without allow_subset and a
    (2,2) mesh, with JAX's wording; with allow_subset rank 1 is outside
    the (1,1) mesh."""
    for rank, r in enumerate(two_ranks):
        subset, bigger, member = r["errors"]
        assert "uses 1 of 2 devices" in subset and "allow_subset" in subset
        assert "needs 4 devices, only 2 available" in bigger
        assert member == (rank == 0)


def test_mesh_at_world_size_one():
    """Without a process group make_mesh says so; in a group of size 1,
    (1,1) and the default split work and (1,2) needs 2 devices."""
    with pytest.raises(RuntimeError, match="initialize"):
        make_mesh(1, 1, device="cpu")
    assert multihost.initialize(device="cpu")
    assert not multihost.initialize(device="cpu")    # already running
    try:
        mesh = make_mesh(device="cpu")
        assert mesh.shape == {"data": 1, "model": 1}
        assert (mesh.d_idx, mesh.m_idx, mesh.member) == (0, 0, True)
        with pytest.raises(ValueError, match="needs 2 devices, only 1"):
            make_mesh(1, 2, device="cpu")
        with pytest.raises(ValueError, match="needs 4 devices"):
            make_mesh(2, 2, device="cpu")
    finally:
        dist.destroy_process_group()


def test_mesh_layout_on_four_ranks():
    """Rank r = d*M + m: a model group is consecutive ranks, a data
    group strides by M; the default split of 4 ranks is (1, 4)."""
    out = spawn(W.mesh_layout, 4, (2, 2), timeout=150)
    for r in out:
        assert (r["d"], r["m"]) == divmod(r["rank"], 2)
        assert r["model"] == [2 * r["d"], 2 * r["d"] + 1]
        assert r["data"] == [r["m"], 2 + r["m"]]
        assert r["default"] == {"data": 1, "model": 4}


def test_coordinator_flags_start_the_group():
    """--coordinator HOST:PORT --num-processes 2 --process-id I: a TCP
    rendezvous, gloo for a CPU run, a working all-reduce."""
    out = spawn(W.coordinator_start, 2, (free_port(),), timeout=90,
                launcher=True)
    assert [o[:4] for o in out] == [(True, 0, 2, "gloo"),
                                    (True, 1, 2, "gloo")]
    assert all(o[4] == 3 for o in out)


def test_dryrun_multichip_four_ranks():
    """The torch twin of the JAX dry run on 4 gloo ranks: the (4,1),
    (1,4) and (2,2) meshes train and run the fused eval across two
    calls, the evaluator equals the single-GPU Learner's, (1,4)
    reproduces (1,1), windowed == unwindowed, the chain mesh is
    deterministic."""
    report = dryrun_multichip(4, timeout=120)
    assert "(4x1)" in report and "(1x4)" in report and "(2x2)" in report


def test_spawn_kills_a_hung_world():
    """A rank that waits in a collective its peer skips does not hang the
    test run: the spawn's own deadline kills every rank and raises."""
    with pytest.raises(TimeoutError, match="did not finish in 8"):
        spawn(W.skip_collective, 2, timeout=8)
