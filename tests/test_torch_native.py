"""The port's binding of the native host library: its own build under a
name that carries the source's hash, never the JAX package's library, and
the same answers as the JAX package's binding of the same source."""

import os

import numpy as np
import pytest

from mcmc_ammsb_tpu import native as jax_native
from mcmc_ammsb_tpu_torch import config, native, sampling
from mcmc_ammsb_tpu_torch.data import Graph, generate_sets, synthetic_edges
from mcmc_ammsb_tpu_torch.types import pack_edges

from torch_parity import require_native


@pytest.fixture(autouse=True)
def _native_or_skip():
    require_native()


def test_library_is_the_ports_own():
    """Built from the port's own copy of csrc/sampler.cpp (byte-equal
    to the JAX package's source, another file) into build/torch_native/
    under a hashed name; the JAX package's build/libmcmc_sampler.so is
    another file; a second build is a no-op; no temporary file stays."""
    path = native.library_path()
    assert path.exists() and path == native.build()
    assert path.parent.name == "torch_native"
    assert path.name.startswith("libsampler_") and len(path.stem) == 23
    assert not os.path.samefile(native.SOURCE, jax_native._SRC)
    with open(native.SOURCE, "rb") as a, open(jax_native._SRC, "rb") as b:
        assert a.read() == b.read()
    assert os.path.abspath(jax_native._LIB_PATH) != str(path)
    assert not [f for f in os.listdir(path.parent) if f.endswith(".tmp")]
    assert native.build_error == ""


def test_failed_build_is_reported(monkeypatch, tmp_path):
    """A build that fails leaves ``available()`` false with the reason
    kept; host_sampler='native' then raises, 'auto' falls back to numpy."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "build_error", "")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "GXX_FLAGS", ("--no-such-flag",))
    assert not native.available()
    assert "g++ failed" in native.build_error
    assert not list(tmp_path.iterdir())
    with pytest.raises(RuntimeError, match="unavailable"):
        native.chd_build(np.zeros(1, np.int32), np.ones(1, np.int32), 2, 1, 1)
    n, u, v = synthetic_edges(100, 6, seed=1)
    split = generate_sets(n, u, v, 0.1)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = config.Config(mini_batch_size=4, num_node_sample=4).finalize(
        n, split.total_edges, graph.max_fan_out)
    with pytest.raises(RuntimeError, match="native sampler requested"):
        sampling.MiniBatchSampler(cfg.replace(host_sampler="native"), graph,
                                  split)
    assert not sampling.MiniBatchSampler(cfg, graph, split).use_native


@pytest.fixture(scope="module")
def edges():
    n, u, v = synthetic_edges(2000, 8, seed=4)
    return n, u.astype(np.int32), v.astype(np.int32)


@pytest.mark.parametrize("seed", [1, 0x9E3779BA])
def test_chd_build_equals_jax(edges, seed):
    _, u, v = edges
    m, nb = 1 << 14, 1 << 11
    got = native.chd_build(u, v, m, nb, seed)
    want = jax_native.chd_build(u, v, m, nb, seed)
    assert (got is None) == (want is None)
    if got is not None:
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert len(np.unique(got[1])) == len(u)      # a perfect hash


def test_chd_build_reports_a_failed_seed():
    """Two keys that can never be separated (the same pair twice) fail
    every displacement: None, not an error."""
    u = np.array([3, 3], np.int32)
    v = np.array([9, 9], np.int32)
    assert native.chd_build(u, v, 4, 1, 1) is None


@pytest.mark.parametrize("seed", [42, 43])
def test_cuckoo_try_equals_jax(edges, seed):
    _, u, v = edges
    keys = pack_edges(u, v).astype(np.uint64)
    bins = int(1 + np.ceil(1.15 * len(keys) / 8))
    got = native.cuckoo_try(keys, bins, seed)
    want = jax_native.cuckoo_try(keys, bins, seed)
    assert got.tobytes() == want.tobytes()
    stored = got[got != np.uint64(0xFFFFFFFFFFFFFFFF)]
    assert sorted(stored.tolist()) == sorted(keys.tolist())
    assert native.cuckoo_try(keys, 3, seed) is None  # too small a table


@pytest.mark.parametrize("strategy", list(native.STRATEGY_CODES))
def test_sample_batches_equals_jax(edges, strategy):
    n, u, v = edges
    split = generate_sets(n, u, v, 0.1, seed=5)
    g = Graph.from_edges(n, split.training_u, split.training_v)
    held = np.sort(pack_edges(split.heldout_u, split.heldout_v))
    args = (g.offsets, g.cols, n, held, strategy, 16, float(n),
            float(split.total_edges), 12, max(16, g.max_fan_out),
            max(32, g.max_fan_out + 1), 0x1234567)
    got = native.sample_batches(*args)
    want = jax_native.sample_batches(*args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert got[2].any(axis=1).all()                 # every batch has edges


def test_sample_batches_reports_capacity():
    n, u, v = synthetic_edges(200, 10, seed=2)
    g = Graph.from_edges(n, u, v)
    with pytest.raises(RuntimeError, match="capacity"):
        native.sample_batches(g.offsets, g.cols, n, np.zeros(0, np.uint64),
                              "NodeLink", 4, float(n), float(len(u)), 50, 2,
                              3, 1)


def test_snap_parse_equals_jax(tmp_path):
    path = tmp_path / "g.txt"
    path.write_text("# c\n3\t9\n9\t3\n4 4\n12\t1\n")
    got, want = native.snap_parse(str(path)), jax_native.snap_parse(str(path))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[0].tolist() == [3, 3, 1] and got[1].tolist() == [9, 9, 12]
    with pytest.raises(IOError):
        native.snap_parse(str(tmp_path / "missing.txt"))
