"""Checkpoint and resume of the port (mcmc_ammsb_tpu_torch/checkpoint.py)
on the CPU: the contract of tests/test_checkpoint.py (run 20, save, run
15 equals restore, run 15, bit for bit) on every learner and sampling
mode, the manifest guards with the JAX package's messages, the layout
against the JAX package's, and a checkpoint written by the JAX package
read through interop.state_from_jax_checkpoint."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from mcmc_ammsb_tpu import checkpoint as jax_checkpoint
from mcmc_ammsb_tpu import learner as jax_learner
from mcmc_ammsb_tpu.data import DataSplit as JaxDataSplit
from mcmc_ammsb_tpu.data import Graph as JaxGraph
from mcmc_ammsb_tpu_torch import (chains, chains_flat, checkpoint, config,
                                  data, interop, learner)
from mcmc_ammsb_tpu_torch.models import mmsb

from torch_parity import assert_close, jax_config, require_native


@pytest.fixture(scope="module")
def dataset():
    n, u, v = data.synthetic_edges(250, 8, seed=17)
    split = data.generate_sets(n, u, v, heldout_ratio=0.1, seed=18)
    return n, split, data.Graph.from_edges(n, split.training_u,
                                           split.training_v)


def _cfg(dataset, **kw):
    n, split, graph = dataset
    return config.Config(K=8, mini_batch_size=8, num_node_sample=4,
                         **kw).finalize(n, split.total_edges,
                                        graph.max_fan_out)


FAST = dict(device_sampling=True, shared_neighbors=True, steps_per_call=10)
PALLAS = config.PhiImpl.PALLAS
REF = config.RngBackend.REFERENCE
# name -> (learner class or factory, config fields, extra constructor args)
CASES = {
    "learner-device-windowed": (learner.Learner, dict(FAST, window=4), ()),
    "learner-device-train-ppx": (learner.Learner,
                                 dict(FAST, window=4, calc_train_ppx=True),
                                 ()),
    "learner-device-phi-pallas": (learner.Learner,
                                  dict(device_sampling=True, phi_impl=PALLAS,
                                       steps_per_call=10), ()),
    "learner-host-scanned-numpy": (learner.Learner,
                                   dict(steps_per_call=5,
                                        host_sampler="numpy"), ()),
    "learner-host-scanned-native": (learner.Learner,
                                    dict(steps_per_call=5,
                                         host_sampler="native"), ()),
    "learner-host-step-at-a-time": (learner.Learner,
                                    dict(steps_per_call=1), ()),
    "learner-host-phi-pallas": (learner.Learner,
                                dict(steps_per_call=5, phi_impl=PALLAS), ()),
    "learner-host-step-phi-pallas": (learner.Learner,
                                     dict(steps_per_call=1, phi_impl=PALLAS),
                                     ()),
    "learner-host-no-prefetch": (
        lambda *a: learner.Learner(*a, prefetch=False),
        dict(steps_per_call=5, host_sampler="numpy"), ()),
    "learner-reference-rng": (learner.Learner,
                              dict(steps_per_call=5, rng_backend=REF), ()),
    "learner-reference-rng-step": (learner.Learner,
                                   dict(steps_per_call=1, rng_backend=REF,
                                        phi_impl=PALLAS), ()),
    "learner-reference-rng-device-bf": (
        learner.Learner, dict(device_sampling=True, rng_backend=REF,
                              strategy=config.SampleStrategy.BF_LINK,
                              steps_per_call=10), ()),
    "mmsb-device-windowed": (mmsb.FullMMSBLearner, dict(FAST, window=4), ()),
    "mmsb-host": (mmsb.FullMMSBLearner, dict(steps_per_call=5), ()),
    "mmsb-host-chunks-of-one": (mmsb.FullMMSBLearner,
                                dict(steps_per_call=1), ()),
    "flat-chains": (chains_flat.FlatChainLearner, dict(FAST, window=4),
                    (3,)),
    "mmsb-chains": (mmsb.MMSBChainLearner, FAST, (3,)),
    "multi-chains": (chains.MultiChainLearner, FAST, (3,)),
}


def _build(dataset, name):
    make, kw, extra = CASES[name]
    if kw.get("host_sampler") == "native":
        require_native()
    _, split, graph = dataset
    return make(_cfg(dataset, **kw), graph, split, *extra, "cpu")


def _leaves(lrn):
    return [leaf for s in checkpoint._states(lrn)
            for leaf in checkpoint.state_leaves(s)]


@pytest.mark.parametrize("name", list(CASES))
def test_bit_exact_resume(dataset, tmp_path, name):
    """Run 20, save, run 15 against a fresh learner, restore, run 15:
    every field of the state (pi, phi_sum, theta or theta_b, the running
    ppx averages, the host counters) and the next perplexity are equal
    bit for bit. Host-sampled cases run with the prefetch producer on
    (but one): the save drains its in-flight batches, the run consumes
    them first, the restored run finds them in the file."""
    path = str(tmp_path / "ck.npz")
    a = _build(dataset, name)
    a.heldout_perplexity()
    a.run(20)
    checkpoint.save_checkpoint(path, a)
    a.run(15)
    ppx_a = a.heldout_perplexity()
    a.close()

    b = _build(dataset, name)
    checkpoint.load_checkpoint(path, b)
    assert b.step_count == 21
    b.run(15)
    ppx_b = b.heldout_perplexity()
    b.close()
    np.testing.assert_array_equal(ppx_a, ppx_b)
    for x, y in zip(_leaves(a), _leaves(b)):
        np.testing.assert_array_equal(x, y)
    assert b.step_count == 36


def test_save_drains_pending_batches_and_restore_reads_them(dataset,
                                                            tmp_path):
    """With the producer running, a save leaves produced-but-unconsumed
    chunks in the learner's pending list and in the file, in production
    order, with the sampler's RNG state and call counter as they stand
    after them."""
    path = str(tmp_path / "ck.npz")
    a = _build(dataset, "learner-host-scanned-numpy")
    a.run(10)
    checkpoint.save_checkpoint(path, a)
    assert a._prefetcher is None and len(a._pending) >= 1
    b = _build(dataset, "learner-host-scanned-numpy")
    checkpoint.load_checkpoint(path, b)
    assert len(b._pending) == len(a._pending)
    for x, y in zip(a._pending, b._pending):
        for f in dataclasses.fields(x):
            np.testing.assert_array_equal(getattr(x, f.name),
                                          getattr(y, f.name))
    for x, y in zip(a.sampler.rng.get_state(), b.sampler.rng.get_state()):
        np.testing.assert_array_equal(x, y)
    assert a.sampler._native_call_count == b.sampler._native_call_count
    a.close()
    b.close()


def test_restore_copies_into_the_learners_buffers(dataset, tmp_path):
    """pi is updated in place: a restore writes into the learner's own
    buffer and aliases no host array."""
    path = str(tmp_path / "ck.npz")
    a = _build(dataset, "learner-device-windowed")
    a.run(10)
    checkpoint.save_checkpoint(path, a)
    b = _build(dataset, "learner-device-windowed")
    buffer = b.state.pi
    checkpoint.load_checkpoint(path, b)
    assert b.state.pi is buffer and b.state.pi.dtype == torch.float32
    assert torch.equal(b.state.pi, a.state.pi)
    assert isinstance(b.state.step_count, int) and b.state.step_count == 11


def test_checkpoint_rejects_geometry_mismatch(dataset, tmp_path):
    path = str(tmp_path / "ck.npz")
    a = _build(dataset, "learner-device-windowed")
    checkpoint.save_checkpoint(path, a)
    n, u, v = data.synthetic_edges(100, 6, seed=99)
    split = data.generate_sets(n, u, v, heldout_ratio=0.1, seed=100)
    graph = data.Graph.from_edges(n, split.training_u, split.training_v)
    other = learner.Learner(_cfg((n, split, graph), **FAST), graph, split,
                            "cpu")
    with pytest.raises(ValueError, match="checkpoint geometry mismatch"):
        checkpoint.load_checkpoint(path, other)


def test_checkpoint_rejects_chain_count_and_learner_class(dataset, tmp_path):
    """num_chains and the number of leaves, with the JAX package's
    messages; two learner classes whose states have as many fields are
    told apart by the class name."""
    _, split, graph = dataset
    path = str(tmp_path / "ck.npz")
    a = _build(dataset, "flat-chains")
    checkpoint.save_checkpoint(path, a)
    two = chains_flat.FlatChainLearner(_cfg(dataset, **FAST, window=4),
                                       graph, split, 2, "cpu")
    with pytest.raises(ValueError, match=r"num_chains 3 != 2"):
        checkpoint.load_checkpoint(path, two)
    with pytest.raises(ValueError, match=r"num_chains 3 != None"):
        checkpoint.load_checkpoint(path, _build(dataset, "mmsb-host"))
    with pytest.raises(ValueError, match="different learner class"):
        checkpoint.load_checkpoint(path, _build(dataset, "mmsb-chains"))
    single = str(tmp_path / "single.npz")
    checkpoint.save_checkpoint(single, _build(dataset,
                                              "learner-device-windowed"))
    with pytest.raises(ValueError, match=r"checkpoint has 11 state leaves, "
                       r"learner expects 8 \(different learner class or "
                       r"config: saved by Learner\)"):
        checkpoint.load_checkpoint(single,
                                   _build(dataset, "mmsb-device-windowed"))


def _rewrite_manifest(src, dst, **changes):
    z = np.load(src, allow_pickle=False)
    manifest = json.loads(bytes(z["manifest"]).decode())
    for k, v in changes.items():
        if v is None:
            manifest.pop(k)
        else:
            manifest[k] = v
    arrays = {k: z[k] for k in z.files if k != "manifest"}
    with open(dst, "wb") as f:
        np.savez(f, manifest=np.frombuffer(json.dumps(manifest).encode(),
                                           np.uint8), **arrays)


def test_checkpoint_rejects_format_version_and_device_kind(dataset, tmp_path):
    src, dst = str(tmp_path / "ck.npz"), str(tmp_path / "bad.npz")
    a = _build(dataset, "learner-device-windowed")
    checkpoint.save_checkpoint(src, a)
    _rewrite_manifest(src, dst, format_version=1)
    with pytest.raises(ValueError, match="checkpoint format 1 != 2"):
        checkpoint.load_checkpoint(dst, a)
    _rewrite_manifest(src, dst, stream_device="cuda")
    with pytest.raises(ValueError, match="saved on 'cuda'.*runs on 'cpu'"):
        checkpoint.load_checkpoint(dst, a)
    _rewrite_manifest(src, dst, stream_device=None)
    with pytest.raises(ValueError, match="state_from_jax_checkpoint"):
        checkpoint.load_checkpoint(dst, a)


def test_checkpoint_preserves_timers(dataset, tmp_path):
    path = str(tmp_path / "ck.npz")
    a = _build(dataset, "learner-device-windowed")
    a.run(5)
    checkpoint.save_checkpoint(path, a)
    b = _build(dataset, "learner-device-windowed")
    checkpoint.load_checkpoint(path, b)
    assert b.timers.seconds["total"] == a.timers.seconds["total"]
    assert b.timers.calls["device_step"] == a.timers.calls["device_step"]


def test_compressed_flavor_and_path_as_given(dataset, tmp_path):
    """np.savez_compressed (the JAX package's flavor) loads as well, and
    the path is used as given, without an appended .npz."""
    a = _build(dataset, "learner-device-windowed")
    a.run(5)
    plain, packed = str(tmp_path / "plain"), str(tmp_path / "packed")
    checkpoint.save_checkpoint(plain, a)
    checkpoint.save_checkpoint(packed, a, compress=True)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["packed", "plain"]
    for path in (plain, packed):
        b = _build(dataset, "learner-device-windowed")
        checkpoint.load_checkpoint(path, b)
        assert torch.equal(a.state.pi, b.state.pi)


def test_layout_matches_the_jax_package(dataset, tmp_path):
    """The manifest's config has exactly the keys of the JAX package's
    _config_to_json for the same Config and round-trips; the manifest has
    its keys plus the streams' device kind; the leaves are the fields of
    the port's TrainState, which are the JAX TrainState's without its
    four keys, in its order (an absent reference-RNG seeds field is one
    empty leaf)."""
    cfg = _cfg(dataset, **FAST, mmsb_prior_diag=(1.0, 5.0))
    mine = checkpoint._config_to_json(cfg)
    theirs = jax_checkpoint._config_to_json(jax_config(cfg))
    assert list(mine) == list(theirs) and mine == theirs
    assert checkpoint._config_from_json(json.loads(json.dumps(mine))) == cfg
    jax_fields = [f for f in jax_learner.TrainState._fields
                  if not f.endswith("_key")]
    assert list(learner.TrainState._fields) == jax_fields

    path = str(tmp_path / "ck.npz")
    a = _build(dataset, "learner-device-train-ppx")
    a.run(5)
    checkpoint.save_checkpoint(path, a)
    z = np.load(path, allow_pickle=False)
    manifest = json.loads(bytes(z["manifest"]).decode())
    assert set(manifest) == {
        "format_version", "config", "learner", "num_chains", "num_leaves",
        "timers", "timer_calls", "native_call_count", "stream_device"}
    assert manifest["num_leaves"] == len(learner.TrainState._fields) == 11
    for i, f in enumerate(learner.TrainState._fields):
        v = getattr(a.state, f)
        want = (v.numpy() if isinstance(v, torch.Tensor)
                else np.zeros(0, np.float32) if v is None else np.int32(v))
        np.testing.assert_array_equal(z[f"leaf_{i}"], want)
        assert z[f"leaf_{i}"].dtype == want.dtype
    assert {f"stream_0_{n}" for n in a.streams._fields} <= set(z.files)
    assert z["sampler_rng"].dtype == z["pending"].dtype == np.uint8


def test_jax_checkpoint_loads_through_interop(dataset, tmp_path):
    """A checkpoint that the JAX package wrote (its Learner, 12
    host-sampled steps and one evaluation on the CPU) loads into the
    port's TrainState: every array equal, the counters equal, and both
    packages give the same next held-out perplexity from it (rtol 1e-5)."""
    _check_jax_checkpoint(dataset, tmp_path, config.RngBackend.NATIVE)


def test_jax_reference_rng_checkpoint_loads_through_interop(dataset,
                                                            tmp_path):
    """The same with the reference RNG: the three seed arrays load from
    JAX's leaf positions, bit-equal."""
    _check_jax_checkpoint(dataset, tmp_path, REF)


def _check_jax_checkpoint(dataset, tmp_path, rng_backend):
    n, split, graph = dataset
    cfg = _cfg(dataset, steps_per_call=4, host_sampler="numpy",
               rng_backend=rng_backend)
    jcfg = jax_config(cfg)
    jsplit = JaxDataSplit(**dataclasses.asdict(split))
    jgraph = JaxGraph.from_edges(n, split.training_u, split.training_v)
    jl = jax_learner.Learner(jcfg, jgraph, jsplit, prefetch=False)
    jl.run(12)
    jl.heldout_perplexity()
    path = str(tmp_path / "jax.npz")
    jax_checkpoint.save_checkpoint(path, jl)

    state = interop.state_from_jax_checkpoint(path, cfg, "cpu")
    assert state.step_count == 13 and state.beta_count == 12
    assert state.ppx_count == 1 and state.train_ppx_count == 0
    for f in ("pi", "phi_sum", "theta", "beta", "ppx_per_edge"):
        np.testing.assert_array_equal(getattr(state, f).numpy(),
                                      np.asarray(getattr(jl.state, f)))
    if rng_backend == REF:
        for f in learner.RefRngState._fields:
            np.testing.assert_array_equal(
                getattr(state.ref_seeds, f).numpy(),
                np.asarray(getattr(jl.state.ref_seeds, f)))
    else:
        assert state.ref_seeds is None
    tl = learner.Learner(cfg, graph, split, "cpu", prefetch=False)
    tl.state = state
    assert_close(np.float32(tl.heldout_perplexity()),
                 np.float32(jl.heldout_perplexity()), 1e-5, 0.0, "ppx")
    assert tl.state.ppx_count == 2
    assert_close(tl.state.ppx_per_edge, jl.state.ppx_per_edge, 1e-5, 1e-7,
                 "running averages")

    # and the port's own loader says where such a file goes
    with pytest.raises(ValueError, match="state_from_jax_checkpoint"):
        checkpoint.load_checkpoint(path, tl)
    with pytest.raises(ValueError, match="pi has shape"):
        interop.state_from_jax_checkpoint(path, cfg.replace(K=4), "cpu")
    jl.close()
    tl.close()


# ---------------------------------------------------------------------------
# The directory backend (backend="orbax": a torch.distributed.checkpoint
# directory), the contract of tests/test_checkpoint.py:109-290
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_dir_bit_exact_resume(dataset, tmp_path, name):
    """test_bit_exact_resume through the directory backend on every
    learner: run 20, save, run 15 == restore (the directory is detected),
    run 15, bit for bit; the directory holds JAX's sidecars and the
    generators' states."""
    import os

    path = str(tmp_path / "ck_dir")
    a = _build(dataset, name)
    a.heldout_perplexity()
    a.run(20)
    checkpoint.save_checkpoint(path, a, backend="orbax")
    a.run(15)
    ppx_a = a.heldout_perplexity()
    a.close()
    assert sorted(os.listdir(path)) == ["manifest.json", "pending.pkl",
                                        "sampler_rng.pkl", "state",
                                        "streams.npz"]
    b = _build(dataset, name)
    checkpoint.load_checkpoint(path, b)
    assert b.step_count == 21
    assert b.timers.calls["device_step"] > 0
    b.run(15)
    ppx_b = b.heldout_perplexity()
    b.close()
    np.testing.assert_array_equal(ppx_a, ppx_b)
    for x, y in zip(_leaves(a), _leaves(b)):
        np.testing.assert_array_equal(x, y)


def _dir_learner(dataset):
    return _build(dataset, "learner-device-windowed")


def test_dir_overwrite_is_atomic(dataset, tmp_path):
    """Saving over a directory checkpoint replaces it whole, and no
    staging or parking directory stays behind."""
    import os

    path = str(tmp_path / "ck_dir")
    a = _dir_learner(dataset)
    checkpoint.save_checkpoint(path, a, backend="orbax")
    a.run(10)
    checkpoint.save_checkpoint(path, a, backend="orbax")
    b = _dir_learner(dataset)
    checkpoint.load_checkpoint(path, b)
    assert b.step_count == a.step_count == 11
    assert torch.equal(a.state.pi, b.state.pi)
    assert sorted(os.listdir(tmp_path)) == ["ck_dir"]


def test_dir_crash_mid_promote_recovers_from_parking_spot(dataset, tmp_path):
    """A crash between the promote's renames leaves the previous
    checkpoint at .orbax-old; load_checkpoint falls back to it."""
    import shutil

    path = str(tmp_path / "ck_dir")
    a = _dir_learner(dataset)
    a.run(10)
    checkpoint.save_checkpoint(path, a, backend="orbax")
    shutil.move(path, path + ".orbax-old")
    b = _dir_learner(dataset)
    checkpoint.load_checkpoint(path, b)
    assert b.step_count == a.step_count
    assert torch.equal(a.state.pi, b.state.pi)


def test_dir_async_save_is_a_snapshot(dataset, tmp_path):
    """async_save returns once the state is copied off the live tensors:
    training goes on, updating pi and phi_sum in place, while the save is
    in flight, and the finalized checkpoint holds the state at the save,
    from which the resumed run is bit-exact."""
    path = str(tmp_path / "ck_async")
    a = _dir_learner(dataset)
    a.run(10)
    checkpoint.save_checkpoint(path, a, backend="orbax", async_save=True)
    a.run(20)
    checkpoint.wait_for_async_saves()
    b = _dir_learner(dataset)
    checkpoint.load_checkpoint(path, b)
    assert b.step_count == 11
    b.run(20)
    for f in ("pi", "phi_sum", "theta", "beta"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f


def test_dir_async_save_finalized_by_load(dataset, tmp_path):
    """load_checkpoint finalizes an in-flight async save to its path."""
    path = str(tmp_path / "ck_async2")
    a = _dir_learner(dataset)
    a.run(5)
    checkpoint.save_checkpoint(path, a, backend="orbax", async_save=True)
    b = _dir_learner(dataset)
    checkpoint.load_checkpoint(path, b)
    assert b.step_count == 6
    assert not checkpoint._ASYNC_PENDING


@pytest.mark.parametrize("kw, match", [
    (dict(async_save=True), "orbax"),
    (dict(backend="hdf5"), "backend"),
])
def test_backend_arguments_raise(dataset, tmp_path, kw, match):
    """async_save needs the directory backend; an unknown backend
    raises."""
    a = _dir_learner(dataset)
    with pytest.raises(ValueError, match=match):
        checkpoint.save_checkpoint(str(tmp_path / "x"), a, **kw)


def test_npz_save_finalizes_pending_async_first(dataset, tmp_path):
    """A pending async save to a path is promoted before an npz save to
    the same path string proceeds, so its deferred promote can never
    rename the npz file away; a later directory save works again."""
    import os

    path = str(tmp_path / "ck")
    a = _dir_learner(dataset)
    a.run(5)
    checkpoint.save_checkpoint(path, a, backend="orbax", async_save=True)
    assert checkpoint._ASYNC_PENDING
    checkpoint.save_checkpoint(path + ".npz", a)
    checkpoint.save_checkpoint(path, a, backend="orbax")
    assert os.path.isdir(path) and not checkpoint._ASYNC_PENDING
    b = _dir_learner(dataset)
    checkpoint.load_checkpoint(path, b)
    assert b.step_count == 6


def test_dir_sharded_roundtrip(tmp_path):
    """Two gloo ranks on a (1, 2) mesh, pi's rows as DTensors sharded
    over 'model' so each rank writes and reads its own rows: run, save,
    run == restore, run, bit for bit, synchronously and asynchronously
    (training on before the finalize); the chain engine over a chain mesh
    of both ranks likewise."""
    from mcmc_ammsb_tpu_torch.parallel.dryrun import spawn

    import torch_dist_workers as W

    out = spawn(W.suite, 2, ([("dir", "dir_checkpoints",
                               (5, 1, 2, str(tmp_path)))],), timeout=150)
    for r in out:
        for mode in ("sync", "async"):
            a, b, step, listing = r["dir"][mode]
            assert step == 25 and a["step"] == b["step"] == 49
            assert listing == ["manifest.json", "pending.pkl",
                               "sampler_rng.pkl", "state", "streams.npz"]
            for f in ("pi", "phi", "theta", "beta"):
                np.testing.assert_array_equal(a[f], b[f])
        assert r["dir"]["chains"]
