"""A run carried from the JAX package into the port: the committed
JAX-written checkpoints (tests/fixtures/jax_ckpt/, made by
tests/jax_fixtures.py) are what the JAX package writes today, and the
port's ``--restore`` continues them on the CPU as closely as the two
packages can match:

  * the state and the counters bit-equal at the restore;
  * ``--rng reference``: 10 continued steps match JAX's 10 (state
    normwise rtol 5e-5, atol 1e-8; the next perplexity rtol 1e-5, the
    contract of test_torch_rng_reference.py), through the API and
    through the CLI against the sidecar's digest;
  * host sampling: the next 3 chunks of minibatches are JAX's, bit for
    bit (the pending chunk in the file, then the restored sampler's),
    and the torch streams are re-seeded with one log line;
  * the blobs are read by the allow-list unpickler: a class outside it
    and a JAX orbax directory are refused with their reason (the CLI
    exits 1).

The other engines' files: test_torch_jax_restore_engines.py and
test_torch_jax_restore_sharded.py."""

import collections
import dataclasses
import json
import os
import pickle
import re

import numpy as np
import pytest

import jax_fixtures as F
import torch_dist_workers as W
from mcmc_ammsb_tpu import checkpoint as jax_checkpoint
from mcmc_ammsb_tpu import config as jax_config
from mcmc_ammsb_tpu import sampling as jax_sampling
from mcmc_ammsb_tpu_torch import (checkpoint, cli, learner, rng, sampling,
                                  testing)
from torch_parity import assert_normwise

RTOL, ATOL, PPX_RTOL = 5e-5, 1e-8, 1e-5


def _fixture(name):
    path = os.path.join(F.FIXTURE_DIR, name + ".npz")
    with open(os.path.join(F.FIXTURE_DIR, name + ".json")) as f:
        return path, json.load(f)


def _npz(path) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", list(F.FIXTURES))
def test_committed_fixture_is_what_the_jax_package_writes(name, tmp_path):
    """Regenerate the fixture with the JAX package: every leaf, the
    manifest (but its timers), the sampler state, the pending batches
    and the sidecar equal the committed ones, so a JAX version that
    changes them fails here instead of drifting."""
    F.write(name, str(tmp_path))
    path, side = _fixture(name)
    new, old = _npz(str(tmp_path / (name + ".npz"))), _npz(path)
    assert sorted(new) == sorted(old)
    for key in new:
        if key.startswith("leaf_"):
            assert new[key].dtype == old[key].dtype, key
            np.testing.assert_array_equal(new[key], old[key], err_msg=key)
    manifests = [json.loads(bytes(z["manifest"]).decode()) for z in (new,
                                                                      old)]
    for m in manifests:
        m.pop("timers")
    assert manifests[0] == manifests[1]
    for blob in ("sampler_rng", "pending"):
        assert F.same_values(checkpoint._loads(bytes(new[blob])),
                     checkpoint._loads(bytes(old[blob]))), blob
    with open(tmp_path / (name + ".json")) as f:
        assert json.load(f) == side


def _ppx_lines(messages) -> dict:
    return {m.group(1): float(m.group(2)) for m in (
        re.fullmatch(r"ppx\[(\d+)\] = (\S+)", msg) for msg in messages) if m}


@pytest.mark.parametrize("name", list(F.FIXTURES))
def test_fixture_continues_through_the_cli(name, tmp_path, monkeypatch,
                                           caplog):
    """``cli.main(argv + ["--restore", fixture])`` on the CPU with the
    fixture's own arguments: restored at step 11, ppx[0] (an evaluation
    of the restored state) JAX's within rtol 1e-5, the first minibatch
    trained on the sidecar's, bit for bit. With the reference RNG the
    continuation is JAX's (ppx[10] rtol 1e-5, the digest of pi, theta
    and phi_sum within the normwise contract) and nothing is re-seeded;
    with the native RNG the torch streams are re-seeded, once."""
    path, side = _fixture(name)
    chunks = []
    scan = learner.Learner._scan_chunk

    def keep(self, state, batches):
        chunks.append(batches)
        return scan(self, state, batches)

    monkeypatch.setattr(learner.Learner, "_scan_chunk", keep)
    out = str(tmp_path / "continued.npz")
    with caplog.at_level("INFO", logger="mcmc_ammsb_tpu_torch"):
        rc = cli.main(side["argv"] + ["--restore", path, "--device", "cpu",
                                      "--checkpoint", out])
    assert rc == 0
    messages = [r.getMessage() for r in caplog.records]
    assert f"restored checkpoint {path} (step=11)" in messages
    ppx = _ppx_lines(messages)
    np.testing.assert_allclose(ppx["0"], side["ppx"]["0"], rtol=PPX_RTOL)
    for f, want in side["first_minibatch"].items():
        np.testing.assert_array_equal(getattr(chunks[0], f)[0].numpy(),
                                      np.asarray(want), err_msg=f)
    reseeded = [m for m in messages if "re-seeded" in m]
    if "reference" in side["argv"]:
        assert reseeded == []
        np.testing.assert_allclose(ppx["10"], side["ppx"]["10"],
                                   rtol=PPX_RTOL)
        z = _npz(out)
        got = testing.digest({"pi": z["leaf_0"], "theta": z["leaf_2"],
                              "phi_sum": z["leaf_1"]})
        assert testing.digest_misses(got, side["digest"], RTOL, ATOL) == []
    else:
        assert reseeded == ["random streams re-seeded at step 11 "
                            "(checkpoint written by jax)"]
        assert np.isfinite(ppx["10"])


def test_reference_rng_continues_jax_through_the_api():
    """The reference fixture restored into the port's Learner and into
    JAX's: every state leaf bit-equal at the restore; after 10 steps of
    each, pi, phi_sum, theta and beta normwise rtol 5e-5, atol 1e-8, the
    seeds exact, the next perplexity rtol 1e-5."""
    path, side = _fixture("learner_reference")
    jl = F.jax_cli_learner(side["argv"])
    jax_checkpoint.load_checkpoint(path, jl)
    tl = W.cli_learner(side["argv"])
    checkpoint.load_checkpoint(path, tl)
    F.assert_state_is_the_file(path, F.named_leaves(tl.state))
    jl.run(10)
    tl.run(10)
    for f in ("pi", "phi_sum", "theta", "beta"):
        assert_normwise(getattr(tl.state, f),
                        np.asarray(getattr(jl.state, f)), RTOL, ATOL, f)
    for f in learner.RefRngState._fields:
        np.testing.assert_array_equal(
            getattr(tl.state.ref_seeds, f).numpy(),
            np.asarray(getattr(jl.state.ref_seeds, f)).astype(np.int64))
    assert tl.step_count == int(jl.state.step_count) == 21
    np.testing.assert_allclose(tl.heldout_perplexity(),
                               jl.heldout_perplexity(), rtol=PPX_RTOL)
    jl.close()
    tl.close()


@pytest.fixture(scope="module")
def jax_host(tmp_path_factory):
    """The JAX learner restored from the host fixture, once for the
    module: its next 3 chunks of minibatches (the pending chunk the file
    holds, then two from the restored RandomState) and the same state
    saved as a JAX orbax directory."""
    path, side = _fixture("learner_host")
    jl = F.jax_cli_learner(side["argv"])
    jax_checkpoint.load_checkpoint(path, jl)
    ck = str(tmp_path_factory.mktemp("jax_orbax") / "jax_dir")
    jax_checkpoint.save_checkpoint(ck, jl, backend="orbax")
    spc = jl.cfg.steps_per_call
    chunks = [jl._pending[0], jl.sampler.sample_many(spc),
              jl.sampler.sample_many(spc)]
    jl.close()
    return {"chunks": chunks, "steps_per_call": spc, "orbax": ck}


def test_host_sampling_continues_jax_batches(jax_host, monkeypatch):
    """The host fixture: the port's next 3 chunks (30 minibatches) are
    the JAX learner's, bit for bit: the pending chunk the file holds,
    then two from the restored RandomState."""
    path, side = _fixture("learner_host")
    want, spc = jax_host["chunks"], jax_host["steps_per_call"]
    tl = W.cli_learner(side["argv"])
    checkpoint.load_checkpoint(path, tl)
    assert tl.cfg.steps_per_call == spc
    chunks = []
    scan = tl._scan_chunk
    monkeypatch.setattr(tl, "_scan_chunk", lambda state, batches: (
        chunks.append(batches), scan(state, batches))[1])
    tl.run(3 * spc)
    tl.close()
    assert len(chunks) == 3
    for got, w in zip(chunks, want):
        for f in F.BATCH_FIELDS:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(w, f)),
                                          err_msg=f)


#: the stream seeds of the restored host run's continuations
NOISE_SEEDS = range(16)
#: the margin on each side of the continuations' ppx[10] range: half the
#: range's width (fixed before any continuation was read)
NOISE_MARGIN = 0.5


def test_restored_native_run_noise_holds_jax():
    """The host fixture continued 10 steps in the port under each of 16
    fixed stream seeds (the torch streams re-seeded after the restore;
    the batches are the file's sampler's): JAX's ppx[10] (the sidecar's)
    lies within the continuations' range widened by NOISE_MARGIN of its
    width on each side. A restored native-RNG run carries JAX's state
    exactly but not its noise, so it matches JAX's only in
    distribution; this holds it there."""
    path, side = _fixture("learner_host")
    ends = []
    for s in NOISE_SEEDS:
        tl = W.cli_learner(side["argv"])
        checkpoint.load_checkpoint(path, tl)
        rng.seed_streams(tl.streams, rng.Streams(
            phi=(1000 + s, 1), beta=(2000 + s, 1), neighbor=(3000 + s, 1),
            sample=(4000 + s, 1)), tl.step_count)
        np.testing.assert_allclose(tl.heldout_perplexity(),
                                   side["ppx"]["0"], rtol=PPX_RTOL)
        tl.run(side["steps"])
        ends.append(tl.heldout_perplexity())
        tl.close()
    lo, hi = min(ends), max(ends)
    assert hi > lo, ends
    margin = NOISE_MARGIN * (hi - lo)
    assert lo - margin <= side["ppx"]["10"] <= hi + margin, (
        side["ppx"]["10"], sorted(ends))


def test_batch_classes_have_the_same_fields():
    """The unpickler maps the JAX package's batch classes onto the
    port's: their fields must stay the same."""
    for name in ("MiniBatch", "StackedBatches"):
        ours = [(f.name, f.type) for f in dataclasses.fields(
            getattr(sampling, name))]
        theirs = [(f.name, f.type) for f in dataclasses.fields(
            getattr(jax_sampling, name))]
        assert ours == theirs, name


def _rewrite(src, dst, **arrays):
    z = _npz(src)
    z.update(arrays)
    with open(dst, "wb") as f:
        np.savez(f, **z)


class Evil:
    def __reduce__(self):
        return (os.getcwd, ())


@pytest.mark.parametrize("blob, payload, named", [
    ("pending", [Evil()], "getcwd"),
    ("sampler_rng", collections.OrderedDict(a=1), "collections.OrderedDict"),
    ("pending", [jax_config.SampleStrategy.NODE],
     "mcmc_ammsb_tpu.config.SampleStrategy"),
])
def test_blob_outside_the_allow_list_is_refused(blob, payload, named,
                                                tmp_path, caplog):
    """A pending or sampler blob that names a class outside the
    allow-list (a function, another container class, a class of the JAX
    package that is not a batch) is refused with the class named, by the
    loader and by the CLI, which exits 1."""
    path, side = _fixture("learner_host")
    bad = str(tmp_path / "bad.npz")
    _rewrite(path, bad, **{blob: np.frombuffer(pickle.dumps(payload),
                                               np.uint8)})
    with pytest.raises(ValueError, match=re.escape(named)):
        checkpoint._loads(pickle.dumps(payload))
    with caplog.at_level("INFO", logger="mcmc_ammsb_tpu_torch"):
        assert cli.main(side["argv"] + ["--restore", bad, "--device", "cpu",
                                        "-x", "0"]) == 1
    assert any(f"--restore {bad}:" in r.getMessage() and named
               in r.getMessage() for r in caplog.records)


def test_jax_orbax_directory_is_refused(jax_host, caplog):
    """A JAX orbax directory: the loader and the CLI refuse it with the
    reason (no orbax in the port)."""
    _, side = _fixture("learner_host")
    ck = jax_host["orbax"]
    tl = W.cli_learner(side["argv"])
    with pytest.raises(ValueError, match="JAX package's orbax directory"):
        checkpoint.load_checkpoint(ck, tl)
    tl.close()
    with caplog.at_level("INFO", logger="mcmc_ammsb_tpu_torch"):
        assert cli.main(side["argv"] + ["--restore", ck, "--device", "cpu",
                                        "-x", "0"]) == 1
    assert any("orbax" in r.getMessage() and "--restore" in r.getMessage()
               for r in caplog.records)
