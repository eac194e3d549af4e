"""Checkpoint / resume (counterpart of ``mcmc_ammsb_tpu/checkpoint.py``).

Two backends, as in the JAX package: ``npz`` (the default, one file)
and the directory backend (``backend="orbax"``, the JAX flag value, so
the same command lines run; see "The directory backend" below).

An npz checkpoint is one file in the JAX package's layout: the state's
fields in field order as ``leaf_i`` arrays (the host counters as int32
scalars), a JSON ``manifest`` (format version, config, learner class,
number of chains and leaves, timers, the native sampler's call counter),
the host sampler's numpy RNG state (``sampler_rng``) and the
produced-but-unconsumed prefetched batches (``pending``), both pickled
into uint8 arrays, so the file is read with ``allow_pickle=False``.

The JAX package's random streams are keys inside its state. The port's
are stateful ``torch.Generator``s, so the file also holds the state of
every generator of ``rng.Streams`` (``stream_<c>_<name>``; C sets for
``chains.MultiChainLearner``) and the manifest the device kind they were
saved from: a CPU generator's state does not fit a CUDA generator.

Every learner of the port is taken: ``Learner``, ``FullMMSBLearner``,
``FlatChainLearner``, ``MMSBChainLearner`` and ``MultiChainLearner``
(whose state is the list ``states``: its leaves are the chains' in turn),
and the multi-GPU ``parallel.ShardedLearner`` and
``parallel.ShardedChainLearner``. Their state is split across ranks
(``shard_layout``): every rank joins the save, rank 0 writes the GLOBAL
state in the single-GPU layout (pi [N_pad, K], the running averages of
the whole population, the C chains' fields), every rank's generators as
``stream_<rank>_<name>`` and the mesh in the manifest, and a barrier
follows the write; on load each rank reads only its own rows of the
split fields (an uncompressed member is read from its offset) and its
own generators. The file must be loaded on a world of the same size and
mesh.

Resume is bit-exact under this contract: run n steps, save, run m steps
equals restore, run m steps, with the same ``steps_per_call``. A chunk
draws its steps in one block per stream (``learner`` module docstring),
so ``run(n + m)`` in one call is another trajectory when a chunk would
straddle step n; the trajectory depends on where the run calls end, not
on whether a checkpoint was taken there.

The file is written with ``np.savez`` (uncompressed: pi is noise-like
float32 data, which zlib shrinks by about a tenth for seconds of host
time; PERF.md has the measurement) through a temporary file that is
renamed into place, so an interrupted save leaves the previous
checkpoint whole. ``np.load`` reads either flavor, and the path is used
as given (no ``.npz`` is appended). bfloat16 pi rows are stored as
float32, losslessly, and cast back on load, as in the JAX package.

The directory backend writes a ``torch.distributed.checkpoint`` (DCP)
directory where the JAX package writes an orbax one: the port cannot
load JAX's orbax directories and JAX cannot load the port's; the npz
files stay the format the two packages share. The layout and the
discipline are JAX's ``_save_orbax`` / ``_load_orbax``:

  <path>/state/          the state's leaves (DCP), ``leaf_i`` as in the
                         npz file, the host counters as 0-d int64
                         tensors, empty leaves left out;
  <path>/manifest.json, sampler_rng.pkl, pending.pkl
                         the npz file's host state;
  <path>/streams.npz     the generators' states (``stream_<c>_<name>``,
                         or ``stream_<rank>_<name>`` on a sharded learner).

Everything is written to ``<path>.orbax-tmp`` first; rank 0 alone writes
the sidecars, parks the previous checkpoint at ``<path>.orbax-old``,
renames the new one into place and removes the old one, with barriers
around these steps; a load falls back to ``.orbax-old`` when a promote
was cut between its renames. On the sharded learners the split fields
are DTensors on the learner's ``DeviceMesh`` (``dtensor_layout``), so
each rank writes and reads only its own rows; DCP's planning runs on a
gloo group of its own (DCP needs a CPU-capable group beside NCCL, and an
async save's planning thread must not share a group with training).

``async_save=True`` returns once the state is copied off the live
tensors (pi and phi_sum are updated in place by the next steps): the
leaves are cloned on their device, then DCP stages and writes them on a
background thread. The finalize (wait for the write, sidecars, promote)
runs at the next save or load of that path, at ``wait_for_async_saves``
(the CLI calls it at its end) or at interpreter exit.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import json
import os
import pickle
import shutil
import warnings
import zipfile
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from mcmc_ammsb_tpu_torch.config import (Config, EdgeSetBackend, PhiImpl,
                                         RngBackend, SampleStrategy)

_FORMAT_VERSION = 2  # the JAX package's npz layout version


def _config_to_json(cfg: Config) -> dict:
    d = dataclasses.asdict(cfg)
    d["strategy"] = cfg.strategy.value
    d["phi_impl"] = cfg.phi_impl.value
    d["edgeset_backend"] = cfg.edgeset_backend.value
    d["rng_backend"] = cfg.rng_backend.value
    return d


def _config_from_json(d: dict) -> Config:
    d = dict(d)
    d["strategy"] = SampleStrategy.parse(d["strategy"])
    d["phi_impl"] = PhiImpl(d["phi_impl"])
    d["edgeset_backend"] = EdgeSetBackend(d["edgeset_backend"])
    d["rng_backend"] = RngBackend(d["rng_backend"])
    for f in ("phi_seed", "beta_seed", "neighbor_seed", "mmsb_prior_diag"):
        if isinstance(d.get(f), list):
            d[f] = tuple(d[f])
    return Config(**d)


def _num_chains(learner):
    """The chain count a checkpoint records: all C chains of a sharded
    chain engine, not one rank's."""
    return getattr(learner, "total_chains",
                   getattr(learner, "num_chains", None))


def _states(learner) -> list:
    """The learner's state(s): ``states`` of the independent-states
    chain engine, else the one ``state``."""
    states = getattr(learner, "states", None)
    return list(states) if states is not None else [learner.state]


def _streams(learner) -> list:
    sets = getattr(learner, "chain_streams", None)
    return list(sets) if sets is not None else [learner.streams]


def _leaf(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            # npz holds numpy dtypes only: bf16 pi rows are stored as
            # float32, which is lossless (the load casts them back)
            v = v.float()
        return v.detach().cpu().numpy()
    if v is None:
        return np.zeros(0, np.float32)
    return np.asarray(int(v), np.int32)


def state_leaves(state) -> List[np.ndarray]:
    """The state's fields in field order as host arrays: tensors copied
    to the host, the host counters as int32 scalars, an absent optional
    field as an empty float32 array, and a field that is itself a tuple
    of tensors (the reference RNG's ``RefRngState``) as its tensors in
    turn, as the JAX package flattens it."""
    leaves = []
    for v in state:
        if isinstance(v, tuple):
            leaves.extend(_leaf(x) for x in v)
        else:
            leaves.append(_leaf(v))
    return leaves


def _leaf_count(state) -> int:
    return sum(len(v) if isinstance(v, tuple) else 1 for v in state)


def _collect_host_state(learner, num_leaves: int):
    """Manifest + host-sampler position."""
    pending = (learner.drain_sampling()
               if hasattr(learner, "drain_sampling") else [])
    sampler = getattr(learner, "sampler", None)
    manifest = {
        "format_version": _FORMAT_VERSION,
        "config": _config_to_json(learner.cfg),
        "learner": type(learner).__name__,
        "num_chains": _num_chains(learner),
        "num_leaves": num_leaves,
        "timers": {k: v for k, v in learner.timers.seconds.items()},
        "timer_calls": {k: v for k, v in learner.timers.calls.items()},
        "native_call_count": getattr(sampler, "_native_call_count", 0),
        "stream_device": learner.device.type,
    }
    sampler_rng = pickle.dumps(
        sampler.rng.get_state() if sampler is not None else None)
    return manifest, sampler_rng, pickle.dumps(pending)


def _num_leaves(learner) -> int:
    return sum(_leaf_count(s) for s in _states(learner))


def _check_manifest(manifest: dict, learner) -> None:
    if manifest["format_version"] != _FORMAT_VERSION:
        raise ValueError(
            f"checkpoint format {manifest['format_version']} != "
            f"{_FORMAT_VERSION}: the state leaf layout changed (v2 added "
            "the reference-backend neighbor RNG stream); re-train or "
            "migrate the checkpoint")
    if "stream_device" not in manifest:
        raise ValueError(
            "checkpoint holds no random-stream states (written by the JAX "
            "package?): load it with interop.state_from_jax_checkpoint")
    saved_cfg = _config_from_json(manifest["config"])
    if saved_cfg.K != learner.cfg.K or saved_cfg.N != learner.cfg.N:
        raise ValueError("checkpoint geometry mismatch")
    saved_chains = manifest.get("num_chains")
    if saved_chains != _num_chains(learner):
        raise ValueError(
            f"checkpoint geometry mismatch: num_chains {saved_chains} "
            f"!= {_num_chains(learner)}")
    expected = _num_leaves(learner)
    if manifest["num_leaves"] != expected:
        raise ValueError(
            f"checkpoint has {manifest['num_leaves']} state leaves, "
            f"learner expects {expected} (different learner "
            f"class or config: saved by {manifest.get('learner')})")
    if manifest.get("learner") != type(learner).__name__:
        # two of the port's states have the same number of fields
        raise ValueError(
            f"checkpoint was saved by {manifest.get('learner')}, this "
            f"learner is a {type(learner).__name__} (different learner "
            "class)")
    if manifest["stream_device"] != learner.device.type:
        raise ValueError(
            f"checkpoint streams were saved on "
            f"{manifest['stream_device']!r}, this learner runs on "
            f"{learner.device.type!r}: a generator's state does not move "
            "between device kinds")
    mesh = getattr(getattr(learner, "mesh", None), "shape", None)
    if manifest.get("mesh") != mesh:
        raise ValueError(f"checkpoint was saved on the mesh "
                         f"{manifest.get('mesh')}, this learner runs on "
                         f"{mesh}")


def _apply_host_state(learner, manifest: dict, sampler_rng_blob: bytes,
                      pending_blob) -> None:
    if hasattr(learner, "drain_sampling"):
        # a producer already running would draw from the sampler's RNG
        # while it is restored
        learner.drain_sampling()
    sampler = getattr(learner, "sampler", None)
    sampler_rng = pickle.loads(sampler_rng_blob)
    if sampler is not None and sampler_rng is not None:
        sampler.rng.set_state(sampler_rng)
        sampler._native_call_count = int(
            manifest.get("native_call_count", 0))
    if pending_blob is not None and hasattr(learner, "_pending"):
        learner._pending = pickle.loads(pending_blob)
    for k, v in manifest.get("timers", {}).items():
        learner.timers.seconds[k] = v
    for k, v in manifest.get("timer_calls", {}).items():
        learner.timers.calls[k] = v


def save_checkpoint(path: str, learner, compress: bool = False,
                    backend: str = "npz", async_save: bool = False) -> None:
    """Full-fidelity checkpoint: state + config + every random stream +
    the complete host-sampling position (the numpy RNG state, the native
    sampler's chunk counter and the produced-but-unconsumed prefetched
    batches). The prefetch producer is stopped; the next ``run`` consumes
    the drained batches first and restarts it. Waits for the device
    before it reads the state. ``compress`` writes the JAX package's
    ``np.savez_compressed`` flavor. ``backend="orbax"`` writes the DCP
    directory (module docstring), asynchronously with ``async_save``. A
    sharded learner's save is collective: every rank of its mesh calls
    it."""
    if backend == "orbax":
        return _save_dir(path, learner, async_save)
    if async_save:
        raise ValueError("async_save requires backend='orbax'")
    if backend != "npz":
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    # an in-flight async directory save to this path must land first, or
    # its deferred promote would later rename this file away
    wait_for_async_saves(path)
    if learner.device.type == "cuda":
        torch.cuda.synchronize(learner.device)
    if hasattr(learner, "shard_layout"):
        return _save_sharded(path, learner, compress)
    leaves = [leaf for s in _states(learner) for leaf in state_leaves(s)]
    manifest, sampler_rng, pending_blob = _collect_host_state(
        learner, len(leaves))
    arrays = {f"leaf_{i}": leaf for i, leaf in enumerate(leaves)}
    arrays.update(_stream_arrays(learner))
    _write(path, manifest, sampler_rng, pending_blob, arrays, compress)


def _stream_arrays(learner) -> dict:
    """The generators' states as host arrays: ``stream_<c>_<name>`` for
    each set of ``rng.Streams``, or on a sharded learner every rank's
    ``stream_<rank>_<name>`` (collective: gathered to every rank)."""
    if hasattr(learner, "shard_layout"):
        gens = {name: gen.get_state().numpy()
                for name, gen in learner.stream_generators().items()}
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, gens)
        return {f"stream_{r}_{name}": st for r, per_rank in enumerate(every)
                for name, st in per_rank.items()}
    return {f"stream_{c}_{name}": gen.get_state().numpy()
            for c, streams in enumerate(_streams(learner))
            for name, gen in zip(streams._fields, streams)}


def _write(path, manifest, sampler_rng, pending_blob, arrays, compress):
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        (np.savez_compressed if compress else np.savez)(
            f,
            manifest=np.frombuffer(json.dumps(manifest).encode(), np.uint8),
            sampler_rng=np.frombuffer(sampler_rng, np.uint8),
            pending=np.frombuffer(pending_blob, np.uint8),
            **arrays)
    os.replace(tmp, path)


def _gather_field(x: torch.Tensor, group) -> torch.Tensor:
    """The global field: ``x`` of every rank of ``group`` concatenated on
    dim 0 in group order (an empty field stays empty). bf16 pi rows
    travel as float32, losslessly."""
    if x.numel() == 0:
        return x
    if x.dtype == torch.bfloat16:
        x = x.float()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],
                       *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _save_sharded(path: str, learner, compress: bool) -> None:
    """Every rank: gather the split fields and the generator states;
    rank 0: write the file; then a barrier, so no rank reads a file that
    is not there yet."""
    state = learner.state
    full = {name: _gather_field(getattr(state, name), group)
            for name, (group, _) in learner.shard_layout().items()}
    streams = _stream_arrays(learner)
    manifest, sampler_rng, pending_blob = _collect_host_state(
        learner, _num_leaves(learner))
    if dist.get_rank() == 0:
        manifest["world_size"] = dist.get_world_size()
        manifest["mesh"] = learner.mesh.shape
        leaves = state_leaves(state._replace(**full))
        arrays = {f"leaf_{i}": leaf for i, leaf in enumerate(leaves)}
        arrays.update(streams)
        _write(path, manifest, sampler_rng, pending_blob, arrays, compress)
    dist.barrier()


def _npz_rows(path: str, key: str, lo: int, hi: int) -> np.ndarray:
    """Rows [lo, hi) of the array ``key`` of an npz file, read from their
    offset in the member (a compressed member is inflated up to there)."""
    with zipfile.ZipFile(path) as zf, zf.open(key + ".npy") as f:
        version = np.lib.format.read_magic(f)
        read_header = (np.lib.format.read_array_header_1_0 if version[0] == 1
                       else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read_header(f)
        if fortran:
            raise ValueError(f"{key}: a Fortran-ordered array")
        row = int(np.prod(shape[1:], dtype=np.int64)) * dtype.itemsize
        f.seek(f.tell() + lo * row)
        buf = bytearray(f.read((hi - lo) * row))     # writable
    return np.frombuffer(buf, dtype).reshape(hi - lo, *shape[1:])


def _check_world(manifest: dict) -> None:
    if manifest.get("world_size") != dist.get_world_size():
        raise ValueError(f"checkpoint was saved by "
                         f"{manifest.get('world_size')} ranks, this run "
                         f"has {dist.get_world_size()}")


def _load_sharded(path: str, z, manifest: dict, learner) -> None:
    _check_world(manifest)
    layout = learner.shard_layout()
    fields = {}
    for i, (name, old) in enumerate(zip(learner.state._fields,
                                        learner.state)):
        key = f"leaf_{i}"
        if isinstance(old, torch.Tensor):
            if name in layout and old.numel():
                n = old.shape[0]
                at = layout[name][1] * n
                leaf = _npz_rows(path, key, at, at + n)
            else:
                leaf = z[key]
            fields[name] = _restore_tensor(name, old, leaf)
        elif old is None:
            fields[name] = None
        else:
            fields[name] = int(z[key])
    learner.state = type(learner.state)(**fields)
    _set_streams(learner, z)


def _set_streams(learner, arrays) -> None:
    """Restore the generators from ``_stream_arrays``' keys."""
    if hasattr(learner, "shard_layout"):
        rank = dist.get_rank()
        for name, gen in learner.stream_generators().items():
            gen.set_state(torch.from_numpy(
                arrays[f"stream_{rank}_{name}"].copy()))
        return
    for c, streams in enumerate(_streams(learner)):
        for name, gen in zip(streams._fields, streams):
            gen.set_state(torch.from_numpy(arrays[f"stream_{c}_{name}"].copy()))


def _restore_tensor(name, old, leaf):
    if tuple(old.shape) != tuple(leaf.shape):
        raise ValueError(
            f"checkpoint geometry mismatch: {name} has shape "
            f"{tuple(leaf.shape)}, the learner's {tuple(old.shape)}")
    old.copy_(torch.from_numpy(np.ascontiguousarray(leaf)))
    return old


def _restore_state(ref, leaves):
    """``ref`` with the leaves' values: tensors are copied INTO ref's
    buffers (their device, their dtype; never an alias of a host array),
    the counters become host ints, a tuple field takes one leaf per
    tensor."""
    fields, at = {}, 0
    for name, old in zip(ref._fields, ref):
        if isinstance(old, tuple):
            fields[name] = type(old)(*(
                _restore_tensor(f"{name}.{sub}", x, leaves[at + i])
                for i, (sub, x) in enumerate(zip(old._fields, old))))
            at += len(old)
            continue
        leaf = leaves[at]
        at += 1
        if isinstance(old, torch.Tensor):
            fields[name] = _restore_tensor(name, old, leaf)
        elif old is None:
            fields[name] = None
        else:
            fields[name] = int(leaf)
    return type(ref)(**fields)


def load_checkpoint(path: str, learner):
    """Restore state into an already-constructed learner of the same
    class on the same dataset and device kind; the graph, split and edge
    sets are rebuilt from data. Raises ValueError on a mismatch of format
    version, K or N, number of chains, learner class or device kind. A
    directory is the DCP backend's; a path missing beside an
    ``.orbax-old`` directory (a promote cut between its renames) loads
    that one. An in-flight async save to ``path`` is finalized first."""
    wait_for_async_saves(path)
    if os.path.isdir(path):
        return _load_dir(path, learner)
    if not os.path.exists(path) and os.path.isdir(path + ".orbax-old"):
        return _load_dir(path + ".orbax-old", learner)
    z = np.load(path, allow_pickle=False)
    manifest = json.loads(bytes(z["manifest"]).decode())
    _check_manifest(manifest, learner)
    if hasattr(learner, "shard_layout"):
        _load_sharded(path, z, manifest, learner)
        _apply_host_state(learner, manifest, bytes(z["sampler_rng"]),
                          bytes(z["pending"]) if "pending" in z else None)
        return learner
    refs = _states(learner)
    at, restored = 0, []
    for ref in refs:
        n = _leaf_count(ref)
        restored.append(_restore_state(
            ref, [z[f"leaf_{i}"] for i in range(at, at + n)]))
        at += n
    if getattr(learner, "states", None) is not None:
        learner.states = restored
    else:
        learner.state = restored[0]
    _set_streams(learner, z)
    _apply_host_state(learner, manifest, bytes(z["sampler_rng"]),
                      bytes(z["pending"]) if "pending" in z else None)
    return learner


# ---------------------------------------------------------------------------
# The directory backend (torch.distributed.checkpoint)
# ---------------------------------------------------------------------------

#: In-flight async saves: absolute path -> the finalize (wait for the
#: write, then sidecars and promote).
_ASYNC_PENDING: dict = {}
#: (the default group it was made in, a gloo group over the same ranks).
_CPU_GROUP: list = [None, None]


def wait_for_async_saves(path: Optional[str] = None) -> None:
    """Finalize async directory saves: wait for the background write,
    then write the sidecars and promote the directory. With no argument,
    every pending save. A failed finalize raises and stays pending, so a
    later load never reads the checkpoint the save should have replaced.
    Registered with atexit on first use; on a sharded learner every rank
    must call it at the same point (its promote has barriers), as the
    CLI does at its end."""
    keys = ([os.path.abspath(path)] if path is not None
            else list(_ASYNC_PENDING))
    for key in keys:
        finalize = _ASYNC_PENDING.get(key)
        if finalize is not None:
            finalize()
            _ASYNC_PENDING.pop(key, None)


def _dcp_group(sharded: bool):
    """(process_group, no_dist) for DCP: a single-process learner's save
    makes no collective; a sharded one's plans on a gloo group of its
    own, made once per default group. DCP gathers its plans as CPU
    objects, and an async save plans on a background thread: on a group
    that training also uses (a DeviceMesh dimension over every rank is
    the default group) the two threads' collectives would interleave."""
    if not sharded:
        return None, True
    if _CPU_GROUP[0] is not dist.group.WORLD:
        _CPU_GROUP[:] = [dist.group.WORLD, dist.new_group(backend="gloo")]
    return _CPU_GROUP[1], False


@contextlib.contextmanager
def _single_process_quiet():
    """DCP warns on every call without a process group that it assumes
    one process, which is what a single-process learner asks for."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is "
                                "disabled")
        yield


def _barrier(sharded: bool) -> None:
    if sharded:
        dist.barrier()


def _dcp_items(learner, snapshot: bool):
    """The state's leaves for DCP, {``leaf_i``: tensor}, in the npz
    numbering: tensors as they are (on a sharded learner the split
    fields as DTensors on its mesh), cloned on their device when
    ``snapshot``; the host counters as 0-d int64 tensors; empty leaves
    left out (the load keeps the learner's)."""
    from torch.distributed.tensor import DTensor

    layout = (learner.dtensor_layout() if hasattr(learner, "shard_layout")
              else {})
    items, at = {}, 0
    for state in _states(learner):
        for name, v in zip(state._fields, state):
            for x in (v if isinstance(v, tuple) else (v,)):
                key = f"leaf_{at}"
                at += 1
                if x is None:
                    continue
                if not isinstance(x, torch.Tensor):
                    items[key] = torch.tensor(int(x), dtype=torch.int64)
                    continue
                if x.numel() == 0:
                    continue
                if snapshot:
                    x = x.detach().clone()
                if name in layout:
                    mesh, placements = layout[name]
                    x = DTensor.from_local(x, mesh, placements,
                                           run_check=False)
                items[key] = x
    return items


def _save_dir(path: str, learner, async_save: bool) -> None:
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    wait_for_async_saves(path)      # a previous async save lands first
    if learner.device.type == "cuda":
        torch.cuda.synchronize(learner.device)
    sharded = hasattr(learner, "shard_layout")
    group, no_dist = _dcp_group(sharded)
    primary = not sharded or dist.get_rank() == 0
    manifest, sampler_rng, pending_blob = _collect_host_state(
        learner, _num_leaves(learner))
    manifest["backend"] = "dcp"
    if sharded:
        manifest["world_size"] = dist.get_world_size()
        manifest["mesh"] = learner.mesh.shape
    streams = _stream_arrays(learner)
    items = _dcp_items(learner, snapshot=async_save)
    if async_save and learner.device.type == "cuda":
        torch.cuda.synchronize(learner.device)      # the clones are done
    tmp, old = path + ".orbax-tmp", path + ".orbax-old"
    if primary:
        for d in (tmp, old):
            if os.path.exists(d):
                shutil.rmtree(d)
        os.makedirs(tmp)
    _barrier(sharded)

    def sidecars_and_promote():
        if primary:
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            with open(os.path.join(tmp, "sampler_rng.pkl"), "wb") as f:
                f.write(sampler_rng)
            with open(os.path.join(tmp, "pending.pkl"), "wb") as f:
                f.write(pending_blob)
            np.savez(os.path.join(tmp, "streams.npz"), **streams)
            # POSIX cannot swap two directories atomically: park the old
            # checkpoint first, so a crash between the renames leaves it
            # recoverable (load_checkpoint falls back to .orbax-old)
            if os.path.exists(path):
                os.rename(path, old)
            os.rename(tmp, path)
            if os.path.exists(old):
                shutil.rmtree(old)
        _barrier(sharded)

    state_dir = os.path.join(tmp, "state")
    if not async_save:
        with _single_process_quiet():
            dcp.save(items, checkpoint_id=state_dir, process_group=group,
                     no_dist=no_dist)
        sidecars_and_promote()
        return
    pending = dcp.async_save(items, checkpoint_id=state_dir,
                             process_group=group, no_dist=no_dist)
    del items

    def finalize():
        # newer torch returns the staging and upload futures together
        getattr(pending, "upload_completion", pending).result()
        sidecars_and_promote()

    if not _ASYNC_PENDING:
        atexit.register(wait_for_async_saves)
    _ASYNC_PENDING[path] = finalize


def _load_dir(path: str, learner):
    import torch.distributed.checkpoint as dcp

    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    _check_manifest(manifest, learner)
    sharded = hasattr(learner, "shard_layout")
    if sharded:
        _check_world(manifest)
    group, no_dist = _dcp_group(sharded)
    items = _dcp_items(learner, snapshot=False)
    with _single_process_quiet():
        dcp.load(items, checkpoint_id=os.path.join(path, "state"),
                 process_group=group, no_dist=no_dist)
    restored, at = [], 0
    for state in _states(learner):
        fields = {}
        for name, v in zip(state._fields, state):
            subs = []
            for x in (v if isinstance(v, tuple) else (v,)):
                got = items.get(f"leaf_{at}")
                at += 1
                if got is None:                 # None or an empty leaf
                    subs.append(x)
                elif not isinstance(x, torch.Tensor):
                    subs.append(int(got))
                else:
                    if hasattr(got, "to_local"):
                        got = got.to_local()
                    if got.data_ptr() != x.data_ptr():
                        x.copy_(got)
                    subs.append(x)
            fields[name] = type(v)(*subs) if isinstance(v, tuple) else subs[0]
        restored.append(type(state)(**fields))
    if getattr(learner, "states", None) is not None:
        learner.states = restored
    else:
        learner.state = restored[0]
    with np.load(os.path.join(path, "streams.npz")) as z:
        _set_streams(learner, z)
    with open(os.path.join(path, "sampler_rng.pkl"), "rb") as f:
        sampler_rng = f.read()
    with open(os.path.join(path, "pending.pkl"), "rb") as f:
        pending_blob = f.read()
    _apply_host_state(learner, manifest, sampler_rng, pending_blob)
    return learner
