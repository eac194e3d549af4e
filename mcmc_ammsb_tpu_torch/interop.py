"""Build the port's state and membership tables from the JAX package's,
so that both packages can run the same computation from the same numbers
(the parity tests), from arrays or from a checkpoint file that the JAX
package wrote: ``JAX_LEARNERS`` names the JAX learners whose npz files
are read and the leaf order of their state; ``checkpoint.load_checkpoint``
reads such a file into the port's learner of the same name through
``jax_leaf_keys``."""

from __future__ import annotations

import numpy as np
import torch

from mcmc_ammsb_tpu_torch.chains_flat import ChainState
from mcmc_ammsb_tpu_torch.config import Config
from mcmc_ammsb_tpu_torch.learner import RefRngState, TrainState
from mcmc_ammsb_tpu_torch.models.mmsb import MMSBState
from mcmc_ammsb_tpu_torch.ops.edgeset import EdgeSet


def _tensors(arrays: dict, cfg: Config, device, num_chains: int = 1):
    if tuple(np.shape(arrays["pi"])) != (num_chains * cfg.N, cfg.K):
        raise ValueError(f"pi has shape {np.shape(arrays['pi'])}, the "
                         f"config and {num_chains} chain(s) say "
                         f"({num_chains * cfg.N}, {cfg.K})")

    def tensor(name):
        return torch.tensor(np.asarray(arrays[name], np.float32),
                            device=device)

    return tensor


def state_from_numpy(arrays: dict, cfg: Config, device) -> TrainState:
    """``arrays`` maps the JAX ``TrainState`` field names to numpy
    arrays (the reference RNG's seeds as ``ref_seeds.phi``,
    ``ref_seeds.beta`` and ``ref_seeds.neighbor``, uint32 [L, 4]); its RNG
    keys and other fields the port keeps elsewhere are ignored. Tensors
    are copies: the port updates pi in place."""
    tensor = _tensors(arrays, cfg, device)
    ref_seeds = None
    if "ref_seeds.phi" in arrays:
        ref_seeds = RefRngState(*(
            torch.tensor(np.asarray(arrays[f"ref_seeds.{f}"], np.int64),
                         device=device) for f in RefRngState._fields))
    return TrainState(
        pi=tensor("pi"), phi_sum=tensor("phi_sum"), theta=tensor("theta"),
        beta=tensor("beta"), step_count=int(arrays["step_count"]),
        beta_count=int(arrays["beta_count"]),
        ppx_per_edge=tensor("ppx_per_edge"),
        ppx_count=int(arrays["ppx_count"]), ref_seeds=ref_seeds,
        train_ppx_per_edge=(tensor("train_ppx_per_edge")
                            if "train_ppx_per_edge" in arrays else None),
        train_ppx_count=int(arrays.get("train_ppx_count", 0)))


#: Leaf order of the JAX package's ``TrainState``
#: (mcmc_ammsb_tpu/learner.py:60-87). ``ref_seeds`` is None with the
#: native RNG and has no leaf; with the reference RNG its three arrays sit
#: after ``neighbor_key``. The four keys have no counterpart in the port's
#: state.
_JAX_TRAIN_STATE_LEAVES = (
    "pi", "phi_sum", "theta", "beta", "step_count", "beta_count",
    "ppx_per_edge", "ppx_count", "phi_key", "beta_key", "neighbor_key",
    "sample_key", "train_ppx_per_edge", "train_ppx_count")
_JAX_REF_LEAVES = tuple(f"ref_seeds.{f}" for f in RefRngState._fields)
#: ``MMSBState`` and ``MMSBChainState`` (models/mmsb.py:70, :564).
_JAX_MMSB_STATE_LEAVES = (
    "pi", "phi_sum", "theta_b", "b", "step_count", "theta_count",
    "ppx_per_edge", "ppx_count", "phi_key", "theta_key", "neighbor_key",
    "sample_key")
#: ``ChainState`` (chains_flat.py:35; parallel/chains_sharded.py:74).
_JAX_CHAIN_STATE_LEAVES = (
    "pi", "phi_sum", "theta", "beta", "step_count", "beta_count",
    "ppx_per_edge", "ppx_count", "phi_key", "beta_key", "neighbor_key",
    "sample_key")
#: The JAX learners whose npz checkpoints the port reads (the manifest's
#: ``learner``; each has the port class of the same name as its
#: counterpart) and the leaf order of their state. The sharded learners'
#: files hold the global state: pi's rows padded to the model axis, the
#: running averages to the data axis.
JAX_LEARNERS = {
    "Learner": _JAX_TRAIN_STATE_LEAVES,
    "ShardedLearner": _JAX_TRAIN_STATE_LEAVES,
    "FullMMSBLearner": _JAX_MMSB_STATE_LEAVES,
    "MMSBChainLearner": _JAX_MMSB_STATE_LEAVES,
    "FlatChainLearner": _JAX_CHAIN_STATE_LEAVES,
    "ShardedChainLearner": _JAX_CHAIN_STATE_LEAVES,
}


def jax_leaf_names(manifest: dict) -> list:
    """The field of each ``leaf_i`` of a JAX npz checkpoint, from its
    manifest: a ``TrainState`` with the reference RNG has the three seed
    arrays as ``ref_seeds.<stream>``. Raises ValueError for another
    learner or another number of leaves."""
    name = manifest.get("learner")
    if name not in JAX_LEARNERS:
        raise ValueError(
            f"checkpoint of the JAX package's {name}: the port reads those "
            f"of {', '.join(JAX_LEARNERS)} (the JAX CLI checkpoints no "
            f"other engine)")
    names = list(JAX_LEARNERS[name])
    train = JAX_LEARNERS[name] is _JAX_TRAIN_STATE_LEAVES
    if train and manifest["num_leaves"] == len(names) + len(_JAX_REF_LEAVES):
        at = names.index("neighbor_key") + 1
        names[at:at] = _JAX_REF_LEAVES
    if manifest["num_leaves"] != len(names):
        raise ValueError(
            f"checkpoint has {manifest['num_leaves']} state leaves, the JAX "
            f"{name}'s state has {len(names)}"
            + (f" (native RNG) or {len(names) + len(_JAX_REF_LEAVES)} "
               "(reference RNG)" if train else ""))
    return names


def jax_leaf_keys(manifest: dict, state) -> list:
    """The npz key of each leaf of the port's ``state`` (in
    ``checkpoint.state_leaves`` order) in a JAX checkpoint: None where
    the port's leaf is an absent field (an empty leaf). The JAX keys are
    skipped: threefry keys have no torch counterpart. Raises ValueError
    when the file's RNG backend is not the state's."""
    at = {n: f"leaf_{i}" for i, n in enumerate(jax_leaf_names(manifest))}
    keys = []
    for name, v in zip(state._fields, state):
        if isinstance(v, tuple):
            keys.extend(at.get(f"{name}.{sub}") for sub in v._fields)
        else:
            keys.append(at.get(name))
    seeds = getattr(state, "ref_seeds", None)
    if ("ref_seeds.phi" in at) != (seeds is not None):
        raise ValueError(
            "the checkpoint was written with the "
            f"{'reference' if 'ref_seeds.phi' in at else 'native'} RNG, "
            f"this learner runs the "
            f"{'reference' if seeds is not None else 'native'} RNG")
    return keys


def state_from_jax_checkpoint(path: str, cfg: Config, device) -> TrainState:
    """The port's ``TrainState`` from an npz checkpoint that the JAX
    package's ``save_checkpoint`` wrote for its single-chain ``Learner``
    (leaves named by ``jax_leaf_names``), with the native RNG or the
    reference RNG (whose seeds the run continues from). The four key
    leaves are skipped: the port's native streams are generators seeded
    from the config. Every other learner's file is read into a learner by
    ``checkpoint.load_checkpoint``."""
    import json

    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(bytes(z["manifest"]).decode())
        if manifest.get("learner") != "Learner":
            raise ValueError(f"checkpoint of a {manifest.get('learner')}: "
                             f"only the single-chain Learner's state is read")
        arrays = {name: z[f"leaf_{i}"]
                  for i, name in enumerate(jax_leaf_names(manifest))
                  if not name.endswith("_key")}
    return state_from_numpy(arrays, cfg, device)


def mmsb_state_from_numpy(arrays: dict, cfg: Config, device) -> MMSBState:
    """The same for the JAX package's ``MMSBState`` (``theta_b`` [K, K, 2],
    ``b`` [K, K], the ``theta_count`` counter)."""
    tensor = _tensors(arrays, cfg, device)
    return MMSBState(
        pi=tensor("pi"), phi_sum=tensor("phi_sum"),
        theta_b=tensor("theta_b"), b=tensor("b"),
        step_count=int(arrays["step_count"]),
        theta_count=int(arrays["theta_count"]),
        ppx_per_edge=tensor("ppx_per_edge"),
        ppx_count=int(arrays["ppx_count"]))


def chain_state_from_numpy(arrays: dict, cfg: Config, num_chains: int,
                           device) -> ChainState:
    """The same for the JAX package's flat-chain ``ChainState`` (pi
    [C*N, K], theta [C, K, 2], beta [C, K], ppx_per_edge [C, H], shared
    counters)."""
    tensor = _tensors(arrays, cfg, device, num_chains)
    return ChainState(
        pi=tensor("pi"), phi_sum=tensor("phi_sum"), theta=tensor("theta"),
        beta=tensor("beta"), step_count=int(arrays["step_count"]),
        beta_count=int(arrays["beta_count"]),
        ppx_per_edge=tensor("ppx_per_edge"),
        ppx_count=int(arrays["ppx_count"]))


def edge_set_from_numpy(backend: str, meta, arrays, num_nodes: int,
                        num_search_steps: int = 1, device="cpu") -> EdgeSet:
    """The port's ``EdgeSet`` over the JAX package's tables: ``backend``,
    ``meta`` and ``arrays`` (as numpy) of a ``mcmc_ammsb_tpu`` EdgeSet with
    its ``num_nodes`` and ``num_search_steps``, so a test can give both
    packages the very same table."""
    return EdgeSet(backend, int(num_nodes), int(num_search_steps),
                   tuple((k, int(v)) for k, v in meta),
                   tuple(torch.tensor(np.asarray(a), device=device)
                         for a in arrays))
