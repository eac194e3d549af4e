"""The JAX-written checkpoints of tests/fixtures/jax_ckpt/ and their
sidecars, made by the JAX package on the CPU.

Each fixture is a ``Learner`` built as the JAX CLI builds it for
``FIXTURES[name]`` (``--synthetic 1000,8 -k 16 -x 10 -i 10``, the
test graph's size), evaluated, trained 10 steps and evaluated again,
with one host chunk in flight (what the prefetch producer holds when a
run is checkpointed), then saved by the JAX package's
``save_checkpoint``. Its sidecar ``<name>.json`` holds the arguments and
JAX's own continuation of the file as the JAX CLI runs it with
``--restore`` and those arguments: ``ppx[0]`` at the restore, ``ppx[10]``
after 10 more steps, a float64 digest of pi, theta and
phi_sum there (``mcmc_ammsb_tpu_torch.testing.digest``: sum, 2-norm,
largest magnitude), and the first minibatch the continuation trains on.

Regenerate (JAX on the CPU; the arrays must not change, which
tests/test_torch_jax_restore.py checks):

    JAX_PLATFORMS=cpu python tests/jax_fixtures.py
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE_DIR = os.path.join(HERE, "fixtures", "jax_ckpt")
COMMON = ["--synthetic", "1000,8", "-k", "16", "-x", "10", "-i", "10"]
FIXTURES = {
    # host-sampled with the native RNG: the port continues the host
    # sampler's stream and re-seeds its torch streams
    "learner_host": COMMON + ["--no-device-sampling"],
    # the reference RNG: its seeds travel in the state
    "learner_reference": COMMON + ["--rng", "reference"],
}
STEPS = 10
BATCH_FIELDS = ("edges_u", "edges_v", "edge_mask", "nodes", "node_mask",
                "weight")


def jax_cli_learner(argv, **cfg_fields):
    """The JAX learner that the JAX CLI builds for ``argv`` (its engine
    from ``--num-chains``, ``--chain-devices``, ``--model`` and
    ``--mesh``), with the single-model learners' prefetch producer off,
    so the batches they draw are drawn in this thread; ``cfg_fields``
    replace Config fields the CLI has no flag for (e.g. ``init_seed``)."""
    from mcmc_ammsb_tpu import cli as jcli
    from mcmc_ammsb_tpu import data as jdata
    from mcmc_ammsb_tpu.chains_flat import FlatChainLearner
    from mcmc_ammsb_tpu.learner import Learner
    from mcmc_ammsb_tpu.models.mmsb import FullMMSBLearner, MMSBChainLearner
    from mcmc_ammsb_tpu.parallel import ShardedLearner, make_mesh
    from mcmc_ammsb_tpu.parallel.chains_sharded import (ShardedChainLearner,
                                                        make_chain_mesh)

    args = jcli.build_arg_parser().parse_args(argv)
    jcli.resolve_fast_defaults(args)
    nn, deg = (int(x) for x in args.synthetic.split(","))
    n, u, v = jdata.synthetic_edges(nn, deg, seed=1)
    split = jdata.generate_sets(n, u, v, args.heldout_ratio)
    graph = jdata.Graph.from_edges(n, split.training_u, split.training_v)
    cfg = jcli.config_from_args(args).replace(**cfg_fields).finalize(
        n, split.total_edges, graph.max_fan_out)
    c = args.num_chains
    if c > 1 and args.chain_devices > 1:
        return ShardedChainLearner(cfg, graph, split, c,
                                   make_chain_mesh(args.chain_devices))
    if c > 1:
        return (MMSBChainLearner if args.model == "mmsb"
                else FlatChainLearner)(cfg, graph, split, c)
    if args.model == "mmsb":
        return FullMMSBLearner(cfg, graph, split)
    if args.mesh:
        # a small mesh on the 8 virtual devices of conftest.py
        mesh = make_mesh(*(int(x) for x in args.mesh.split(",")),
                         allow_subset=True)
        return ShardedLearner(cfg, graph, split, mesh, prefetch=False)
    return Learner(cfg, graph, split, prefetch=False)


def same_values(a, b) -> bool:
    """Equal values, recursively through tuples, lists, numpy arrays (of
    one dtype) and the batch dataclasses."""
    if dataclasses.is_dataclass(a):
        return type(a) is type(b) and same_values(dataclasses.astuple(a),
                                                  dataclasses.astuple(b))
    if isinstance(a, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same_values(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (np.asarray(a).dtype == np.asarray(b).dtype
                and np.array_equal(a, b))
    return a == b


def named_leaves(state) -> dict:
    """The port state's leaves (``checkpoint.state_leaves``) by field:
    the reference RNG's seeds as ``ref_seeds.<stream>``."""
    from mcmc_ammsb_tpu_torch import checkpoint

    out = {}
    for name, v in zip(state._fields, state):
        if isinstance(v, tuple):
            out.update({f"{name}.{sub}": checkpoint._leaf(x)
                        for sub, x in zip(v._fields, v)})
        else:
            out[name] = checkpoint._leaf(v)
    return out


def assert_state_is_the_file(path: str, named: dict) -> None:
    """Every leaf of the JAX checkpoint ``path`` but its keys equals the
    port's leaf of the same field in ``named`` (``named_leaves``), bit
    for bit and of the same shape (bf16 pi as its float32 leaf)."""
    from mcmc_ammsb_tpu_torch import interop

    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(bytes(z["manifest"]).decode())
        for i, name in enumerate(interop.jax_leaf_names(manifest)):
            if name.endswith("_key"):
                continue
            got, want = np.asarray(named[name]), z[f"leaf_{i}"]
            assert got.shape == want.shape, (name, got.shape, want.shape)
            np.testing.assert_array_equal(got, want, err_msg=name)


def write_checkpoint(name: str, path: str) -> None:
    """Run fixture ``name`` with the JAX package and save it to
    ``path`` (an ``.npz`` name: JAX's ``np.savez_compressed`` appends
    one to any other)."""
    from mcmc_ammsb_tpu.checkpoint import save_checkpoint

    jl = jax_cli_learner(FIXTURES[name])
    jl.heldout_perplexity()
    jl.run(STEPS)
    jl.heldout_perplexity()
    jl._pending.append(jl.sampler.sample_many(jl.cfg.steps_per_call))
    save_checkpoint(path, jl)
    jl.close()


def continuation(name: str, path: str) -> dict:
    """JAX's continuation of the file, as its CLI runs ``--restore``:
    the sidecar's content."""
    from mcmc_ammsb_tpu.checkpoint import load_checkpoint
    from mcmc_ammsb_tpu_torch import testing

    jl = jax_cli_learner(FIXTURES[name])
    load_checkpoint(path, jl)
    first = jl._pending[0]
    ppx0 = float(jl.heldout_perplexity())
    jl.run(STEPS)
    ppx = float(jl.heldout_perplexity())
    st = jl.state
    out = {"argv": FIXTURES[name], "steps": STEPS,
           "restored_step": STEPS + 1,
           "ppx": {"0": ppx0, str(STEPS): ppx},
           "digest": testing.digest({"pi": np.asarray(st.pi),
                                     "theta": np.asarray(st.theta),
                                     "phi_sum": np.asarray(st.phi_sum)}),
           "first_minibatch": {f: np.asarray(getattr(first, f))[0].tolist()
                               for f in BATCH_FIELDS}}
    jl.close()
    return out


def write(name: str, out_dir: str = FIXTURE_DIR) -> None:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name + ".npz")
    write_checkpoint(name, path)
    with open(os.path.join(out_dir, name + ".json"), "w") as f:
        json.dump(continuation(name, path), f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))
    import jax

    jax.config.update("jax_platforms", "cpu")
    for fixture in FIXTURES:
        write(fixture)
        print("wrote", os.path.join(FIXTURE_DIR, fixture + ".npz"))
