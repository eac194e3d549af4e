"""Reference-format checkpoints in the port (mcmc_ammsb_tpu_torch/refckpt.py)
against the JAX package's (mcmc_ammsb_tpu/refckpt.py, tests/test_refckpt.py):
the wire codec byte for byte in both directions, each package reading the
other's files to equal arrays, the port's export byte-identical to JAX's
for the same state, config, graph and split in every build layout, the
importer and the exporter on the port's learners, the strict parse of
the reference binary's checks, and the export of a sharded run at two
ranks."""

import numpy as np
import pytest
import torch

from mcmc_ammsb_tpu import data as jax_data
from mcmc_ammsb_tpu import refckpt as jax_refckpt
from mcmc_ammsb_tpu_torch import data, learner, refckpt
from mcmc_ammsb_tpu_torch.config import Config, RngBackend
from mcmc_ammsb_tpu_torch.parallel.dryrun import spawn
from mcmc_ammsb_tpu_torch.refckpt import (ReferenceLayout, ReferenceParseError,
                                          encode_bytes, encode_double,
                                          encode_varint, parse_fields,
                                          read_reference_checkpoint,
                                          simulate_reference_parse,
                                          to_train_state,
                                          write_reference_checkpoint)

import torch_dist_workers as W
from torch_parity import jax_config


def test_wire_codec_roundtrip():
    """The codec decodes what it encodes, and each package's encoder
    writes the other's bytes."""
    msg = (encode_varint(1, 12345) + encode_double(2, -3.5)
           + encode_bytes(3, b"\x00\x01payload")
           + encode_varint(4, 2**40))
    jmsg = (jax_refckpt.encode_varint(1, 12345)
            + jax_refckpt.encode_double(2, -3.5)
            + jax_refckpt.encode_bytes(3, b"\x00\x01payload")
            + jax_refckpt.encode_varint(4, 2**40))
    assert msg == jmsg
    for fields in (parse_fields(msg), jax_refckpt.parse_fields(msg)):
        assert fields[1] == [12345]
        assert fields[2] == [-3.5]
        assert fields[3] == [b"\x00\x01payload"]
        assert fields[4] == [2**40]


def _fake_state(n=50, k=8, h=12, seed=0):
    rng = np.random.RandomState(seed)
    pi = rng.dirichlet(np.ones(k), size=n).astype(np.float32)
    phi = rng.gamma(2.0, 1.0, size=n).astype(np.float32)
    theta = rng.gamma(1.0, 1.0, size=(k, 2)).astype(np.float32)
    beta = (theta[:, 1] / theta.sum(-1)).astype(np.float32)
    ppx = rng.uniform(0.1, 0.9, size=h).astype(np.float32)
    seeds = rng.randint(0, 2**31, size=(64, 4)).astype(np.uint32)
    return dict(pi=pi, phi_sum=phi, theta=theta, beta=beta,
                ppx_per_edge=ppx, phi_seeds=seeds,
                beta_seeds=seeds[::-1].copy())


WRITERS = {"port": write_reference_checkpoint,
           "jax": jax_refckpt.write_reference_checkpoint}
READERS = {"port": read_reference_checkpoint,
           "jax": jax_refckpt.read_reference_checkpoint}


@pytest.mark.parametrize("writer, reader", [("port", "port"),
                                            ("port", "jax"),
                                            ("jax", "port")])
def test_reference_checkpoint_roundtrip(tmp_path, writer, reader):
    """A file written by one package reads back in the other (and in
    itself) to the arrays and counters written, seeds through the ulong2
    <-> uint32[4] conversion; both writers emit the same bytes."""
    st = _fake_state()
    kw = dict(theta=st["theta"], beta=st["beta"], pi=st["pi"],
              phi_sum=st["phi_sum"], ppx_per_edge=st["ppx_per_edge"],
              phi_seeds=st["phi_seeds"], beta_seeds=st["beta_seeds"],
              step_count=321, beta_count=320, phi_count=320, ppx_count=4,
              weight=50.0)
    path = str(tmp_path / "ref.ckpt")
    WRITERS[writer](path, **kw)
    other = str(tmp_path / "other.ckpt")
    WRITERS["jax" if writer == "port" else "port"](other, **kw)
    assert open(path, "rb").read() == open(other, "rb").read()
    raw = READERS[reader](path)
    for f in ("pi", "phi_sum", "theta", "beta", "ppx_per_edge", "phi_seeds",
              "beta_seeds"):
        np.testing.assert_array_equal(raw[f], st[f])
    assert (raw["step_count"], raw["beta_count"], raw["ppx_count"],
            raw["weight"]) == (321, 320, 4, 50.0)
    np.testing.assert_array_equal(raw["beta_interleaved"][1::2], st["beta"])


def test_reference_checkpoint_multi_block_rpm(tmp_path):
    """pi split across several row blocks, a ragged last one, parses to
    the same matrix in both packages."""
    st = _fake_state(n=53, k=8)
    path = str(tmp_path / "ref_rpm.ckpt")
    write_reference_checkpoint(
        path, theta=st["theta"], beta=st["beta"], pi=st["pi"],
        phi_sum=st["phi_sum"], ppx_per_edge=st["ppx_per_edge"],
        phi_seeds=st["phi_seeds"], beta_seeds=st["beta_seeds"],
        rows_in_block=16)
    for read in READERS.values():
        np.testing.assert_array_equal(read(path)["pi"], st["pi"])


def _problem(n=60, seed=8, **cfg_kw):
    """The port's (cfg, graph, split) and the JAX package's (graph,
    split) of the same synthetic graph (data.py is pinned equal)."""
    nn, u, v = data.synthetic_edges(n, 6, seed=seed)
    split = data.generate_sets(nn, u, v, heldout_ratio=0.2, seed=seed + 1)
    graph = data.Graph.from_edges(nn, split.training_u, split.training_v)
    jn, ju, jv = jax_data.synthetic_edges(n, 6, seed=seed)
    jsplit = jax_data.generate_sets(jn, ju, jv, heldout_ratio=0.2,
                                    seed=seed + 1)
    jgraph = jax_data.Graph.from_edges(jn, jsplit.training_u,
                                       jsplit.training_v)
    cfg = Config(K=8, mini_batch_size=4, num_node_sample=4,
                 steps_per_call=5, **cfg_kw).finalize(
        nn, split.total_edges, graph.max_fan_out)
    return cfg, graph, split, jgraph, jsplit


def _trained(**cfg_kw):
    cfg, graph, split, jgraph, jsplit = _problem(**cfg_kw)
    lrn = learner.Learner(cfg, graph, split, "cpu", prefetch=False)
    lrn.run(10)
    lrn.heldout_perplexity()
    if cfg.calc_train_ppx:
        lrn.training_perplexity()
    return cfg, graph, split, lrn


def test_reference_checkpoint_into_train_state(tmp_path):
    """to_train_state builds a state the port's evaluator takes: a
    Learner scoring held-out perplexity on it runs, carries the imported
    counters and continues the running average, and trains on."""
    cfg, graph, split, _, _ = _problem(n=50, seed=4)
    h = len(split.heldout_edges_u)
    st = _fake_state(n=cfg.N, k=8, h=h)
    path = str(tmp_path / "ref_state.ckpt")
    write_reference_checkpoint(
        path, theta=st["theta"], beta=st["beta"], pi=st["pi"],
        phi_sum=st["phi_sum"], ppx_per_edge=st["ppx_per_edge"],
        phi_seeds=st["phi_seeds"], beta_seeds=st["beta_seeds"],
        step_count=100, beta_count=99, ppx_count=2)
    state = to_train_state(cfg, read_reference_checkpoint(path), h, "cpu")
    assert (state.step_count, state.beta_count, state.ppx_count) == (100, 99,
                                                                     2)
    np.testing.assert_array_equal(state.pi.numpy(), st["pi"])
    lrn = learner.Learner(cfg, graph, split, "cpu", prefetch=False)
    lrn.state = state
    assert np.isfinite(lrn.heldout_perplexity())
    assert lrn.state.ppx_count == 3
    lrn.run(4)
    assert lrn.step_count == 104
    # a bf16 learner takes the rows in its storage dtype
    bf = to_train_state(cfg.replace(pi_dtype="bfloat16"),
                        read_reference_checkpoint(path), h, "cpu")
    assert bf.pi.dtype == torch.bfloat16
    assert torch.equal(bf.pi, torch.from_numpy(st["pi"]).to(torch.bfloat16))


def test_export_reference_checkpoint_roundtrip(tmp_path):
    """The --checkpoint-ref exporter writes a trained state in the
    reference's layout: reading it back gives every exported array and
    counter, the seed buffers have the reference's sizes, and the file
    resumes in a fresh learner at the same state."""
    cfg, graph, split, lrn = _trained()
    path = str(tmp_path / "export.ckpt")
    refckpt.export_reference_checkpoint(path, cfg, lrn.state)
    raw = read_reference_checkpoint(path)
    for f in ("pi", "phi_sum", "theta", "beta", "ppx_per_edge"):
        np.testing.assert_array_equal(raw[f],
                                      getattr(lrn.state, f).numpy())
    assert (raw["step_count"], raw["beta_count"], raw["ppx_count"]) == (
        lrn.step_count, lrn.state.beta_count, lrn.state.ppx_count)
    layout = ReferenceLayout.from_config(cfg, len(split.heldout_edges_u))
    assert raw["phi_seeds"].shape == (layout.phi_seed_count, 4)
    assert raw["beta_seeds"].shape == (cfg.K, 4)
    lrn2 = learner.Learner(cfg, graph, split, "cpu", prefetch=False)
    lrn2.state = to_train_state(cfg, raw, len(split.heldout_edges_u), "cpu",
                                state=lrn2.state)
    assert lrn2.step_count == lrn.step_count
    lrn2.run(5)
    assert lrn2.step_count == lrn.step_count + 5


def test_layout_size_laws():
    """The reference's allocation laws, the port's copy and JAX's
    agreeing (sample.cc, phi.cc, beta.cc, partitioned-alloc.h)."""
    kw = dict(N=100, K=16, mini_batch_size=8, num_node_sample=4,
              max_fan_out=30, heldout_size=10)
    L, J = ReferenceLayout(**kw), jax_refckpt.ReferenceLayout(**kw)
    assert L.batch_slots == 31
    assert L.dev_edges_len == 30
    assert L.phi_seed_count == 31 * 32
    assert L.beta_seed_count == 16
    assert L.ns_seed_count == 31 * 8
    assert L.ns_data_len == 31 * 4
    assert L.effective_rows_in_block == (512 << 20) // (16 * 4)
    assert L.num_samples == 2
    props = ("batch_slots", "dev_edges_len", "phi_seed_count",
             "beta_seed_count", "ns_seed_count", "ns_data_len",
             "effective_rows_in_block", "num_samples")
    assert [getattr(L, p) for p in props] == [getattr(J, p) for p in props]
    Lt = ReferenceLayout(N=100, K=16, mini_batch_size=8, num_node_sample=4,
                         max_fan_out=3, heldout_size=10,
                         phi_node_per_thread=True, sample_parallel=False)
    assert (Lt.batch_slots, Lt.phi_seed_count, Lt.num_samples) == (16, 16, 1)


class _NumpyState:
    """A state's fields as numpy arrays, the way JAX's exporter reads
    its TrainState (np.asarray of each field)."""

    def __init__(self, state):
        for f in state._fields:
            v = getattr(state, f)
            if isinstance(v, torch.Tensor):
                v = v.float().numpy()
            elif isinstance(v, tuple):
                v = type(v)(*(x.numpy().astype(np.uint32) for x in v))
            setattr(self, f, v)


LAYOUTS = {"default": {}, "train-ppx": dict(train_ppx=True),
           "serial": dict(train_ppx=True, sample_parallel=False),
           "phi-per-thread": dict(train_ppx=True, phi_node_per_thread=True),
           "rows-in-block": dict(train_ppx=True, rows_in_block=16),
           "reference-rng": dict(phi_node_per_thread=True)}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_export_byte_identical_to_jax(tmp_path, name):
    """For the same state, config, graph and split, the port's export
    (torch tensors; bf16 pi too) and JAX's are the same bytes: the
    in-flight batches from each package's host sampler (pinned equal by
    tests/test_torch_sampling.py), the law-filled seeds, the live beta
    (and per-thread phi) seeds of the reference RNG."""
    kw = LAYOUTS[name]
    cfg_kw = dict(calc_train_ppx=True, training_ppx_ratio=0.2)
    if name == "reference-rng":
        cfg_kw = dict(rng_backend=RngBackend.REFERENCE)
    cfg, graph, split, jgraph, jsplit = _problem(**cfg_kw)
    lrn = learner.Learner(cfg, graph, split, "cpu", prefetch=False)
    lrn.run(10)
    lrn.heldout_perplexity()
    if cfg.calc_train_ppx:
        lrn.training_perplexity()
    jcfg = jax_config(cfg.replace(host_sampler="numpy"))
    mine, theirs = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
    refckpt.export_reference_checkpoint(mine, cfg, lrn.state, graph, split,
                                        **kw)
    jax_refckpt.export_reference_checkpoint(theirs, jcfg,
                                            _NumpyState(lrn.state), jgraph,
                                            jsplit, **kw)
    blob = open(mine, "rb").read()
    assert blob == open(theirs, "rb").read()
    if name == "default":
        # bf16 rows are written upcast: the same bytes as their float32
        bf = lrn.state._replace(pi=lrn.state.pi.to(torch.bfloat16))
        refckpt.export_reference_checkpoint(mine, cfg, bf, graph, split)
        jax_refckpt.export_reference_checkpoint(
            theirs, jcfg, _NumpyState(bf), jgraph, jsplit)
        assert open(mine, "rb").read() == open(theirs, "rb").read()


def test_strict_parse_accepts_default_export(tmp_path):
    """The CLI-default export (MCMC_SAMPLE_PARALLEL build, no train ppx)
    passes the strict Learner::Parse replay of both packages: every
    buffer at the reference's size, both Sample sections a real
    minibatch, a clean end."""
    cfg, graph, split, lrn = _trained()
    path = str(tmp_path / "strict.ckpt")
    refckpt.export_reference_checkpoint(path, cfg, lrn.state, graph, split)
    h = len(split.heldout_edges_u)
    layout = ReferenceLayout.from_config(cfg, h)
    props = simulate_reference_parse(path, layout)
    assert props["learner_props"][1][0] == lrn.step_count
    assert 0 < props["sample0_edges"] <= layout.dev_edges_len
    assert 0 < props["sample0_nodes"] <= layout.batch_slots
    assert props["sample1_edges"] > 0
    jprops = jax_refckpt.simulate_reference_parse(
        path, jax_refckpt.ReferenceLayout.from_config(jax_config(cfg), h))
    assert jprops["sample0_edges"] == props["sample0_edges"]


def test_strict_parse_accepts_all_build_layouts(tmp_path):
    """Layout switches: MCMC_CALC_TRAIN_PPX inserts the training-ppx
    section, a serial build reads one Sample, PHI_NODE_PER_THREAD shrinks
    the phi seed buffer, a custom rows_in_block splits pi; the wrong
    layout is rejected, as the binary would."""
    cfg, graph, split, lrn = _trained(calc_train_ppx=True,
                                      training_ppx_ratio=0.2)
    h = len(split.heldout_edges_u)
    tp = lrn.state.train_ppx_per_edge.shape[0]
    assert tp > 0
    for kw in (dict(train_ppx=True),
               dict(train_ppx=True, sample_parallel=False),
               dict(train_ppx=True, phi_node_per_thread=True),
               dict(train_ppx=True, rows_in_block=16)):
        path = str(tmp_path / "layout.ckpt")
        refckpt.export_reference_checkpoint(path, cfg, lrn.state, graph,
                                            split, **kw)
        layout = ReferenceLayout.from_config(cfg, h, train_ppx_size=tp, **kw)
        assert simulate_reference_parse(path, layout)[
            "train_ppx_props"][1][0] >= 0
        wrong = ReferenceLayout.from_config(
            cfg, h, train_ppx=False,
            sample_parallel=kw.get("sample_parallel", True),
            phi_node_per_thread=kw.get("phi_node_per_thread", False),
            rows_in_block=kw.get("rows_in_block", 0))
        with pytest.raises(ReferenceParseError):
            simulate_reference_parse(path, wrong)


def test_strict_parse_rejects_round4_export_shape(tmp_path):
    """A file with max_batch_nodes phi seeds, one pi block and no Sample
    sections (an earlier exporter's shape) is rejected."""
    from mcmc_ammsb_tpu_torch.rng import reference as ref

    cfg, graph, split, lrn = _trained()
    path = str(tmp_path / "r4style.ckpt")
    write_reference_checkpoint(
        path, theta=lrn.state.theta.numpy(), beta=lrn.state.beta.numpy(),
        pi=lrn.state.pi.numpy(), phi_sum=lrn.state.phi_sum.numpy(),
        ppx_per_edge=lrn.state.ppx_per_edge.numpy(),
        phi_seeds=ref.make_seeds(cfg.phi_seed, cfg.max_batch_nodes).numpy(),
        beta_seeds=ref.make_seeds(cfg.beta_seed, cfg.K).numpy(),
        step_count=lrn.step_count)
    with pytest.raises(ReferenceParseError):
        simulate_reference_parse(path, ReferenceLayout.from_config(
            cfg, len(split.heldout_edges_u)))


def test_strict_parse_catches_truncation_and_trailing(tmp_path):
    """A truncated file and one with trailing bytes are both rejected."""
    cfg, graph, split, lrn = _trained()
    path = str(tmp_path / "ok.ckpt")
    refckpt.export_reference_checkpoint(path, cfg, lrn.state, graph, split)
    layout = ReferenceLayout.from_config(cfg, len(split.heldout_edges_u))
    blob = open(path, "rb").read()
    for name, payload in (("cut", blob[:-40]), ("fat", blob + b"\0" * 8)):
        bad = str(tmp_path / f"{name}.ckpt")
        open(bad, "wb").write(payload)
        with pytest.raises(ReferenceParseError):
            simulate_reference_parse(bad, layout)


def test_strict_parse_accepts_mesh_export(tmp_path):
    """Two gloo ranks, a (2, 1) mesh whose data axis pads the 63-edge
    training-perplexity population: export_learner gathers the global
    state and rank 0 writes the TRUE population sizes, so the strict
    parse accepts the file, and it holds the gathered state."""
    path = str(tmp_path / "mesh.ckpt")
    out = spawn(W.suite, 2, ([("ref", "reference_export",
                               (5, 2, 1, path))],), timeout=120)
    r = out[0]["ref"]
    cfg, graph, split = W.graph_case(5, calc_train_ppx=True,
                                     training_ppx_ratio=0.01)
    h = len(split.heldout_edges_u)
    tp = len(data.make_training_ppx_edges(split, 0.01)[0])
    assert r["padded"][1] > tp == 63
    layout = ReferenceLayout.from_config(cfg, h, train_ppx_size=tp)
    props = simulate_reference_parse(path, layout)
    assert props["learner_props"][1][0] == r["step"]
    raw = read_reference_checkpoint(path, with_train_ppx=True)
    np.testing.assert_array_equal(raw["pi"], r["pi"])
    np.testing.assert_array_equal(raw["ppx_per_edge"], r["ppx_per_edge"][:h])
    np.testing.assert_array_equal(raw["train_ppx_per_edge"],
                                  r["train_ppx_per_edge"][:tp])
