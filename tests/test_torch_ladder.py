"""The port's config ladder (mcmc_ammsb_tpu_torch/ladder.py) against the
JAX package's scripts/run_ladder.py: the same rung table, and on one tiny
rung given to both (a power-law graph of N ~ 2000, K = 16, 200 steps, three
seeds) the same artifact keys and the same N, E, max fan-out, K,
ds_link_cap, window and pi dtype; every ppx series falls and the mean
final ppx agree within 5% (the reference's cross-mode perplexity
tolerance, BASELINE.md); the K rule on a card memory passed in."""

import importlib.util
import json
import os

import numpy as np
import pytest

from mcmc_ammsb_tpu_torch import ladder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ("tiny.txt", 16, (2000, 8.0, 60), {"ds_link_cap": 32, "window": 4})
#: the port's artifact fields that the JAX script does not write
EXTRA = {"device", "seconds", "updates_per_s", "pi_bytes",
         "peak_memory_bytes", "base_memory_bytes", "k_rule"}


@pytest.fixture(scope="module")
def jax_ladder():
    spec = importlib.util.spec_from_file_location(
        "run_ladder", os.path.join(ROOT, "scripts", "run_ladder.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_rung_table_is_jax_scripts(jax_ladder):
    assert ladder.RUNGS == jax_ladder.RUNGS


#: the runs of each package on the tiny rung: other init and sampling
#: seeds each (the two packages draw other streams from one seed, and at
#: 200 steps one run's final ppx moves by up to ~6% with its seeds, so the
#: packages are compared on the mean of three)
SEEDS = [dict(init_seed=100 + i, sample_seed=7 + i) for i in range(3)]


@pytest.fixture(scope="module")
def tiny_artifacts(jax_ladder, tmp_path_factory):
    """Both packages' artifacts of the tiny rung (200 steps, ppx every
    100), one per SEEDS entry, and the first one as the port wrote it."""
    out = tmp_path_factory.mktemp("ladder")
    empty = str(out / "no-data")
    mine, ref = [], []
    try:
        for seeds in SEEDS:
            rung = (*TINY[:3], {**TINY[3], **seeds})
            jax_ladder.RUNGS["tiny"] = ladder.RUNGS["tiny"] = rung
            mine.append(ladder.run_rung("tiny", empty, str(out / "torch"),
                                        200, 100, device="cpu"))
            ref.append(jax_ladder.run_rung("tiny", empty, str(out / "jax"),
                                           200, 100))
    finally:
        del jax_ladder.RUNGS["tiny"], ladder.RUNGS["tiny"]
    with open(out / "torch" / "ppx_tiny.json") as f:
        written = json.load(f)
    return mine, ref, written


def test_tiny_rung_matches_jax(tiny_artifacts):
    """The same fields and graph as the JAX script's artifact; every
    series falls; the mean final ppx of the three runs within 5%."""
    mine, ref, written = tiny_artifacts
    assert written == json.loads(json.dumps(mine[-1]))
    for m, r in zip(mine, ref):
        assert set(m) == set(r) | EXTRA
        for f in ("rung", "source", "synthetic", "N", "E", "K", "m", "n",
                  "max_fan_out", "ds_link_cap", "window", "pi_dtype",
                  "iters", "ppx_interval"):
            assert m[f] == r[f], f
        assert [p["iter"] for p in m["series"]] == [0, 100, 200] == [
            p["iter"] for p in r["series"]]
        for art in (m, r):
            ppx = [p["ppx"] for p in art["series"]]
            assert all(np.isfinite(ppx)) and ppx[-1] < ppx[0]
        assert m["device"] == "cpu" and m["peak_memory_bytes"] is None
        assert set(m["seconds"]) == {"data", "split", "graph", "edge_sets",
                                     "init", "training", "evaluations"}
        assert all(v >= 0 for v in m["seconds"].values())
    np.testing.assert_allclose(
        np.mean([m["series"][-1]["ppx"] for m in mine]),
        np.mean([r["series"][-1]["ppx"] for r in ref]), rtol=0.05)


def test_k_rule_on_a_card_memory():
    """com-lj at its full N: an 80 GB card holds pi [N, 4096] bf16
    (32.75 GB) and the working set, a 16 GB one does not (K_single_chip
    1024, the JAX script's); rungs without K_single_chip keep their K."""
    n, e, fan = 3_997_409, 34_114_409, 9_202
    cfg = ladder.rung_config("com-lj", 4096, n, e, fan)
    assert cfg.pi_dtype == "bfloat16" and cfg.max_batch_nodes == 33
    pi = ladder.pi_bytes(cfg)
    assert pi == n * 4096 * 2
    for total, k in ((80 * 10 ** 9, 4096), (16 * 10 ** 9, 1024)):
        work = (ladder.transient_bytes(cfg) + (2 << 30)
                + total // ladder.SLACK_DIVISOR)
        assert ladder.choose_k("com-lj", pi, total, work) == k
    assert ladder.choose_k("com-lj", pi, pi + work, work) == 4096
    assert ladder.choose_k("com-lj", pi, pi + work - 1, work) == 1024
    assert ladder.choose_k("com-youtube", 1 << 40, 16 * 10 ** 9, 0) == 1024


def test_k_rule_falls_back_in_a_run(monkeypatch, tmp_path):
    """A rung whose pi does not fit the device's memory runs at its
    K_single_chip and says so in the artifact."""
    ladder.RUNGS["tiny"] = ("tiny.txt", 16, (2000, 8.0, 60),
                            {"K_single_chip": 8})
    monkeypatch.setattr(ladder, "device_memory_bytes", lambda d: 1 << 20)
    try:
        art = ladder.run_rung("tiny", str(tmp_path / "no-data"),
                              str(tmp_path), 100, 100, device="cpu")
    finally:
        del ladder.RUNGS["tiny"]
    assert art["K"] == 8 and art["K_reference"] == 16
    assert "does not fit" in art["K_note"]
    rule = art["k_rule"]
    assert rule["device_memory_bytes"] == 1 << 20
    assert rule["working_bytes"] == (rule["structure_bytes"]
                                     + rule["transient_bytes"]
                                     + rule["slack_bytes"])


def test_never_writes_the_jax_artifacts(tmp_path):
    with pytest.raises(ValueError, match="JAX package's artifacts"):
        ladder.run_rung("ca-HepPh", str(tmp_path), ladder.JAX_OUT, 10, 10,
                        device="cpu")
    assert os.path.realpath(ladder.JAX_OUT) == os.path.realpath(
        os.path.join(ROOT, "bench_results"))


def test_main_writes_one_artifact_per_rung(monkeypatch, tmp_path):
    """``python -m mcmc_ammsb_tpu_torch.ladder``'s flags: the rungs, the
    run length, the data and output directories, the device."""
    ladder.RUNGS["tiny"] = TINY
    try:
        rc = ladder.main(["--rungs", "tiny", "--iters", "100", "--interval",
                          "50", "--data", str(tmp_path / "no-data"),
                          "--out", str(tmp_path / "out"), "--device",
                          "cpu"])
    finally:
        del ladder.RUNGS["tiny"]
    assert rc == 0
    with open(tmp_path / "out" / "ppx_tiny.json") as f:
        art = json.load(f)
    assert [p["iter"] for p in art["series"]] == [0, 50, 100]
