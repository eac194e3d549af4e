"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its file."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from ammsb_bench import check, run

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["ammsb_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for text in ("why", "layer", "source"):
                if text in entry and group != "end_to_end":
                    assert 1 <= len(entry[text]) <= 200
                    assert "\n" not in entry[text] and "\t" not in entry[text]
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert len(CELLS) == len(set(CELLS))


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}


def test_every_cell_reports_what_it_must():
    e2e = BENCH["end_to_end"]
    for cell in CELLS:
        spec = run.cell_spec(cell, BENCH)
        names = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert spec["per_layer"]
    for m in BENCH["per_layer"]:
        moved = next(x for x in e2e if x["name"] == m["moves"])
        for cell in m.get("workloads", CELLS):
            assert cell in moved.get("workloads", CELLS), (m["name"], cell)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    spec = run.cell_spec(cell, BENCH)
    config = spec["config"]
    entry = next(c for c in BENCH["configs"] if c["name"] == config["name"])
    assert config["reduced"] == entry["reduced"]
    assert config["model"]["pi_dtype"] in ("float32", "bfloat16")
    assert set(spec["limits"]) == set(check.NAMES)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(run.reader(run.HERE, m["name"]))


def test_config_files_are_distinct_and_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith("ammsb_bench/") and (REPO / f).exists()
