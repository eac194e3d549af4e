"""Helpers of the benchmark's tests: a test-only tiny configuration
(``tiny/``), run on the CPU through the whole command."""

from __future__ import annotations

import contextlib
import io
import json
from pathlib import Path

import pytest

TINY = Path(__file__).resolve().parent / "tiny"
REPO = Path(__file__).resolve().parents[2]


def tiny_bench() -> dict:
    """``tiny/BENCHMARK.json`` with the real file's metrics, each
    reported in every tiny cell."""
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = json.loads((TINY / "BENCHMARK.json").read_text())
    for key in ("end_to_end", "per_layer"):
        bench[key] = [{k: v for k, v in m.items() if k != "workloads"}
                      for m in real[key]]
    return bench


def run_tiny(workload: str, seed: int, trace: int = 0,
             seconds: float = 1.0, device: str = "cpu"):
    """(exit code, the last line parsed, standard error) of one run of a
    tiny cell in this process."""
    from ammsb_bench import run

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace)],
                      require_cuda=False, bench=tiny_bench(), root=TINY,
                      device=device)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


@pytest.fixture
def tiny():
    return run_tiny
