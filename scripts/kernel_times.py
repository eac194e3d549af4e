"""Device time per call of the MMSB window and the phi kernel's two
entries at their CLI paths' shapes, on one NVIDIA GPU, for whichever
tree of the port is on PYTHONPATH: run it from a checkout and from an
unpacked parent (`git archive`) in one call to compare the two.

    PYTHONPATH=. python3 scripts/kernel_times.py [--reps 50] [--out FILE]

The MMSB window at (T, B, n, E, K) = (12, 33, 32, 32, 64) is timed as
the tree's `mmsb_windowed_scan` runs one window on the card: the fused
`mmsb_window_apply_cuda` where the tree has it, else the gather, the
window kernel `mmsb_window_core_cuda` and the scatter. The phi entries
run at (B, n, K) = (33, 32, 256). CUDA events over `--reps` calls after
a warm-up; the device sleeps while the host queues them, so the host's
launch cost is not in the time. Prints one JSON line. Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch


def device_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000 * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def mmsb_window(reps: int) -> dict:
    from mcmc_ammsb_tpu_torch import testing
    from mcmc_ammsb_tpu_torch.ops import window, window_mmsb

    case = testing.mmsb_window_case(1, 12, 33, 32, 32, 64)
    cfg = testing.window_case_config(case)
    state, xs = testing.mmsb_window_case_torch(case, "cuda")
    b = xs[0]
    mcode = window._correction_codes(cfg, b.nodes, b.node_mask, xs[1])
    keep = window._last_write_wins(b.nodes, b.node_mask, 12)
    fused = hasattr(window_mmsb, "mmsb_window_apply_cuda")

    def run():
        if fused:
            window_mmsb.mmsb_window_apply_cuda(cfg, state, xs, mcode, keep)
            return
        g, sums = window._window_gather(cfg, state, b, xs[1])
        rows, rsums, _ = window_mmsb.mmsb_window_core_cuda(
            cfg, state, xs, g, sums, mcode)
        window._window_scatter(cfg, state, b, keep, rows, rsums)

    return {"entry": "mmsb_window_apply_cuda" if fused else
            "gather + mmsb_window_core_cuda + scatter",
            "ms_per_window": device_ms(run, reps)}


def phi_entries(reps: int) -> dict:
    from mcmc_ammsb_tpu_torch import testing
    from mcmc_ammsb_tpu_torch.ops import phi_pallas

    case = testing.phi_case(0, 33, 32, 256)
    cfg = testing.phi_case_config(case)
    t = {f: torch.as_tensor(case[f], device="cuda") for f in
         ("pi", "phi_sum", "beta", "nodes", "nbrs", "y", "noise")}
    step = case["step_count"]
    pi_n, phis, pi_nb = phi_pallas._gather(cfg, t["pi"], t["phi_sum"],
                                           t["nodes"], t["nbrs"])
    return {
        "pre-gathered_ms": device_ms(lambda: phi_pallas.phi_update_core_cuda(
            cfg, pi_n, phis, pi_nb, t["y"], t["beta"], step, t["noise"]),
            reps),
        "by-index_ms": device_ms(lambda: phi_pallas.phi_update_rows_cuda(
            cfg, t["pi"], t["phi_sum"], t["beta"], t["nodes"], t["nbrs"],
            t["y"], step, t["noise"]), reps)}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--out", default=None)
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    result = {"device": smi, "mmsb": mmsb_window(a.reps),
              "phi": phi_entries(a.reps)}
    line = json.dumps(result)
    print(line)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
