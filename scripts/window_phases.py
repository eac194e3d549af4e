"""Phase profile and cluster-size sweep of the fused a-MMSB window kernel
(mcmc_ammsb_tpu_torch/csrc/window_kernel.cu) on one NVIDIA GPU.

Run from the root of a checkout:

    PYTHONPATH=. python3 scripts/window_phases.py [--sizes 2,4,8,16]

At the single-chain bench shape (T, B, n, E, K) = (12, 33, 32, 32, 256)
and the chain shape (16 chains of (6, 33, 32, 32, 256)), for each cluster
size S that fits: the clusters the card runs at once, the device time per
window (CUDA events; the device sleeps while the host queues 50
windows, so the host's launch cost is not in it), and the clock cycles
per step of each stage, from a second build of the source with
-DWINDOW_PHASES (thread 0 of the first CTA adds the cycles between
consecutive barriers into one slot per stage). Prints one JSON line.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

STAGES = ["init + first gather", "gather issue + redirect + wait",
          "partial q pushed + cluster barrier",
          "owners' coefficients pushed + cluster barrier",
          "contrib + phi step", "row-sum partials pushed + cluster barrier",
          "normalize + stage", "edge partials pushed + cluster barrier",
          "fan-in partials", "theta step", "scatter + final barrier",
          "calibration: bare block barrier",
          "calibration: bare cluster barrier"]
REPS = 50


def device_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000 * REPS)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sizes", default="2,4,8,16")
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("window_phases: no CUDA device available", file=sys.stderr)
        return 1
    from mcmc_ammsb_tpu_torch import chains_flat, kernels, testing
    from mcmc_ammsb_tpu_torch.ops import window

    src = kernels._CSRC / "window_kernel.cu"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = kernels.BUILD_DIR / "libwindow_phases.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-DWINDOW_PHASES",
                    "-o", str(out), str(src)], check=True,
                   capture_output=True)
    plib = window.bind_window_lib(ctypes.CDLL(str(out)))
    plib.window_kernel_phases.argtypes = [ctypes.c_void_p]
    lib = window._window_lib()
    limit = kernels.smem_limit(torch.device("cuda"))
    phases = (ctypes.c_ulonglong * 16)()

    case = testing.window_case(0, 12, 33, 32, 32, 256)
    cfg1 = testing.window_case_config(case)
    st1, xs1 = testing.window_case_torch(case, "cuda")
    b1 = xs1[0]
    mc1 = window._correction_codes(cfg1, b1.nodes, b1.node_mask,
                                   xs1[1][:, 0, :])
    keep1 = window._last_write_wins(b1.nodes, b1.node_mask, 12)
    ccase = testing.chain_window_case(0, 16, 6, 33, 32, 32, 256)
    cfgc = testing.chain_window_case_config(ccase)
    stc, xw = testing.chain_window_case_torch(ccase, "cuda")
    win = chains_flat.chain_windows(cfgc, 16, xw).at(0)
    runs = {
        "single (12,33,32,32,256)": ((12, 33, 32, 32, 256), 12, lambda st:
            window.window_apply_cuda(cfg1, st, xs1, mc1, keep1), st1),
        "16 chains (6,33,32,32,256)": ((6, 33, 32, 32, 256), 6, lambda st:
            window.window_chain_apply_cuda(cfgc, st, win.xs_t, win.mcode,
                                           win.keep), stc),
    }
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    result = {"device": smi, "stages": STAGES, "runs": []}
    for name, (shape, t_win, run, state) in runs.items():
        k = shape[4]
        for s in (int(x) for x in a.sizes.split(",")):
            w = window.window_slice_width(k, s)
            if ((s - 1) * w >= k
                    or window.window_smem_bytes(*shape, s) > limit):
                continue
            window.window_cluster_size = lambda *args, _s=s: _s
            scratch = state._replace(pi=state.pi.clone(),
                                     phi_sum=state.phi_sum.clone())
            window._window_lib = lambda: lib
            ms = device_ms(lambda: run(scratch))
            window._window_lib = lambda: plib
            run(scratch)
            torch.cuda.synchronize()
            plib.window_kernel_phases(phases)      # reads and zeroes
            run(scratch)
            torch.cuda.synchronize()
            plib.window_kernel_phases(phases)
            cyc = [phases[i] / t_win for i in range(len(STAGES))]
            result["runs"].append({
                "run": name, "S": s,
                "max_active_clusters": lib.window_kernel_max_clusters(
                    *shape, s),
                "ms_per_window": ms, "us_per_step": 1e3 * ms / t_win,
                "cycles_per_step": sum(cyc[1:10]),
                "stage_cycles_per_step": [round(c, 1) for c in cyc]})
            print(json.dumps(result["runs"][-1]), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
