"""Phase profiles and cluster-size sweeps of the port's kernels on one
NVIDIA GPU: the fused a-MMSB window (mcmc_ammsb_tpu_torch/csrc/
window_kernel.cu), the fused MMSB window (csrc/mmsb_window_kernel.cu)
and the phi kernel's blocks per node (csrc/phi_kernel.cu).

Run from the root of a checkout:

    PYTHONPATH=. python3 scripts/window_phases.py [--kernels window,mmsb,phi]
        [--sizes 2,4,8,16]

window: at the single-chain bench shape (T, B, n, E, K) = (12, 33, 32, 32, 256)
and the chain shape (16 chains of (6, 33, 32, 32, 256)) in the resident
mode, and in the wide mode at the K = 4096 path's (12, 33, 32, 32, 4096)
(in the plan's layout: the step layout, whose chunk covers the slice),
at (6, 33, 32, 32, 8192) and the K = 8192 path's (12, 33, 32, 32, 8192)
(the step layout with one set of rows), at (3, 33, 32, 32, 16384) and
the K = 16384 path's (12, 33, 32, 32, 16384) in the plan's grid layout
(its one plan: clusters of 4 over the card) and in the node-resident
layout beside it, and at (12, 33, 32, 32, 4096) also in the step layout
with one set of rows, for each cluster size S that fits: the clusters the card runs at
once, the device time per window (CUDA events; the device sleeps while
the host queues 50 windows, so the host's launch cost is not in it), and
the clock cycles per step of each stage, from a second build of the
source with -DWINDOW_PHASES (thread 0 of the first CTA adds the cycles
between consecutive barriers into one slot per stage). The K = 16384
windows also run on the build of chip_smoke.PARENT_SRC (the kernel
before the node-resident layout: its chunked layout at that source's
own plan), the same two ways, so that its stages stand beside this
build's in one run.

mmsb: the same for the MMSB window at (T, B, n, E, K) = (12, 33, 32, 32,
64), the --model mmsb --window 12 shape, and (12, 33, 32, 32, 128), for
each cluster size S in 1, 2, 4, 8, 16 that fits (a build with
-DMMSB_PHASES for the stages).

phi: the by-index phi entry at (B, n, K) = (33, 32, 256), the
--phi-impl pallas shape, with G = 1, 2, 4, 8 blocks per node.

Prints one JSON line per run and one with all of them. Imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

MMSB_STAGES = ["init + first gather",
               "theta-noise issue + redirect + wait",
               "neighbor row sums + g_link",
               "p partials pushed + cluster barrier",
               "owners' w pushed + cluster barrier", "sc + phi step",
               "next gather issue + phi' and row-sum partials pushed + "
               "cluster barrier", "normalize + stage",
               "p_e terms, partials pushed + cluster barrier",
               "edge weights", "fan-in + theta step",
               "scatter + final barrier", "(unused)",
               "calibration: bare block barrier",
               "calibration: bare cluster barrier"]
STAGES = ["init + first gather", "gather issue + redirect + wait",
          "partial q pushed + cluster barrier",
          "owners' coefficients pushed + cluster barrier",
          "contrib + phi step", "row-sum partials pushed + cluster barrier",
          "normalize + stage", "edge partials pushed + cluster barrier",
          "fan-in partials", "theta step", "scatter + final barrier",
          "calibration: bare block barrier",
          "calibration: bare cluster barrier"]
# the wide mode's stages in its step layout (window_kernel_step's PHASE
# slots)
WIDE_STAGES = ["init + first gather + first noise",
               "rows of step t-1",
               "a: q partials pushed + noise issue + cluster barrier",
               "b: owners' coefficients pushed + next gather issue + "
               "cluster barrier",
               "c: contrib + phi step",
               "row and edge partials pushed + cluster barrier",
               "d: row sums, prsum, normalize + scratch stores",
               "(unused)", "e: fan-in partials", "e: theta step",
               "scatter + final barrier",
               "calibration: bare block barrier",
               "calibration: bare cluster barrier",
               "wait for the step's rows", "a: q partials (register-tiled)",
               "c: wait for the step's noise"]
# the wide mode's stages in its step layout with one set of rows
# (window_kernel_step1's PHASE slots)
STEP1_STAGES = ["init + first gather", "redirected phi sums",
                "a: theta noise issue + phi noise prefetch + q partials "
                "pushed + cluster barrier",
                "b: owners' coefficients pushed + cluster barrier",
                "c: contrib + phi step (noise from global memory)",
                "row and edge partials pushed + next neighbor rows issue + "
                "cluster barrier",
                "d: row sums, prsum, normalize + scratch stores",
                "e: next node rows issue", "e: fan-in partials",
                "e: theta step", "scatter + final barrier",
                "calibration: bare block barrier",
                "calibration: bare cluster barrier",
                "wait for the step's rows", "a: q partials (register-tiled)",
                "e: wait for the theta noise"]
# the wide mode's stages in its node-resident layout
# (window_kernel_nodes's PHASE slots)
NODES_STAGES = ["init + first node rows + first tiles",
                "redirected phi sums + noise and next rows' L2 prefetch",
                "a: q partials pushed + contrib's first tiles issue + "
                "cluster barrier",
                "b: owners' coefficients pushed + cluster barrier",
                "c: contrib + phi step by tile (noise from global memory) "
                "+ next tiles issue",
                "row and edge partials pushed + cluster barrier",
                "d: row sums, prsum, normalize + scratch stores",
                "d: next step's first tiles issue", "e: fan-in partials",
                "e: next node rows issue + theta step",
                "scatter + final barrier",
                "calibration: bare block barrier",
                "calibration: bare cluster barrier",
                "wait for the step's node rows",
                "a: q partials by tile (register-tiled) + next tiles issue",
                "a and c: waits for the tiles"]
# the wide mode's stages in its grid layout (window_kernel_grid's PHASE
# slots): the grid barriers and the L2 exchange in slots of their own
GRID_STAGES = ["init + first gather",
               "wait for the step's rows + rows of step t-1",
               "a: q partials (register-tiled)",
               "a: q partials pushed + noise issue + cluster barrier",
               "a: the cluster's q of its nodes to L2",
               "a: grid barrier",
               "b: q over the clusters from L2 + owners' coefficients "
               "pushed + next gather issue + cluster barrier",
               "c: contrib + phi step",
               "row and edge partials pushed + cluster barrier",
               "c: the cluster's row and edge sums to L2",
               "c: grid barrier",
               "d: the clusters' row and edge sums from L2",
               "d: row sums, prsum, normalize + scratch stores",
               "e: fan-in partials", "e: theta step", "scatter"]
# the slots of a step's stages, for each kind of stage list (calibration,
# init and scatter left out)
STEP_SLOTS = {"resident": range(1, 10), "step": [*range(1, 10), 13, 14, 15],
              "step1": [*range(1, 10), 13, 14, 15],
              "nodes": [*range(1, 10), 13, 14, 15], "wide": range(1, 10),
              "grid": range(1, 15)}
# its chunked layout's stages (window_kernel_wide's PHASE slots; the same
# in the build of chip_smoke.PARENT_SRC)
CHUNKED_STAGES = ["init", "(unused)",
                  "a: q partials by chunk, pushed + cluster barrier",
                  "b: owners' coefficients pushed + cluster barrier",
                  "(unused)", "c: contrib + phi step + row and edge "
                  "partials by chunk, pushed + cluster barrier", "(unused)",
                  "(unused)", "(unused)", "e: normalize + scratch stores + "
                  "fan-in + theta step by chunk", "scatter + final barrier"]
# the stage list of each layout
LAYOUT_STAGES = {"resident": STAGES, "step": WIDE_STAGES,
                 "step1": STEP1_STAGES, "nodes": NODES_STAGES,
                 "wide": CHUNKED_STAGES, "grid": GRID_STAGES}
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


def _phase_build(kernels, name: str, flag: str, src=None):
    """A second build of csrc/<name>.cu (or of ``src``) with the phase
    counters on."""
    src = src or kernels._CSRC / f"{name}.cu"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = kernels.BUILD_DIR / f"lib{name}_phases.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, flag, "-o",
                    str(out), str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(out))


def run_window(sizes, kernels, result):
    """The fused a-MMSB window: cluster sizes, stages."""
    from mcmc_ammsb_tpu_torch import chains_flat, testing
    from mcmc_ammsb_tpu_torch.ops import window

    import chip_smoke

    plib = window.bind_window_lib(_phase_build(kernels, "window_kernel",
                                               "-DWINDOW_PHASES"))
    plib.window_kernel_phases.argtypes = [ctypes.c_void_p]
    lib = window._window_lib()
    limit = kernels.smem_limit(torch.device("cuda"))
    parent_src = Path(chip_smoke.__file__).resolve().parent / \
        chip_smoke.PARENT_SRC
    old_lib = chip_smoke.ParentWindowLib(
        chip_smoke.build_parent(kernels), window, limit)
    old_plib = chip_smoke.ParentWindowLib(_phase_build(
        kernels, "window_kernel_parent", "-DWINDOW_PHASES", parent_src),
        window, limit)
    old_plib.lib.window_kernel_phases.argtypes = [ctypes.c_void_p]
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
    def wide_run(shape):
        """(the window's launch on a state, its state) at ``shape``."""
        case = testing.window_case(0, *shape)
        cfg = testing.window_case_config(case)
        st, xs = testing.window_case_torch(case, "cuda")
        mc = window._correction_codes(cfg, xs[0].nodes, xs[0].node_mask,
                                      xs[1][:, 0, :])
        keep = window._last_write_wins(xs[0].nodes, xs[0].node_mask,
                                       shape[0])
        return (lambda s: window.window_apply_cuda(cfg, s, xs, mc, keep)), st

    wide, stw = wide_run((12, 33, 32, 32, 4096))
    wide8, st8 = wide_run((6, 33, 32, 32, 8192))
    wide12, st12 = wide_run((12, 33, 32, 32, 8192))
    wide16, st16 = wide_run((3, 33, 32, 32, 16384))
    wide16l, st16l = wide_run((12, 33, 32, 32, 16384))
    runs = {
        "single (12,33,32,32,256)": ((12, 33, 32, 32, 256), 12, lambda st:
            window.window_apply_cuda(cfg1, st, xs1, mc1, keep1), st1,
            lib, plib),
        "16 chains (6,33,32,32,256)": ((6, 33, 32, 32, 256), 6, lambda st:
            window.window_chain_apply_cuda(cfgc, st, win.xs_t, win.mcode,
                                           win.keep), stc, lib, plib),
        "wide (12,33,32,32,4096)": ((12, 33, 32, 32, 4096), 12, wide, stw,
                                    lib, plib),
        # the plan's step layout against the one-set layout on one shape
        "wide (12,33,32,32,4096), one set of rows": (
            (12, 33, 32, 32, 4096), 12, wide, stw, lib, plib, "step1"),
        "wide (6,33,32,32,8192)": ((6, 33, 32, 32, 8192), 6, wide8, st8,
                                   lib, plib),
        "wide (12,33,32,32,8192)": ((12, 33, 32, 32, 8192), 12, wide12,
                                    st12, lib, plib),
        "wide (3,33,32,32,16384)": ((3, 33, 32, 32, 16384), 3, wide16,
                                    st16, lib, plib),
        "wide (3,33,32,32,16384), node-resident layout": (
            (3, 33, 32, 32, 16384), 3, wide16, st16, lib, plib, "nodes"),
        "wide (3,33,32,32,16384), parent build": (
            (3, 33, 32, 32, 16384), 3, wide16, st16, old_lib, old_plib),
        "wide (12,33,32,32,16384)": ((12, 33, 32, 32, 16384), 12, wide16l,
                                     st16l, lib, plib),
        "wide (12,33,32,32,16384), node-resident layout": (
            (12, 33, 32, 32, 16384), 12, wide16l, st16l, lib, plib,
            "nodes"),
        "wide (12,33,32,32,16384), parent build": (
            (12, 33, 32, 32, 16384), 12, wide16l, st16l, old_lib,
            old_plib),
    }
    real_plan, real_lib = window.window_plan, window._window_lib
    for name, (shape, t_win, run, state, tlib, phlib, *forced) in \
            runs.items():
        k = shape[4]
        mode = forced[0] if forced else real_plan(*shape, limit)[1]
        if tlib is old_lib:
            mode = old_lib.plan(*shape)[2]      # at its own plan
        grid = real_plan(*shape, limit) if mode == "grid" else None
        for s in ([grid[0]] if grid else sizes):
            w = window.window_slice_width(k, s)
            if not grid and (s - 1) * w >= k:
                continue
            if tlib is old_lib:
                if s != old_lib.plan(*shape)[0]:
                    continue
                wc = old_lib.plan(*shape)[1]
                smem = old_lib.lib.window_kernel_smem_bytes(
                    *shape, s, wc, window.LAYOUTS[mode])
            else:
                wc = (window.step_chunk(k, s) if mode in ("step", "step1")
                      else window.NODES_TILE if mode == "nodes"
                      else real_plan(*shape, limit)[2])
                smem = window.window_layout_bytes(shape, (s, mode, wc))
            if smem > limit:
                continue
            window.window_plan = lambda *args, _p=(s, mode, wc): _p
            scratch = state._replace(pi=state.pi.clone(),
                                     phi_sum=state.phi_sum.clone())
            window._window_lib = lambda: tlib
            ms = device_ms(lambda: run(scratch))
            window._window_lib = lambda: phlib
            phases_of = (phlib if phlib is plib
                         else phlib.lib).window_kernel_phases
            run(scratch)
            torch.cuda.synchronize()
            phases_of(phases)                       # reads and zeroes
            run(scratch)
            torch.cuda.synchronize()
            phases_of(phases)
            stages = LAYOUT_STAGES[mode]
            cyc = [phases[i] / t_win for i in range(len(stages))]
            clusters = (lib if tlib is lib else
                        old_lib.lib).window_kernel_max_clusters(
                *shape, s, wc, window.LAYOUTS[mode])
            result["runs"].append({
                "run": name, "S": s, "mode": mode, "wc": wc,
                "smem_per_cta": smem,
                "max_active_clusters": clusters,
                "ms_per_window": ms, "us_per_step": 1e3 * ms / t_win,
                "cycles_per_step": sum(cyc[i] for i in STEP_SLOTS[mode]),
                "stage_cycles_per_step": [round(c, 1) for c in cyc],
                "stages": stages})
            print(json.dumps(result["runs"][-1]), flush=True)
    window.window_plan, window._window_lib = real_plan, real_lib


def run_mmsb(kernels, result):
    """The fused MMSB window: every cluster size that fits, stages."""
    from mcmc_ammsb_tpu_torch import testing
    from mcmc_ammsb_tpu_torch.ops import window, window_mmsb

    plib = window_mmsb.bind_mmsb_lib(_phase_build(
        kernels, "mmsb_window_kernel", "-DMMSB_PHASES"))
    plib.mmsb_window_phases.argtypes = [ctypes.c_void_p]
    lib = window_mmsb._mmsb_lib()
    limit = kernels.smem_limit(torch.device("cuda"))
    phases = (ctypes.c_ulonglong * 16)()
    for shape in [(12, 33, 32, 32, 64), (12, 33, 32, 32, 128)]:
        t_win, k = shape[0], shape[4]
        case = testing.mmsb_window_case(1, *shape)
        cfg = testing.window_case_config(case)
        state, xs = testing.mmsb_window_case_torch(case, "cuda")
        b = xs[0]
        mcode = window._correction_codes(cfg, b.nodes, b.node_mask, xs[1])
        keep = window._last_write_wins(b.nodes, b.node_mask, t_win)
        for s in (1, 2, 4, 8, 16):
            w = window.window_slice_width(k, s)
            smem = window_mmsb.mmsb_window_smem_bytes(*shape, s)
            if (s - 1) * w >= k or smem > limit:
                continue
            window_mmsb.mmsb_window_cluster_size = lambda *a, _s=s: _s
            scratch = state._replace(pi=state.pi.clone(),
                                     phi_sum=state.phi_sum.clone())

            def run():
                window_mmsb.mmsb_window_apply_cuda(cfg, scratch, xs, mcode,
                                                   keep)

            window_mmsb._mmsb_lib = lambda: lib
            ms = device_ms(run)
            window_mmsb._mmsb_lib = lambda: plib
            run()
            torch.cuda.synchronize()
            plib.mmsb_window_phases(phases)        # reads and zeroes
            run()
            torch.cuda.synchronize()
            plib.mmsb_window_phases(phases)
            cyc = [phases[i] / t_win for i in range(len(MMSB_STAGES))]
            result["runs"].append({
                "run": f"mmsb {shape}", "S": s, "smem_per_cta": smem,
                "ms_per_window": ms, "us_per_step": 1e3 * ms / t_win,
                "cycles_per_step": sum(cyc[1:11]),
                "stage_cycles_per_step": [round(c, 1) for c in cyc]})
            print(json.dumps(result["runs"][-1]), flush=True)
        window_mmsb._mmsb_lib = lambda: lib


def run_phi(kernels, result):
    """The by-index phi entry at the --phi-impl pallas shape with G
    blocks per node, in turns (1, 2, 4, 8, 8, 4, 2, 1)."""
    from mcmc_ammsb_tpu_torch import testing
    from mcmc_ammsb_tpu_torch.ops import phi_pallas

    case = testing.phi_case(0, 33, 32, 256)
    cfg = testing.phi_case_config(case)
    t = {f: torch.as_tensor(case[f], device="cuda") for f in
         ("pi", "phi_sum", "beta", "nodes", "nbrs", "y", "noise")}
    args = (cfg, t["pi"], t["phi_sum"], t["beta"], t["nodes"], t["nbrs"],
            t["y"], case["step_count"], t["noise"])
    want = phi_pallas.phi_update_rows_torch(*args)
    for g in (1, 2, 4, 8, 8, 4, 2, 1):
        phi_pallas.phi_cluster_size = lambda *a, _g=g: _g
        got = phi_pallas.phi_update_rows_cuda(*args)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        ms = device_ms(lambda: phi_pallas.phi_update_rows_cuda(*args))
        result["runs"].append({"run": "phi by-index (33,32,256)", "G": g,
                               "ms_per_call": ms, "max_abs_diff": err})
        print(json.dumps(result["runs"][-1]), flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--kernels", default="window,mmsb,phi")
    p.add_argument("--sizes", default="2,4,8,16")
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("window_phases: no CUDA device available", file=sys.stderr)
        return 1
    from mcmc_ammsb_tpu_torch import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    result = {"device": smi, "stages": STAGES, "mmsb_stages": MMSB_STAGES,
              "runs": []}
    which = a.kernels.split(",")
    if "window" in which:
        run_window([int(x) for x in a.sizes.split(",")], kernels, result)
    if "mmsb" in which:
        run_mmsb(kernels, result)
    if "phi" in which:
        run_phi(kernels, result)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
