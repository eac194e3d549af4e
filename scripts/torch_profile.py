"""Profile the port's CLI paths on one NVIDIA GPU.

Run from the root of a checkout (the package must be importable):

    PYTHONPATH=. python3 scripts/torch_profile.py [--reps 5]
        [--paths single,wide,chains,mmsb,phi,hostphi,hoststep,hostbf,
                 powerlaw,mmsbchains,hostmmsb,vmap,refrng,refplain,refphi,
                 devbf,devbfalt,devbfnon,mesh,refkernel,checkpoint]
        [--out FILE]

Each path at N=317,080 (``--synthetic 317080,7``), the CLI's defaults
otherwise:

  single  the a-MMSB main path, K=256: window 12, 1008 steps per call
          (84 windows);
  wide    the same at ``-k 4096`` (pi 5.2 GB): every window in the
          window kernel's wide mode, 1008 steps per call;
  chains  ``--num-chains 16 --node-coin alternate``, K=256: window
          96 // 16 = 6, 504 steps per call (84 windows of 16 chains);
  mmsb    ``--model mmsb --window 12``, K=64: 1008 steps per call (84
          windows);
  phi     ``--phi-impl pallas --device-sampling``, K=256: 1000 steps per
          call, no windows (kernels are counted per step);
  hostphi ``--phi-impl pallas -i 500``, K=256: host-sampled, private
          draws, chunks of 200 steps, 1000 steps per call;
  hoststep ``--no-device-sampling --no-shared-neighbors --steps-per-call 1
          --phi-impl pallas``, K=256: one train_step per step, 300 steps
          per call;
  hostbf  ``--no-device-sampling -s BFLink -i 200``, K=256: chunks of 200
          steps, 400 steps per call;
  powerlaw ``--synthetic-powerlaw 317080,6.6,343,256 --edgeset perfect
          --ds-link-cap 64``, K=256: device-sampled, no windows (65 node
          lanes), 1000 steps per call;
  mmsbchains ``--model mmsb --num-chains 4``, K=64: the MMSB chain engine
          (no windows: batched torch ops), 500 steps per call;
  hostmmsb ``--model mmsb --no-device-sampling -i 200``, K=64: host
          batches, private draws, chunks of 200 steps, 400 steps per call;
  vmap    ``--num-chains 3 --chain-engine vmap``, K=256: three whole
          single-chain states advanced in turn, no windows, 200 steps per
          call;
  refrng  ``--rng reference -i 200``, K=256: host batches, private
          draws from the reference streams (one launch of each
          ref_rng_kernel.cu entry per chunk and family), chunks of 200
          steps, 400 steps per call;
  refplain the same with ``--no-ref-rng-block -i 10``: the reference
          streams drawn by the plain PyTorch version on the card, one
          chunk of 10 steps per call;
  refphi  ``--rng reference --phi-impl pallas -i 200``, K=256: the same
          draws, the by-index phi kernel, 400 steps per call;
  devbf   ``-s BFLink``, K=256: device-sampled breadth-first batches,
          private draws, no windows, 1000 steps per call;
  devbfalt ``-s BF --node-coin alternate``, K=256: 1000 steps per call;
  devbfnon ``-s BFNonLink``, K=256: 1000 steps per call;
  mesh    ``--mesh 1,1``, K=256: the main path through the row-sharded
          learner in a process group of size 1 (NCCL) that the script
          starts and ends: per window one row fetch (an all-reduce), one
          window-kernel launch on the fetched rows, the local write-back;
          1008 steps per call;
  refkernel  not a training path: the reference RNG's phi-noise draws
          of one 200-step chunk of real host batches (64 lanes, K=256),
          through csrc/ref_rng_kernel.cu (CUDA events, 5 calls) and through
          the plain version (one call, host clock): ms of each, and that
          they are bit-equal;
  checkpoint  not a training path: the a-MMSB main path's learner
          (K=256, pi 325 MB) saved and loaded three times in each flavor,
          ``np.savez`` (what ``save_checkpoint`` writes) and
          ``np.savez_compressed``: seconds of each save and load, host
          clock, and the file's bytes.

The four host-sampled and power-law paths need a tree that has them; a
parent tree is profiled with ``--paths single,chains,mmsb,phi``. For a
host-sampled path the result also has ``sampling_stage_share`` (the
share of the calls before the profiled one that the training thread
spent waiting for its batches and copying them to the device) and ``sampler_ms_per_step`` (the
host sampler alone, timed on a second sampler: one ``sample_many`` of a
chunk, or 50 ``sample`` calls at steps_per_call 1).

For each: one warm-up call, then ``--reps`` unprofiled calls timed on the
host clock around ``Learner.run`` (which ends in a synchronize): updates/s
per call (each chain's steps count). Then one call under torch.profiler:
the CUDA kernels it launched (events on the device), their count per
window, the device-busy share (summed kernel time over the call's wall
time) and the largest kernels. Then one more call traced by stage
(``utils/profiling.profile_trace``, what ``--profile`` prints): device
seconds per stage (``stage_device_s``) and those of device work whose
launch call the trace lacks (``stage_unlinked_s``); skipped for a
parent tree without ``utils/profiling.py``. Prints one JSON line; with ``--out`` also
writes it there. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

PATHS = {
    "single": (["--synthetic", "317080,7", "-k", "256"], 1008),
    "wide": (["--synthetic", "317080,7", "-k", "4096"], 1008),
    "chains": (["--num-chains", "16", "--node-coin", "alternate",
                "--synthetic", "317080,7", "-k", "256"], 504),
    "mmsb": (["--model", "mmsb", "--synthetic", "317080,7", "-k", "64",
              "--window", "12"], 1008),
    "phi": (["--phi-impl", "pallas", "--device-sampling", "--synthetic",
             "317080,7", "-k", "256"], 1000),
    "hostphi": (["--phi-impl", "pallas", "-i", "500", "--synthetic",
                 "317080,7", "-k", "256"], 1000),
    "hoststep": (["--no-device-sampling", "--no-shared-neighbors",
                  "--steps-per-call", "1", "--phi-impl", "pallas",
                  "--synthetic", "317080,7", "-k", "256"], 300),
    "hostbf": (["--no-device-sampling", "-s", "BFLink", "-i", "200",
                "--synthetic", "317080,7", "-k", "256"], 400),
    "powerlaw": (["--synthetic-powerlaw", "317080,6.6,343,256", "--edgeset",
                  "perfect", "--ds-link-cap", "64", "-k", "256"], 1000),
    "mmsbchains": (["--model", "mmsb", "--num-chains", "4", "--synthetic",
                    "317080,7", "-k", "64"], 500),
    "hostmmsb": (["--model", "mmsb", "--no-device-sampling", "-i", "200",
                  "--synthetic", "317080,7", "-k", "64"], 400),
    "vmap": (["--num-chains", "3", "--chain-engine", "vmap", "--synthetic",
              "317080,7", "-k", "256"], 200),
    "refrng": (["--rng", "reference", "-i", "200", "--synthetic",
                "317080,7", "-k", "256"], 400),
    "refplain": (["--rng", "reference", "--no-ref-rng-block", "-i", "10",
                  "--synthetic", "317080,7", "-k", "256"], 10),
    "refphi": (["--rng", "reference", "--phi-impl", "pallas", "-i", "200",
                "--synthetic", "317080,7", "-k", "256"], 400),
    "devbf": (["-s", "BFLink", "--synthetic", "317080,7", "-k", "256"],
              1000),
    "devbfalt": (["-s", "BF", "--node-coin", "alternate", "--synthetic",
                  "317080,7", "-k", "256"], 1000),
    "devbfnon": (["-s", "BFNonLink", "--synthetic", "317080,7", "-k",
                  "256"], 1000),
    "mesh": (["--synthetic", "317080,7", "-k", "256", "--mesh", "1,1"],
             1008),
}


def time_checkpoint(reps: int = 3) -> dict:
    """Seconds to save and to load the main path's learner (K=256), in
    both npz flavors, into a temporary directory."""
    import os
    import tempfile

    from mcmc_ammsb_tpu_torch import checkpoint

    _, _, lrn = make_learner(PATHS["single"][0])
    lrn.run(1008)
    out = {"path": "checkpoint", "K": lrn.cfg.K, "N": lrn.cfg.N}
    with tempfile.TemporaryDirectory() as tmp:
        for flavor, compress in (("savez", False), ("savez_compressed",
                                                    True)):
            path = os.path.join(tmp, flavor)
            saves, loads = [], []
            for _ in range(reps):
                t0 = time.perf_counter()
                checkpoint.save_checkpoint(path, lrn, compress=compress)
                saves.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                checkpoint.load_checkpoint(path, lrn)
                torch.cuda.synchronize()
                loads.append(time.perf_counter() - t0)
            out[flavor] = {"bytes": os.path.getsize(path),
                           "save_s": saves, "load_s": loads}
    return out


def time_ref_rng() -> dict:
    """The phi noise of one 200-step --rng reference chunk: the kernel
    against the plain version, on the same CUDA seeds and real host
    masks."""
    from mcmc_ammsb_tpu_torch.rng import reference, refblock
    from mcmc_ammsb_tpu_torch.sampling import MiniBatchSampler

    cfg, _, lrn = make_learner(PATHS["refrng"][0])
    mask = torch.as_tensor(MiniBatchSampler(cfg, lrn.graph, lrn.split)
                           .sample_many(200).node_mask, device="cuda")
    lrn.close()
    seeds = reference.make_seeds(cfg.phi_seed, mask.shape[1], "cuda")
    got = refblock.randn_lanes(seeds, cfg.K, mask)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        refblock.randn_lanes(seeds, cfg.K, mask)
    end.record()
    end.synchronize()
    t0 = time.perf_counter()
    want = reference.randn_lanes(seeds, cfg.K, mask)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    return {"path": "refkernel", "shape": [*mask.shape, cfg.K],
            "drawing_lanes": int(mask.sum()),
            "kernel_ms": start.elapsed_time(end) / 5,
            "plain_ms": plain_s * 1e3,
            "bit_equal": all(torch.equal(a, b) for a, b in zip(got, want))}


def make_learner(flags):
    """The learner the port's CLI builds for ``flags``, on the card."""
    from mcmc_ammsb_tpu_torch import cli
    from mcmc_ammsb_tpu_torch import data
    from mcmc_ammsb_tpu_torch.data import (Graph, generate_sets,
                                           synthetic_edges)

    args = cli.build_arg_parser().parse_args(flags)
    cli.resolve_fast_defaults(args)
    cfg = cli.config_from_args(args)
    if getattr(args, "synthetic_powerlaw", None):
        nn, deg, cap, comms = args.synthetic_powerlaw.split(",")
        n, u, v = data.synthetic_powerlaw_edges(
            int(nn), float(deg), max_degree=int(cap),
            num_communities=int(comms), seed=1)
    else:
        nn, deg = (int(x) for x in args.synthetic.split(","))
        n, u, v = synthetic_edges(nn, deg, seed=1)
    split = generate_sets(n, u, v, args.heldout_ratio)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    if getattr(args, "window_auto", False) and cfg.max_batch_nodes > 64:
        cfg = cfg.replace(window=0)              # the CLI's fallback
    if hasattr(cli, "resolve_kernel_window"):    # the kernel's rule
        cfg = cli.resolve_kernel_window(args, cfg, torch.device("cuda"))
    if args.num_chains > 1:
        cfg = cfg.replace(device_sampling=True)
    lrn = cli.make_learner(args, cfg, graph, split, "cuda")
    return lrn.cfg, max(1, args.num_chains), lrn


def profile_path(name: str, reps: int) -> dict:
    """``_profile_path``, in a process group of size 1 for a sharded
    path."""
    if "--mesh" not in PATHS[name][0]:
        return _profile_path(name, reps)
    import torch.distributed as dist

    from mcmc_ammsb_tpu_torch.parallel import multihost

    started = multihost.initialize(device="cuda")
    try:
        return _profile_path(name, reps)
    finally:
        if started:
            dist.destroy_process_group()


def _profile_path(name: str, reps: int) -> dict:
    flags, steps = PATHS[name]
    cfg, chains, lrn = make_learner(flags)
    lrn.run(steps)                                   # warm-up
    seconds = []
    for _ in range(reps):
        t0 = time.perf_counter()
        lrn.run(steps)
        seconds.append(time.perf_counter() - t0)
    rates = [chains * steps / s for s in seconds]
    host = {}
    if not cfg.device_sampling:
        from mcmc_ammsb_tpu_torch.sampling import MiniBatchSampler

        spc = max(1, cfg.steps_per_call)
        second = MiniBatchSampler(cfg, lrn.graph, lrn.split, seed=99)
        t0 = time.perf_counter()
        if spc > 1:
            second.sample_many(spc)
            per_step = (time.perf_counter() - t0) / spc
        else:
            for _ in range(50):
                second.sample()
            per_step = (time.perf_counter() - t0) / 50
        # single batches (steps_per_call 1) are always numpy-sampled
        host = {"sampler": "native" if lrn.sampler.use_native and spc > 1
                else "numpy",
                "sampler_ms_per_step": 1e3 * per_step,
                "sampling_stage_share": lrn.timers.seconds["sampling"]
                / lrn.timers.seconds["total"]}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lrn.run(steps)
        wall = time.perf_counter() - t0
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in device if not e.name.startswith("Memcpy")
               and not e.name.startswith("Memset")]
    busy_us = sum(e.time_range.elapsed_us() for e in device)
    by_name = {}
    for e in kernels:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    # kernels per window on the windowed paths, per step on the others
    windows = steps // cfg.window if cfg.window > 1 else steps
    # the device time of each stage of one more call (the --profile
    # table's numbers)
    stages = {}
    try:
        from mcmc_ammsb_tpu_torch.utils import profiling
    except ImportError:                  # a parent tree without it
        profiling = None
    if profiling is not None:
        traced = profiling.profile_trace(lambda: lrn.run(steps))
        stages = {"stage_device_s": traced["stages"],
                  "stage_unlinked_s": traced["unlinked_seconds"]}
    if hasattr(lrn, "close"):
        lrn.close()                      # stops the prefetch thread
    return {
        "path": name, "window": cfg.window, "steps_per_call": steps,
        "windows_per_call": windows, "chains": chains,
        "updates_per_s": rates,
        "profiled_wall_s": wall,
        "device_events": len(device), "kernel_launches": len(kernels),
        "launches_per_window": len(kernels) / windows,
        "device_busy_share": busy_us * 1e-6 / wall, **host, **stages,
        "top_kernels": [{"name": n[:80], "us": t, "launches": c}
                        for n, (t, c) in top],
    }


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--paths", default="single,chains,mmsb,phi")
    p.add_argument("--out", default=None)
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    paths = []
    for n in a.paths.split(","):
        paths.append(time_checkpoint() if n == "checkpoint"
                     else time_ref_rng() if n == "refkernel"
                     else profile_path(n, a.reps))
        print(json.dumps(paths[-1]), file=sys.stderr, flush=True)
    result = {"device": smi, "torch": torch.__version__, "paths": paths}
    line = json.dumps(result)
    print(line)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
