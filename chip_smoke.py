"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is not 0:
  1. device  — a CUDA device is required; prints the card's name and
               power limit as nvidia-smi reports them;
  2. build   — compiles the four kernels from csrc/ with nvcc, one
               process per source, the window kernel's source from before
               its wide mode's step layout (PARENT_SRC) and the native
               host library (csrc/sampler.cpp) with g++, all started
               together;
     native  — the native CHD build and the numpy build give
               byte-equal perfect-hash tables on the bench graph's
               training edges (E ~ 1.1 M), with the seconds of each;
     membership — on the card, at N=317,080: has_edges of the perfect,
               csr, sorted and cuckoo backends equals the adjacency
               backend's answer exactly on one [200, 33, 32] block of
               training queries (nodes x neighbors; padded lanes hold the
               sentinel N in the even steps and id 0 in the odd ones) and
               on 10^6 pairs of which half are true edges, with the ms of
               each backend on the block;
  3. kernel  — each kernel against its plain PyTorch version on the same
               CUDA operands, with the time per call of each, its bound
               (the larger of the bytes it must move over 3.35 TB/s and
               its float32 operations over 67 TFLOP/s, from this run's
               inputs) and each version's distance to a float64
               evaluation:
               the fused a-MMSB window kernel (gather, T steps on a
               thread-block cluster that splits K, scatter; it writes
               pi in place, so each version gets its own copy of the
               state) in its resident mode at (T, B, n, E, K) = (12, 33,
               32, 32, 256), the bench shape, (3, 6, 7, 5, 12), (12, 33,
               32, 32, 100), (48, 33, 32, 32, 256) (a cluster of 16) and
               (12, 33, 32, 32, 1024), the com-youtube rung's window,
               and in its wide mode (staged rows in a global scratch) at
               (12, 33, 32, 32, 4096), the -k 4096 path's and the
               com-lj rung's, and the
               ragged (12, 33, 32, 32, 2050) (4-byte copies) in its step
               layout (a step's rows in shared memory, bulk copies) and
               at (6, 33, 32, 32, 8192) and (3, 33, 32, 32, 16384) in its
               chunked layout, with its mode, layout, cluster size, chunk
               width, shared memory per CTA (equal to the rule's) and us
               per step; its chain mode (one
               cluster per chain) at (C, T, B, n, E, K) = (16, 6, 33, 32,
               32, 256), the bench chain shape, (3, 4, 9, 8, 8, 16), (2,
               3, 6, 7, 5, 12) and, wide, (2, 12, 33, 32, 32, 2048), also
               bit-equal to C single-chain launches — both no farther
               from float64 than 2x the plain version; the resident mode
               bit-equal to the build of PARENT_SRC at every resident
               shape above, float32 and bf16 pi, with both timed in turns
               at the main and the chain shapes, and the wide mode timed
               in turns against PARENT_SRC's (its chunked layout, at the
               plan of its own rule) at the four wide shapes and the
               wide chain shape, with the layout each took; both phi entries
               (pre-gathered, by index) at (B, n, K) = (33, 32, 256),
               (64, 32, 256) (the host-sampled paths' 64 node lanes),
               (5, 7, 12), the ragged (33, 32, 100) and (33, 32, 4096)
               (neighbor rows staged in chunks) — normwise
               rtol 1e-5, atol 1e-8 (see max_err) and no farther from
               float64 than 2x the plain version; the fused MMSB window
               (gather, T steps on a cluster whose CTAs own slices of B
               and theta, scatter; each version on its own copy of the
               state) at (T, B, n, E, K) = (1, 33, 32, 32, 64), (12,
               33, 32, 32, 64), (3, 6, 7, 5, 12), (12, 33, 32, 32, 128),
               (12, 33, 32, 32, 256) (a cluster of 16) and (12, 33, 32,
               32, 50) (13 CTAs, a ragged last slice), with its
               cluster size, shared memory per CTA and us per step —
               at T=1 normwise rtol 1e-5, past it (the 1/theta
               conditioning, docs/design.md "Windowed MMSB tolerances")
               finite and no farther from float64 than 2x the plain
               version; theta bit-symmetric at every shape; the
               reference RNG's three entries (csrc/ref_rng_kernel.cu: one
               thread per stream, a chunk per launch) against the plain
               version on the same CUDA seeds, values and seeds bit for
               bit, at the main path's launch shapes: randn_lanes over a
               200-step chunk of a real host mask of 64 lanes, K=256 (one
               launch; the plain version takes ~1 s per step, so it
               draws the last 10 steps from the seeds a 190-step launch
               leaves, and the 200-step launch's first 190 equal that
               launch's) and at (200, 256, 2), neighbors_lanes at (200,
               64, 32) with N = 317,080, gamma_lanes over 317,080 x 32
               lanes and 8 column blocks (the pi init) and with a = 0.5
               and 0.3 (the boost pre-pass) on 1280 lanes, with the
               kernel's and the plain version's times;
     bf16    — the window kernel's bf16 row mode (bfloat16 pi storage) at
               the main path's, the chain path's and the com-youtube
               rung's shapes and in the wide mode at the -k 4096 path's:
               the bf16
               launch equals the float32 launch on the upcast rows,
               rounded to nearest-even, bit for bit; against the plain
               version at bf16 the stored values are equal or 1 ulp
               apart, farther only within their float32 gap
               (testing.bf16_gaps), the counts printed; its ms against
               the float32 launch's in the same call and its bound with
               pi's row bytes halved;
     sort    — ops/sort.bitonic_sort_rows on the card equals torch.sort;
  4. slice   — hoisted loops on the GPU against the same loops on the
               CPU from one state and one operand tuple, N=300 (the
               states' pi drawn by the numpy host law, host_law_pi): the
               a-MMSB windows (normwise rtol 1e-5, atol 1e-8), the
               MMSB windows (the measured envelope of
               tests/test_window_mmsb.py), --phi-impl pallas with
               private draws (normwise rtol 1e-5, atol 1e-8), the flat
               chain engine with C=3 (4 fused chain launches, normwise
               rtol 1e-5, atol 1e-8), 23 host-sampled steps from the
               same host batches, one train_step per step with
               --phi-impl pallas (23 launches of the pre-gathered phi
               entry) and one scanned chunk with the jnp phi (both
               normwise rtol 1e-5, atol 1e-8); then the MMSB learner on
               the GPU recovers a planted partition (the JAX package's
               own check, tests/test_mmsb.py:84); 23 steps of the MMSB
               chain engine with C=3 (shared draws; torch ops, no kernel)
               and of host-sampled MMSB (private draws) GPU against CPU
               inside the MMSB envelope; the MMSB chain learner on the
               planted partition: every chain's diag(B) - off(B) > 0.5;
  5. main    — the port's CLI in-process, at N=317,080:
               the a-MMSB main path (K=256, window 12, 2000 steps): the
               fused window kernel launches once per window, ppx falls
               below ppx[0]; the same at -k 4096 (pi 5.2 GB): window 12
               unclamped, as many launches as at K=256, every one in the
               wide mode, ppx falls, its updates/s and peak memory;
     sharded — the multi-GPU paths on the one card, through NCCL process
               groups of size 1 and the sharded code (row fetch over the
               model ranks, write-back, collectives): the CLI at --mesh
               1,1 on the main path (2000 steps; as many window-kernel
               launches as the main path, its steady-state updates/s
               beside the main path's, ppx falls); one ShardedLearner
               window at (1,1) on the bench window case and on the -k
               4096 path's (the wide mode) (fetch, ONE launch of the
               window kernel on the fetched rows as its table, local
               write-back) against the single-GPU kernel and its own
               --window-impl jnp version, normwise rtol 1e-5, with its
               ms; ShardedChainLearner with G = 1, C = 4,
               window 6, 1008 steps (168 launches of the chain entry,
               every chain's ppx falls); --partitioned-ingest --mesh 1,1
               on the bench graph written as a SNAP file (1000 steps, 82
               window launches, the ingest seconds, ppx falls);
               --model mmsb --window 12 (K=64, 1000 steps): the fused
               MMSB kernel launches 2 x (500 // 12) = 82 times and no
               other window entry, ppx finite and at the
               structure-free plateau (see run_mmsb_main);
               --phi-impl pallas --device-sampling (K=256, 1000 steps):
               the by-index phi kernel launches 1000 times, the window
               kernel never, ppx falls below ppx[0];
               --num-chains 16 --node-coin alternate (K=256, window
               96 // 16 = 6, 2 x 504 steps): the fused chain entry
               launches 2 x 84 = 168 times with C = 16 and the single-chain
               entry
               never, every chain's ppx falls below its ppx[0]; the
               aggregate rate and the seconds of the chains' init are
               printed; then a small --num-chains 3 --rhat-draws 2 run
               logs a finite R-hat line;
               the host-sampled paths and the perfect-hash main path
               (HOST_RUNS), each with ppx finite and below ppx[0] at the
               last evaluation and exact launch counts:
               --phi-impl pallas (K=256, 1000 steps: host batches from
               the native sampler, private draws, chunks of 200): 1000
               by-index phi launches, no pre-gathered one;
               --no-device-sampling --no-shared-neighbors
               --steps-per-call 1 --phi-impl pallas (300 steps): 300
               pre-gathered phi launches, no by-index one;
               --no-device-sampling -s BFLink (400 steps, jnp phi): no
               kernel launch;
               --synthetic-powerlaw 317080,6.6,343,256 --edgeset perfect
               --ds-link-cap 64 (1000 device-sampled steps; 65 node lanes
               switch the auto window off): both edge sets are perfect
               hashes, no kernel launch;
               the engines that launch no kernel (NEW_RUNS), each with a
               finite series and its updates/s: --model mmsb --num-chains
               4 (K=64, 1000 steps; every chain within 5% of its ppx[0]
               on the structure-free graph), --model mmsb
               --no-device-sampling (K=64, 400 steps), --chain-engine vmap
               --num-chains 3 (K=256, 200 steps, falling);
               --calc-train-ppx --train-ppx-ratio 0.00001 on the main path
               (82 window launches; a finite train_ppx line after every
               evaluation); --dump-data then --load-data: the main path's
               ppx[0] from the cache;
               the reference-RNG and device breadth-first paths
               (REF_RUNS), exact launch counts: --rng reference (K=256,
               400 host-sampled steps in chunks of 200: 4 randn_lanes,
               2 neighbors_lanes, 2 gamma_lanes launches), the same with
               --phi-impl pallas (200 steps, also 200 by-index phi
               launches), -s BFLink (1000 device-sampled steps), -s BF
               --node-coin alternate (400), -s BFNonLink (400),
               --num-chains 4 -s BFLink (200); ppx falls on BFLink (every
               chain) and the reference RNG (the BF mix rises on this
               graph, as in the JAX package and with host sampling); then
               --profile --auto-tune-window on the main path: no window
               candidate fails, the stage table comes from a trace of the
               card's kernels, window_kernel its largest stage;
     bf16    — the CLI with --pi-dtype bfloat16: the main path (2000
               steps, 164 window launches on bf16 rows, ppx falls and ends
               within 5% of the float32 main path's; the peak device
               memory of both runs), --num-chains 4 --window 6 (504 steps,
               84 chain launches on bf16 rows, every chain falls) and
               --mesh 1,1 (1000 steps, 82 launches on the fetched float32
               rows, write-backs into the bf16 shard);
     api     — --rng reference against --no-ref-rng-block over 20 steps
               (the kernel's draws and init are the plain version's: every
               state field and seed bit-equal), --theta-init libstdc++
               (theta equals the native stream), window_correction='auto'
               (run as 'always') against 'always' over 1008 main-path
               steps (bit-equal, the dirty windows counted);
  6. refckpt — --checkpoint-ref after a main-path run of 1000 steps
               (evaluations every 100): the file's bytes and the export's
               seconds, the strict parse of the reference binary's checks
               accepts it in the default build layout; --restore-ref of it
               for 1000 steps (80 window launches): the first ppx after the
               import within 2% of the exporter's last;
     checkpoint — through the API on the card at N=317,080: run, save, run
               against a fresh learner, restore, run, every state field
               bit-equal and the kernel launches of the two second halves
               equal, with the file's size and the save and load seconds:
               the a-MMSB main path (K=256, window 12, 2 x 1008 steps, 84
               window launches each), --model mmsb --window 12 (K=64, 2 x
               504), host-sampled --phi-impl pallas (K=256, 2 x 400 steps
               in chunks of 200, pending batches in the file, 400 by-index
               phi launches each), --num-chains 4 (K=256, 2 x 252
               steps, 21 chain launches each, a 1.3 GB file) and --mesh
               1,1 (the sharded checkpoint: rank 0 writes the global
               state and every rank's generators through NCCL
               collectives, each rank reads its rows; 84 window launches
               each), and in the directory backend (a DCP directory) the
               main path and --mesh 1,1 (each rank's rows as DTensor
               shards); then through
               the CLI on the main path: --checkpoint, then --restore
               logs "restored checkpoint ... (step=1001)" and its ppx
               stays below the first run's ppx[0]; --checkpoint-interval
               500 --checkpoint-backend orbax: the async save of step 1001
               equals the synchronous exit save leaf for leaf, and a run
               restored from the async save of step 501 ends in the exit
               save's state, bit for bit;
  7. ladder — ladder.run_rung on every rung at its full graph size (N =
               12,008, 310,497, 1,086,089 and 3,997,409: the power-law
               surrogates, whose N, E and max fan-out must equal the JAX
               package's artifacts, bench_results/ppx_*.json), 2000 steps
               each with an evaluation every 1000; the rungs' host data
               (generation, split, CSR) is built in two worker processes
               started with the script, so it overlaps the earlier
               phases; each rung prints its stage seconds (data, split,
               graph, edge sets, init, training, evaluations), updates/s,
               ppx series, peak device memory beside pi's bytes and the K
               rule's working set (the peak minus pi must stay within
               it), and its window launches by mode, layout, pi dtype and
               K: none at ca-HepPh (window 0), all resident at com-dblp
               (K = 256) and com-youtube (K = 1024), all in the wide
               mode's step layout on bf16 rows at com-lj (K = 4096, the
               reference K, pi 32.75 GB: the K rule on this card); every
               ppx finite and ppx at step 2000 below ppx[0]; com-lj's
               init seconds beside the host law's, estimated from this
               host's rate of numpy Gamma draws;
     entry   — graft.entry()'s step once on the card: step_count 2, pi
               finite with rows summing to 1 within 1e-5;
then a JSON line of the kernels, the card's name and power limit, and
the result line last. Each phase line ends with the seconds since the
script began.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import logging
import math
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

RTOL, ATOL = 1e-5, 1e-8
SOURCES = ("window_kernel", "phi_kernel", "mmsb_window_kernel",
           "ref_rng_kernel")
MAIN_ARGS = ["--synthetic", "317080,7", "-k", "256", "-x", "2000",
             "-i", "500", "--device", "cuda"]
MMSB_ARGS = ["--model", "mmsb", "--synthetic", "317080,7", "-k", "64",
             "--window", "12", "-x", "1000", "-i", "500", "--device", "cuda"]
PHI_ARGS = ["--phi-impl", "pallas", "--device-sampling", "--synthetic",
            "317080,7", "-k", "256", "-x", "1000", "-i", "500",
            "--device", "cuda"]
CHAINS = 16
CHAIN_ARGS = ["--num-chains", str(CHAINS), "--node-coin", "alternate",
              "--synthetic", "317080,7", "-k", "256", "-x", "1008",
              "-i", "504", "--device", "cuda"]
RHAT_ARGS = ["--num-chains", "3", "--synthetic", "2000,8", "-k", "16",
             "-x", "200", "-i", "100", "--rhat-draws", "2",
             "--device", "cuda"]
# the host-sampled paths and the perfect-hash main path: name -> (CLI
# arguments, steps, ppx interval, expected launches of every kernel entry
# that may be non-zero, messages the log must hold)
HOST_RUNS = {
    "--phi-impl pallas (host-sampled)": (
        ["--phi-impl", "pallas", "--synthetic", "317080,7", "-k", "256",
         "-x", "1000", "-i", "500"], 1000, 500, {"phi_gather": 1000},
        ["host sampler: native C++", "steps_per_call auto-set to 200"]),
    "step at a time, --phi-impl pallas": (
        ["--no-device-sampling", "--no-shared-neighbors",
         "--steps-per-call", "1", "--phi-impl", "pallas", "--synthetic",
         "317080,7", "-k", "256", "-x", "300", "-i", "100"], 300, 100,
        {"phi": 300}, ["host sampler: numpy"]),
    "--no-device-sampling -s BFLink": (
        ["--no-device-sampling", "-s", "BFLink", "--synthetic", "317080,7",
         "-k", "256", "-x", "400", "-i", "200"], 400, 200, {},
        ["host sampler: native C++"]),
    "--synthetic-powerlaw, --edgeset perfect": (
        ["--synthetic-powerlaw", "317080,6.6,343,256", "--edgeset",
         "perfect", "--ds-link-cap", "64", "-k", "256", "-x", "1000", "-i",
         "500"], 1000, 500, {},
        ["edge sets: training perfect, held-out perfect",
         "window auto-disabled"]),
}
# engines that launch no kernel: name -> (CLI arguments, steps, interval,
# chains, must the series fall)
NEW_RUNS = {
    "--model mmsb --num-chains 4": (
        ["--model", "mmsb", "--num-chains", "4", "--synthetic", "317080,7",
         "-k", "64", "-x", "1000", "-i", "500"], 1000, 500, 4, False),
    "--model mmsb --no-device-sampling": (
        ["--model", "mmsb", "--no-device-sampling", "--synthetic",
         "317080,7", "-k", "64", "-x", "400", "-i", "200"], 400, 200, 1,
        False),
    "--chain-engine vmap --num-chains 3": (
        ["--num-chains", "3", "--chain-engine", "vmap", "--synthetic",
         "317080,7", "-k", "256", "-x", "200", "-i", "100"], 200, 100, 3,
        True),
}
TRAIN_PPX_ARGS = ["--synthetic", "317080,7", "-k", "256", "-x", "1000", "-i",
                  "500", "--calc-train-ppx", "--train-ppx-ratio", "0.00001"]
# run-save-run against restore-run through the API: name -> (CLI
# arguments, steps per half, the kernel entry the path launches, its
# launches per half[, the checkpoint backend: npz unless given])
RESUME_RUNS = {
    "a-MMSB main path": (
        ["--synthetic", "317080,7", "-k", "256", "--steps-per-call", "1008"],
        1008, "window", 84),
    "--model mmsb --window 12": (
        ["--model", "mmsb", "--window", "12", "--synthetic", "317080,7",
         "-k", "64", "--steps-per-call", "504"], 504, "mmsb", 42),
    "--phi-impl pallas (host-sampled)": (
        ["--phi-impl", "pallas", "-i", "500", "--synthetic", "317080,7",
         "-k", "256"], 400, "phi_gather", 400),
    "--num-chains 4": (
        ["--num-chains", "4", "--node-coin", "alternate", "--synthetic",
         "317080,7", "-k", "256", "--steps-per-call", "252"], 252,
        "window_chain", 21),
    # the sharded checkpoint: rank 0 writes the global state and every
    # rank's generators through NCCL collectives, each rank reads its rows
    "--mesh 1,1": (
        ["--synthetic", "317080,7", "-k", "256", "--steps-per-call", "1008",
         "--mesh", "1,1"], 1008, "window", 84),
    # the directory backend (torch.distributed.checkpoint): on the mesh
    # every rank writes its own rows as DTensor shards
    "a-MMSB main path, directory backend": (
        ["--synthetic", "317080,7", "-k", "256", "--steps-per-call", "1008"],
        1008, "window", 84, "orbax"),
    "--mesh 1,1, directory backend": (
        ["--synthetic", "317080,7", "-k", "256", "--steps-per-call", "1008",
         "--mesh", "1,1"], 1008, "window", 84, "orbax"),
}
# the reference-RNG and device breadth-first paths: name -> (CLI
# arguments, steps, ppx interval, expected launches of every kernel entry
# that may be non-zero, must the series fall, messages the log must hold).
# A --rng reference run draws each chunk's phi noise, theta noise and
# neighbors in one launch each, and its init in two (theta, pi)
REF_ARGS = ["--rng", "reference", "--synthetic", "317080,7", "-k", "256",
            "-x", "400", "-i", "200"]
REF_RUNS = {
    "--rng reference": (
        REF_ARGS, 400, 200, {"randn": 4, "neighbors": 2, "gamma": 2}, True,
        ["reference RNG: the kernel", "steps_per_call auto-set to 200"]),
    "--rng reference --phi-impl pallas": (
        ["--rng", "reference", "--phi-impl", "pallas", "--synthetic",
         "317080,7", "-k", "256", "-x", "200", "-i", "100"], 200, 100,
        {"randn": 4, "neighbors": 2, "gamma": 2, "phi_gather": 200}, True,
        ["reference RNG: the kernel"]),
    "-s BFLink (device-sampled)": (
        ["-s", "BFLink", "--synthetic", "317080,7", "-k", "256", "-x",
         "1000", "-i", "500"], 1000, 500, {}, True,
        ["device sampling auto-enabled (breadth-first family"]),
    # the BF mix rises on this graph in both packages and with host
    # sampling too: the BFNonLink weight (N(N-1)/2 - E)/m dwarfs the links'
    "-s BF --node-coin alternate": (
        ["-s", "BF", "--node-coin", "alternate", "--synthetic", "317080,7",
         "-k", "256", "-x", "400", "-i", "200"], 400, 200, {}, False, []),
    "-s BFNonLink": (
        ["-s", "BFNonLink", "--synthetic", "317080,7", "-k", "256", "-x",
         "400", "-i", "200"], 400, 200, {}, False, []),
    "--num-chains 4 -s BFLink": (
        ["--num-chains", "4", "-s", "BFLink", "--synthetic", "317080,7",
         "-k", "256", "-x", "200", "-i", "100"], 200, 100, {}, True, []),
}
# the multi-GPU paths at world size 1 (one H100: NCCL groups of size 1)
SHARDED_ARGS = MAIN_ARGS + ["--mesh", "1,1"]
SHARDED_CHAINS = 4
SHARDED_CHAIN_ARGS = ["--num-chains", str(SHARDED_CHAINS), "--window", "6",
                      "--steps-per-call", "504", "-i", "504", "--synthetic",
                      "317080,7", "-k", "256"]
PARTITIONED_ARGS = ["-k", "256", "-x", "1000", "-i", "500",
                    "--partitioned-ingest", "--mesh", "1,1", "--device",
                    "cuda"]
PROFILE_ARGS = ["--synthetic", "317080,7", "-k", "256", "-x", "1000", "-i",
                "500", "--profile", "--auto-tune-window", "--device", "cuda"]
# bfloat16 pi storage: the main path, the flat chains and --mesh 1,1
BF16_ARGS = MAIN_ARGS + ["--pi-dtype", "bfloat16"]
BF16_CHAIN_ARGS = ["--num-chains", "4", "--pi-dtype", "bfloat16", "--window",
                   "6", "--synthetic", "317080,7", "-k", "256", "-x", "504",
                   "-i", "252", "--device", "cuda"]
BF16_MESH_ARGS = ["--synthetic", "317080,7", "-k", "256", "-x", "1000", "-i",
                  "500", "--mesh", "1,1", "--pi-dtype", "bfloat16",
                  "--device", "cuda"]
# reference-format checkpoints: a main-path run that exports, then a run
# that imports the file; evaluations every 100 steps, so that the running
# averages the file carries hold 11 of them and the import's first
# evaluation moves them little
REF_EXPORT_ARGS = ["--synthetic", "317080,7", "-k", "256", "-x", "1000",
                   "-i", "100", "--device", "cuda"]
# the directory backend's asynchronous interval saves through the CLI
ASYNC_ARGS = ["--synthetic", "317080,7", "-k", "256", "-x", "1000", "-i",
              "500", "--steps-per-call", "500", "--checkpoint-interval",
              "500", "--checkpoint-backend", "orbax", "--device", "cuda"]
# steps at the end of the phi-noise chunk the plain version draws in the
# kernel phase
REF_PLAIN_STEPS = 10
REF_API_ARGS = ["--rng", "reference", "--synthetic", "317080,7", "-k", "256",
                "--steps-per-call", "10"]
AUTO_ARGS = ["--synthetic", "317080,7", "-k", "256", "--steps-per-call",
             "1008"]
# the main path at K = 4096, every window in the kernel's wide mode
WIDE_ARGS = ["--synthetic", "317080,7", "-k", "4096", "-x", "2000", "-i",
             "500", "--device", "cuda"]
# (T, B, n, E, K) of the fused window kernel's checks; the first is the
# main path's; the first four run its resident mode, the next four its
# wide mode: the K = 4096 path's, the ragged K = 2050 (4-byte copies), and
# the JAX package's longest windows at K = 8192 and 16384; the last, in
# the resident mode, is the com-youtube rung's window (K = 1024)
WINDOW_SHAPES = [(12, 33, 32, 32, 256), (3, 6, 7, 5, 12),
                 (12, 33, 32, 32, 100), (48, 33, 32, 32, 256),
                 (12, 33, 32, 32, 4096), (12, 33, 32, 32, 2050),
                 (6, 33, 32, 32, 8192), (3, 33, 32, 32, 16384),
                 (12, 33, 32, 32, 1024)]
WIDE_MAIN_SHAPE = WINDOW_SHAPES[4]
LADDER_SHAPE = WINDOW_SHAPES[8]
# the ladder phase: every rung of ladder.RUNGS at full size, 2000 steps
# each (two 1000-step calls), an evaluation after each call; the window
# each rung's launches must take ((mode, pi dtype, K), or None: no
# window); N, E and max fan-out come from the JAX package's artifacts
LADDER_ITERS, LADDER_INTERVAL = 2000, 1000
LADDER_WINDOWS = {"ca-HepPh": None, "com-dblp": ("resident", "float32", 256),
                  "com-youtube": ("resident", "float32", 1024),
                  "com-lj": ("step", "bfloat16", 4096)}
# the host's Gamma(1, 1) float32 draws timed to estimate the host law's
# init at com-lj's size
HOST_GAMMA_DRAWS = 1 << 24
# (C, T, B, n, E, K) of its chain mode; the first is the chain path's,
# the last runs the wide mode
CHAIN_SHAPES = [(CHAINS, 6, 33, 32, 32, 256), (3, 4, 9, 8, 8, 16),
                (2, 3, 6, 7, 5, 12), (2, 12, 33, 32, 32, 2048)]
# the window kernel's source from before the wide mode's step layout: the
# resident mode's bits are held against its build, and the wide mode's
# times against its chunked layout's
PARENT_SRC = "scripts/window_kernel_pr11.cu"
# (T, B, n, E, K) of the fused MMSB window's checks; the second is the
# MMSB path's, (..., 256) fits only a cluster of 16, K = 50 takes 13 CTAs
# with a ragged last slice and 4-byte copies
MMSB_SHAPES = [(1, 33, 32, 32, 64), (12, 33, 32, 32, 64), (3, 6, 7, 5, 12),
               (12, 33, 32, 32, 128), (12, 33, 32, 32, 256),
               (12, 33, 32, 32, 50)]
# (B, n, K) of the phi entries' checks: the device-sampled phi path's (33
# node lanes: the by-index entry's main shape), the host-sampled paths'
# (64 node lanes, two blocks per node: the pre-gathered entry's main
# shape, which only the step-at-a-time host path launches), two odd
# ones, and one that stages each block's neighbor rows in chunks
PHI_SHAPES = [(33, 32, 256), (64, 32, 256), (5, 7, 12), (33, 32, 100),
              (33, 32, 4096)]
PHI_MAIN_SHAPE = {"pre-gathered": (64, 32, 256), "by-index": (33, 32, 256)}
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, fp32 FLOP/s outside
# the tensor cores
HBM_RATE, FP32_RATE = 3.35e12, 67e12
# the measured multi-step MMSB envelope of tests/test_window_mmsb.py:57-59
PI_ATOL = 5e-3
TH_TOLS = dict(rtol=0.1, atol=0.15)
B_TOLS = dict(rtol=0.1, atol=0.05)


_T0 = time.perf_counter()


def phase(name: str, msg: str) -> None:
    """One phase line, ending with the seconds since the script began."""
    print(f"[{name}] {msg} (at {time.perf_counter() - _T0:.1f} s)",
          flush=True)


def max_err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """max |got - want|, required <= ATOL + RTOL * max |want| (normwise
    per output tensor). Elementwise relative error is no measure here:
    the few elements that come out of a cancellation (the abs() of the
    SGRLD steps, s_contrib - n_valid) differ at rtol ~1e-4 between ANY
    two float32 evaluations with different summation orders — the
    kernel and the plain version are equally far from a float64
    evaluation there (printed by the kernel phases)."""
    got, want = got.double().cpu(), want.double().cpu()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values")
    err = float((got - want).abs().max())
    bound = ATOL + RTOL * float(want.abs().max())
    if err > bound:
        raise AssertionError(f"{what}: max abs err {err:.3e} > {bound:.3e} "
                             f"(rtol {RTOL}, atol {ATOL}, normwise)")
    return err


def within(got, want, what, rtol=0.0, atol=0.0) -> float:
    """Elementwise |got - want| <= atol + rtol |want|; returns max abs."""
    got, want = got.double().cpu(), want.double().cpu()
    bad = (got - want).abs() > atol + rtol * want.abs()
    if bad.any() or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: {int(bad.sum())} elements outside "
                             f"rtol {rtol}, atol {atol}")
    return float((got - want).abs().max())


def f64_distance(outs, refs) -> float:
    """max over outputs of max |out - ref| / max |ref|."""
    return max(float((o.double() - r).abs().max() / r.abs().max())
               for o, r in zip(outs, refs))


def time_ms(fn, reps: int = 50, hold: bool = False) -> float:
    """ms per call of ``reps`` calls after a warm-up, by CUDA events.
    With ``hold`` the device first sleeps (~1 ms per call at ~2 GHz)
    while the host queues the calls, so the events time the device alone
    and not the host's launch overhead."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(2_000_000 * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _float64(args):
    """The arguments with every float tensor in float64."""
    def up(x):
        if isinstance(x, torch.Tensor):
            return x.double() if x.is_floating_point() else x
        if hasattr(x, "_fields"):                # NamedTuple
            return type(x)(*(up(a) for a in x))
        if isinstance(x, tuple):
            return tuple(up(a) for a in x)
        return x

    return tuple(up(a) for a in args)


def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if hasattr(x, "_fields"):                    # NamedTuple
        return type(x)(*(_to(a, dev) for a in x))
    if isinstance(x, tuple):
        return tuple(_to(a, dev) for a in x)
    return x


def build_parent(kernels, src: Path = None) -> Path:
    """A build of PARENT_SRC (the window kernel from before the wide
    mode's step layout), or of another source with its C interface,
    beside the kernels' builds."""
    src = src or Path(__file__).resolve().parent / PARENT_SRC
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = kernels.BUILD_DIR / "libwindow_kernel_parent.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True)
    return out


class ParentWindowLib:
    """A build of PARENT_SRC behind this build's C interface (the same
    one). Its wide mode has the chunked layout only, so a wide launch
    goes to it at the plan its own rule gives the shape (the first
    cluster size of window._WIDE_CLUSTERS whose slices tile K, with the
    widest chunk of WIDE_CHUNKS whose layout, by the parent's own
    window_kernel_smem_bytes, fits the card); a resident launch goes
    unchanged."""

    #: positions of T..K, the cluster size and the chunk width among the
    #: arguments of window_kernel_launch
    SHAPE, S, WC = slice(21, 26), 27, 28

    def __init__(self, path: Path, window, limit: int):
        self.lib = window.bind_window_lib(ctypes.CDLL(str(path)))
        self.window, self.limit = window, limit

    def plan(self, t_win, b_cap, n_smpl, e_cap, k):
        """The parent's (S, wc) of a wide shape."""
        w = self.window
        for s in w._WIDE_CLUSTERS:
            if not w._tiles(k, s):
                continue
            for wc in w.WIDE_CHUNKS:
                if self.lib.window_kernel_smem_bytes(
                        t_win, b_cap, n_smpl, e_cap, k, s, wc) <= self.limit:
                    return s, wc
        raise ValueError(f"no layout of {PARENT_SRC} fits "
                         f"{(t_win, b_cap, n_smpl, e_cap, k)}")

    def window_kernel_launch(self, *args):
        args = list(args)
        if args[self.WC] != 0:
            args[self.S], args[self.WC] = self.plan(*args[self.SHAPE])
        return self.lib.window_kernel_launch(*args)


def build_all(kernels, native):
    """Phase 2: one nvcc per source, one for PARENT_SRC and one g++ for
    the native host library, all started together. Returns the parent's
    build."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES) + 2) as pool:
        host_lib = pool.submit(native.build)
        parent = pool.submit(build_parent, kernels)
        libs = dict(zip(SOURCES, pool.map(kernels.build, SOURCES)))
        host_lib = host_lib.result()
        parent = parent.result()
    for name, lib in libs.items():
        ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text()
                 .splitlines() if "registers" in ln or "spill" in ln]
        phase("build", f"{name}: {'; '.join(ptxas)}")
    if not native.available():
        raise AssertionError(f"native host library: {native.build_error}")
    phase("build", f"{len(SOURCES)} CUDA sources, {PARENT_SRC} and "
          f"{host_lib.name} (g++) built in "
          f"{time.perf_counter() - t0:.2f} s")
    return parent


def _bench_graph(data):
    """The bench graph (--synthetic 317080,7) as the CLI splits it."""
    n, u, v = data.synthetic_edges(317080, 7, seed=1)
    split = data.generate_sets(n, u, v, 0.01)
    return n, split, data.Graph.from_edges(n, split.training_u,
                                           split.training_v)


def check_native(edgeset, graph):
    """Phase native: the CHD perfect hash of the bench graph's training
    edges built natively and built in numpy."""
    out = {}
    for route in ("native", "numpy"):
        t0 = time.perf_counter()
        out[route] = edgeset._build_perfect_host(
            graph.edges_u, graph.edges_v, use_native=route == "native")
        out[route + "_s"] = time.perf_counter() - t0
    a, b = out["native"], out["numpy"]
    if a[2:] != b[2:] or any(x.tobytes() != y.tobytes()
                             for x, y in zip(a[:2], b[:2])):
        raise AssertionError("CHD tables of the native and the numpy "
                             "build differ")
    phase("native", f"CHD perfect hash of E={graph.num_edges} training "
          f"edges: {a[1].shape[0]} slots, {a[0].shape[0]} buckets, seed "
          f"{a[4]}; native chd_build {out['native_s']:.3f} s, numpy build "
          f"{out['numpy_s']:.3f} s, tables byte-equal")


def check_membership(mods, n, split, graph, smi):
    """Phase membership: every backend against the adjacency matrix on
    the card. On a lane whose node is the sentinel N the adjacency backend
    answers for node N-1 (the clamped gather, as in the JAX package) and
    the others answer False; those lanes are held to that, every other
    lane to exact equality."""
    config, edgeset, device_sampling, neighbor, rng_mod = mods
    cfg = config.Config(K=256, device_sampling=True).finalize(
        n, split.total_edges, graph.max_fan_out)
    backends = ("adjacency", "perfect", "csr", "sorted", "cuckoo")
    sets, build_s = {}, {}
    for b in backends:
        t0 = time.perf_counter()
        sets[b] = edgeset.build_edge_set(config.EdgeSetBackend(b), n,
                                         graph.edges_u, graph.edges_v, "cuda")
        build_s[b] = time.perf_counter() - t0
    held = edgeset.build_edge_set(config.EdgeSetBackend.ADJACENCY, n,
                                  split.heldout_u, split.heldout_v, "cuda")
    adj = device_sampling.Adjacency(
        torch.as_tensor(graph.offsets, device="cuda"),
        torch.as_tensor(graph.cols, dtype=torch.int32, device="cuda"))
    gen = rng_mod.generator((7, 8), "cuda")
    ds = device_sampling.sample_minibatches_device(
        cfg, sets["adjacency"], held, gen, 200, adj)
    nodes = ds.nodes.clone()
    nodes[1::2] = torch.where(ds.node_mask[1::2], nodes[1::2], 0)
    nbrs = neighbor.sample_neighbors(gen, nodes, n, cfg.num_node_sample)
    block = (nodes[:, :, None], nbrs)
    if tuple(nbrs.shape) != (200, 33, 32):
        raise AssertionError(f"query block {tuple(nbrs.shape)}")
    r = torch.Generator(device="cuda").manual_seed(5)
    pick = torch.randint(0, graph.num_edges, (500_000,), generator=r,
                         device="cuda")
    eu = torch.as_tensor(graph.edges_u, device="cuda")[pick]
    ev = torch.as_tensor(graph.edges_v, device="cuda")[pick]
    swap = torch.rand(500_000, generator=r, device="cuda") < 0.5
    pairs = (torch.cat([torch.where(swap, ev, eu),
                        torch.randint(0, n, (500_000,), generator=r,
                                      device="cuda", dtype=torch.int32)]),
             torch.cat([torch.where(swap, eu, ev),
                        torch.randint(0, n, (500_000,), generator=r,
                                      device="cuda", dtype=torch.int32)]))
    want_block = sets["adjacency"].has_edges(*block)
    want_pairs = sets["adjacency"].has_edges(*pairs)
    sentinel = (nodes == n)[:, :, None].expand_as(want_block)
    zero_pad = int(((nodes == 0) & ~ds.node_mask).sum())
    if not want_pairs[:500_000].all() or not sentinel.any() or not zero_pad:
        raise AssertionError("membership queries: true edges not found or "
                             "no padded lanes of both kinds")
    clamped = sets["adjacency"].has_edges(
        torch.where(nodes == n, n - 1, nodes)[:, :, None], nbrs)
    if not torch.equal(want_block, clamped):
        raise AssertionError("adjacency: a sentinel lane is not node N-1's")
    for b in backends:
        got_block = sets[b].has_edges(*block)
        got_pairs = sets[b].has_edges(*pairs)
        if b != "adjacency":
            if not torch.equal(got_pairs, want_pairs):
                raise AssertionError(f"{b}: differs from adjacency on the "
                                     f"10^6 pairs")
            if not torch.equal(got_block[~sentinel], want_block[~sentinel]):
                raise AssertionError(f"{b}: differs from adjacency on the "
                                     f"query block")
            if got_block[sentinel].any():
                raise AssertionError(f"{b}: a sentinel lane answers True")
        ms = time_ms(lambda: sets[b].has_edges(*block), reps=20)
        ms_pairs = time_ms(lambda: sets[b].has_edges(*pairs), reps=5)
        phase("membership", f"{b}: built in {build_s[b]:.3f} s (host tables "
              f"+ copy), {nbytes(*sets[b].arrays) / 2**20:.1f} MiB on the "
              f"card; [200,33,32] block {ms:.4f} ms, 10^6 pairs "
              f"{ms_pairs:.4f} ms (back to back with the host); "
              + ("the reference" if b == "adjacency" else
                 "equal to adjacency on both") + f"; {smi}")
    phase("membership", f"block: {int(want_block.sum())} of "
          f"{want_block.numel()} queries are edges, {int(sentinel.sum())} "
          f"on sentinel-N lanes, {zero_pad * 32} on id-0 padded lanes; "
          f"pairs: {int(want_pairs.sum())} of 10^6 are edges")


def bound(nbytes: float, flops: float):
    """(least ms the card could take, what sets it): the bytes over the
    HBM rate against the float32 operations over the fp32 peak."""
    t_bytes, t_ops = nbytes / HBM_RATE, flops / FP32_RATE
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _tensors(x):
    """The tensors of a nest of tuples and NamedTuples."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for a in x for t in _tensors(a)]
    return []


def window_bound(xs, mcode, keep, k: int, n_rows: int, pi_bytes: int = 4):
    """Bound of one fused window (one chain, or C chain-major): the pi
    rows (``pi_bytes`` per value: 2 in bf16) and sums it must read (each
    distinct pre-window row once), every operand once, the kept rows and
    sums and theta and beta written once;
    the float32 operations of the valid lanes and edges (per step and
    node 4 n K for the two contractions, ~15 K for the phi step and the
    normalization, ~14 K per edge for the edge sums and the fan-in)."""
    batch, nbrs_s, y_w, nphi_w, nbeta_w, ye_w, lu, lv = xs
    t_win, b_cap = batch.nodes.shape[-2:]
    n_smpl = nbrs_s.shape[-1]
    nodes = batch.nodes.reshape(-1, t_win, b_cap)
    c = nodes.shape[0]
    offs = (torch.arange(c, device=nodes.device) * n_rows)[:, None, None]
    ids = torch.cat([nodes.clamp(max=n_rows - 1),
                     nbrs_s.reshape(c, t_win, n_smpl)], dim=-1) + offs
    pre = mcode.reshape(c, t_win, -1) == 0
    rows_read = int(torch.unique(ids[pre]).numel())
    sums_read = int(torch.unique(ids[..., :b_cap][pre[..., :b_cap]]).numel())
    kept = int(keep.sum())
    operands = nbytes(y_w, batch.nodes, nbrs_s, batch.node_mask, keep,
                      nphi_w, nbeta_w, ye_w, batch.edge_mask, lu, lv, mcode,
                      batch.weight)
    moved = ((rows_read + kept) * k * pi_bytes + (sums_read + kept) * 4
             + operands + 2 * c * k * 3 * 4)
    b_valid = int(batch.node_mask.sum())
    e_valid = int(batch.edge_mask.sum())
    flops = (4 * b_valid * n_smpl * k + 15 * b_valid * k + 14 * e_valid * k
             + 8 * b_valid * n_smpl + 20 * k * c * t_win)
    return bound(moved, flops)


def _fresh(state):
    """A copy of the state whose pi and phi_sum the kernel may write."""
    return state._replace(pi=state.pi.clone(), phi_sum=state.phi_sum.clone())


def _outs(st):
    return (st.pi, st.phi_sum, st.theta, st.beta)


STATE_FIELDS = ("pi", "phi_sum", "theta", "beta")


def _window_f64(window, phi_ops, cfg, state, xs, mcode, keep, chained):
    """The window in float64: the plain version's gather (float32 values,
    exact in float64), its steps on the operands in float64, its
    scatter into a float64 copy of pi."""
    if chained:
        g, sums = window._chain_window_gather(cfg, state, xs)
        core = window.window_chain_core_torch
        idx = window._chain_flat_ids(xs[0].nodes, cfg.N)
    else:
        g, sums = window._window_gather(cfg, state, xs[0], xs[1][:, 0, :])
        core = window.window_core_torch
        idx = xs[0].nodes
    rows, sums_o, theta, beta = core(*_float64((cfg, state, xs, g, sums,
                                                mcode)))
    pi, phi_sum = phi_ops.scatter_rows(state.pi.double(),
                                       state.phi_sum.double(),
                                       idx.reshape(-1), keep.reshape(-1),
                                       rows, sums_o)
    return pi, phi_sum, theta, beta


def _agree(window, phi_ops, cfg, state, xs, mcode, keep, chained, what,
           normwise=True):
    """The kernel and the plain version, each on its own copy of
    ``state``: (kernel's state, max abs difference over the outputs,
    distances to float64 of kernel and plain). Fails when the kernel is
    more than 2x farther from float64 than the plain version, and with
    ``normwise`` past the normwise tolerance (two float32 evaluations of
    a long window drift apart past it, each as far from float64)."""
    cuda = window.window_chain_apply_cuda if chained else \
        window.window_apply_cuda
    plain = window.window_chain_apply_torch if chained else \
        window.window_apply_torch
    got = cuda(cfg, _fresh(state), xs, mcode, keep)
    torch.cuda.synchronize()
    want = plain(cfg, _fresh(state), xs, mcode, keep)
    if normwise:
        err = max(max_err(a, b, f"{what} {name}") for a, b, name in
                  zip(_outs(got), _outs(want), STATE_FIELDS))
    else:
        err = max(float((a - b).abs().max())
                  for a, b in zip(_outs(got), _outs(want)))
    ref = _window_f64(window, phi_ops, cfg, _fresh(state), xs, mcode, keep,
                      chained)
    f64 = [max(float((a.double() - r).abs().max()) for a, r in zip(out, ref))
           for out in (_outs(got), _outs(want))]
    if f64[0] > 2 * f64[1]:
        raise AssertionError(f"{what}: kernel {f64[0]:.3e} from float64, "
                             f"more than 2x the plain version's {f64[1]:.3e}")
    return got, err, f64


def bf16_agree(testing, cfg, state, args, cuda, plain, what):
    """The window kernel's bf16 row mode against the plain version at
    bf16 (the --window-impl jnp window), each on its own copy of the
    state with pi rounded to bf16: the bf16 launch must equal the
    float32 launch on the upcast table with its rows rounded to
    nearest-even, bit for bit (the mode's whole contract); the stored
    rows of kernel and plain may differ by one ulp where their float32
    values straddle a rounding boundary, and by more only as far as
    those float32 values differ (testing.bf16_gaps); phi_sum, theta and
    beta by the float32 normwise rule. Returns (the gaps, max abs err of
    the float32 fields)."""
    st16 = state._replace(pi=state.pi.to(torch.bfloat16))
    st32 = st16._replace(pi=st16.pi.float())
    k16 = cuda(cfg, _fresh(st16), *args)
    k32 = cuda(cfg, _fresh(st32), *args)
    torch.cuda.synchronize()
    p16 = plain(cfg, _fresh(st16), *args)
    p32 = plain(cfg, _fresh(st32), *args)
    if k16.pi.dtype != torch.bfloat16 or not (
            torch.equal(k16.pi, k32.pi.to(torch.bfloat16))
            and all(torch.equal(a, b) for a, b in
                    zip(_outs(k16)[1:], _outs(k32)[1:]))):
        raise AssertionError(f"{what}: the bf16 launch is not the float32 "
                             f"launch on the upcast rows, rounded")
    gaps = testing.bf16_gaps(k16.pi, p16.pi, k32.pi, p32.pi)
    if gaps["unexplained"]:
        raise AssertionError(f"{what}: bf16 rows farther apart than their "
                             f"float32 values allow: {gaps}")
    err = max(max_err(a, b, f"{what} bf16 {f}") for a, b, f in
              zip(_outs(k16)[1:], _outs(p16)[1:], STATE_FIELDS[1:]))
    return gaps, err


def _plan_line(window, lib, shape, limit):
    """(the plan (S, mode, wc) of a per-chain shape, shared bytes per CTA,
    and its words for a phase line); the kernel's own layout must give
    the rule's byte count."""
    plan = window.window_plan(*shape, limit)
    s_cl, mode, wc = plan
    smem = window.plan_smem_bytes(shape, plan)
    got = lib.window_kernel_smem_bytes(*shape, s_cl, wc)
    if got != smem:
        raise AssertionError(f"shared memory of {shape} in the {mode} "
                             f"mode: kernel {got} B, rule {smem} B")
    if (mode != "resident") != (shape[4] >= 1536):
        raise AssertionError(f"{shape}: the {mode} mode, expected the "
                             f"{'wide' if shape[4] >= 1536 else 'resident'}")
    text = ({"resident": "resident mode", "step": "wide mode, step layout",
             "wide": "wide mode, chunked layout"}[mode]
            + f", cluster of {s_cl} CTAs"
            + (f", chunks of {wc} columns" if mode == "wide" else "")
            + f", {smem} B shared per CTA")
    return plan, smem, text


def window_operands(window, chains_flat, testing, shape, seed=0):
    """The seeded window of a single-chain (T, B, n, E, K) or chain (C,
    T, B, n, E, K) shape on the card: (cfg, state, (xs, mcode, keep),
    the kernel's entry, its plain version)."""
    if len(shape) == 5:
        case = testing.window_case(seed, *shape)
        cfg = testing.window_case_config(case)
        state, xs = testing.window_case_torch(case, "cuda")
        batch, nbrs = xs[0], xs[1][:, 0, :]
        args = (xs, window._correction_codes(cfg, batch.nodes,
                                             batch.node_mask, nbrs),
                window._last_write_wins(batch.nodes, batch.node_mask,
                                        shape[0]))
        return (cfg, state, args, window.window_apply_cuda,
                window.window_apply_torch)
    case = testing.chain_window_case(seed, *shape)
    cfg = testing.chain_window_case_config(case)
    state, xw = testing.chain_window_case_torch(case, "cuda")
    win = chains_flat.chain_windows(cfg, shape[0], xw).at(0)
    return (cfg, state, (win.xs_t, win.mcode, win.keep),
            window.window_chain_apply_cuda, window.window_chain_apply_torch)


def check_resident_parent(window, chains_flat, testing, kernels, parent,
                          reps=50):
    """Phase kernel: the resident mode of this build against the build of
    PARENT_SRC at every shape of WINDOW_SHAPES and CHAIN_SHAPES the plan
    runs in it, with float32 and with bfloat16 pi: the same bits in every
    output; then the float32 launches at the main path's and the chain
    path's shapes timed in turns (parent, change, change, parent).
    Returns {shape: (parent ms, change ms, the four turns)}."""
    limit = kernels.smem_limit(torch.device("cuda"))
    old = ParentWindowLib(parent, window, limit)
    real = window._window_lib
    new = real()
    shapes = [sh for sh in WINDOW_SHAPES + CHAIN_SHAPES
              if window.window_plan(*sh[-5:], limit)[1] == "resident"]
    out = {}
    try:
        for shape in shapes:
            cfg, state, args, cuda, _ = window_operands(
                window, chains_flat, testing, shape, seed=1)
            for dtype in (torch.float32, torch.bfloat16):
                st = state._replace(pi=state.pi.to(dtype))
                outs = []
                for lib in (old, new):
                    window._window_lib = lambda lib=lib: lib
                    outs.append(_outs(cuda(cfg, _fresh(st), *args)))
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(*outs)):
                    raise AssertionError(f"{shape} {dtype}: the resident "
                                         f"mode differs from {PARENT_SRC}")
            if shape in (WINDOW_SHAPES[0], CHAIN_SHAPES[0]):
                scratch = _fresh(state)
                t = []
                for lib in (old, new, new, old):
                    window._window_lib = lambda lib=lib: lib
                    t.append(time_ms(lambda: cuda(cfg, scratch, *args),
                                     reps, hold=True))
                out[shape] = ((t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t)
    finally:
        window._window_lib = real
    phase("kernel", f"resident mode bit-equal to {PARENT_SRC} at "
          f"{len(shapes)} shapes, float32 and bf16 pi; ms/window in turns "
          f"(parent, change, change, parent): "
          + "; ".join(f"{sh}: {' '.join(f'{x:.4f}' for x in v[2])}"
                      for sh, v in out.items()))
    return out


def check_wide_parent(window, chains_flat, testing, kernels, parent,
                      reps=50):
    """Phase kernel: the wide mode of this build against the build of
    PARENT_SRC (its chunked layout, at the plan of its own rule) at every
    shape of WINDOW_SHAPES and CHAIN_SHAPES the plan runs in the wide
    mode, timed in turns (parent, change, change, parent) on the same
    operands, device time only. Returns {shape: (parent ms, change ms,
    the four turns, this build's layout, the parent's (S, wc), max abs
    difference of the two builds' outputs)}."""
    limit = kernels.smem_limit(torch.device("cuda"))
    old = ParentWindowLib(parent, window, limit)
    real = window._window_lib
    new = real()
    shapes = [sh for sh in WINDOW_SHAPES + CHAIN_SHAPES
              if window.window_plan(*sh[-5:], limit)[1] != "resident"]
    out = {}
    try:
        for shape in shapes:
            cfg, state, args, cuda, _ = window_operands(
                window, chains_flat, testing, shape, seed=2)
            outs = []
            for lib in (old, new):
                window._window_lib = lambda lib=lib: lib
                outs.append(_outs(cuda(cfg, _fresh(state), *args)))
            torch.cuda.synchronize()
            diff = max(float((a - b).abs().max()) for a, b in zip(*outs))
            scratch = _fresh(state)
            t = []
            for lib in (old, new, new, old):
                window._window_lib = lambda lib=lib: lib
                t.append(time_ms(lambda: cuda(cfg, scratch, *args), reps,
                                 hold=True))
            s_cl, mode, wc = window.window_plan(*shape[-5:], limit)
            out[shape] = ((t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t,
                          f"{mode} S={s_cl} wc={wc}",
                          old.plan(*shape[-5:]), diff)
    finally:
        window._window_lib = real
    phase("kernel", "wide mode against " + PARENT_SRC + ", ms/window in "
          "turns (parent, change, change, parent): " + "; ".join(
              f"{sh}: this build {v[3]}, parent chunked S={v[4][0]} "
              f"wc={v[4][1]}: {' '.join(f'{x:.4f}' for x in v[2])} "
              f"(change/parent {v[1] / v[0]:.3f}; builds differ by max "
              f"abs {v[5]:.3e})" for sh, v in out.items()))
    return out


def check_window_kernel(window, kernels, testing, phi_ops, smi):
    """Phase 3, the fused a-MMSB window: {mode: (max abs err over the
    mode's shapes held normwise, and the kernel ms, plain ms, bound ms
    and what sets it at the mode's main shape: the main path's for the
    resident mode, the K = 4096 path's for the wide)}."""
    lib = window._window_lib()
    limit = kernels.smem_limit(torch.device("cuda"))
    worst, main = {"resident": 0.0, "wide": 0.0}, {}
    for seed, shape in enumerate(WINDOW_SHAPES):
        t_win = shape[0]
        case = testing.window_case(seed, *shape)
        cfg = testing.window_case_config(case)
        state, xs = testing.window_case_torch(case, "cuda")
        batch, nbrs = xs[0], xs[1][:, 0, :]
        mcode = window._correction_codes(cfg, batch.nodes, batch.node_mask,
                                          nbrs)
        keep = window._last_write_wins(batch.nodes, batch.node_mask, t_win)
        if not (mcode > 0).any():
            raise AssertionError("the case has no in-window collision")
        (_, mode, _), _, plan_text = _plan_line(window, lib, shape, limit)
        mode = "resident" if mode == "resident" else "wide"
        normwise = t_win <= 12
        _, err, f64 = _agree(window, phi_ops, cfg, state, xs, mcode, keep,
                             False, f"window at {shape}", normwise)
        if normwise:
            worst[mode] = max(worst[mode], err)
        scratch, plain_scratch = _fresh(state), _fresh(state)
        ms = time_ms(lambda: window.window_apply_cuda(cfg, scratch, xs,
                                                      mcode, keep),
                     hold=True)
        ms_b2b = time_ms(lambda: window.window_apply_cuda(cfg, scratch, xs,
                                                          mcode, keep))
        plain_ms = time_ms(lambda: window.window_apply_torch(
            cfg, plain_scratch, xs, mcode, keep), reps=10)
        b_ms, b_by = window_bound(xs, mcode, keep, shape[4], cfg.N)
        if shape in (WINDOW_SHAPES[0], WIDE_MAIN_SHAPE):
            main[mode] = (ms, plain_ms, b_ms, b_by)
        phase("kernel", f"window T,B,n,E,K={','.join(map(str, shape))}: "
              f"{plan_text}; kernel vs "
              f"plain max abs {'err' if normwise else 'diff (not held)'} "
              f"{err:.3e} (vs float64: kernel {f64[0]:.3e}, plain "
              f"{f64[1]:.3e}); {ms:.4f} ms/window on the device = "
              f"{1e3 * ms / t_win:.2f} us/step, {ms_b2b:.4f} ms/window "
              f"back to back with the host, {plain_ms:.4f} ms/window "
              f"plain; bound {b_ms * 1e3:.3f} us ({b_by}), "
              f"{100 * b_ms / ms:.2f}% of it; {smi}")
    return {mode: (worst[mode], main[mode]) for mode in worst}


def check_chain_kernel(window, kernels, chains_flat, testing, phi_ops, smi):
    """Phase 3, the fused window's chain mode: (max abs err, and the
    kernel ms, plain ms, bound ms and what sets it at the chain path's
    shape). One launch runs C clusters; it must give the same bits as C
    single-chain launches on the chains' blocks."""
    lib = window._window_lib()
    limit = kernels.smem_limit(torch.device("cuda"))
    worst, main = 0.0, None
    for seed, shape in enumerate(CHAIN_SHAPES):
        c, t_win = shape[:2]
        case = testing.chain_window_case(seed, *shape)
        cfg = testing.chain_window_case_config(case)
        state, xw = testing.chain_window_case_torch(case, "cuda")
        win = chains_flat.chain_windows(cfg, c, xw).at(0)
        if not all((win.mcode[i] > 0).any() for i in range(c)):
            raise AssertionError("a chain of the case has no collision")
        _, _, plan_text = _plan_line(window, lib, shape[1:], limit)
        args = (win.xs_t, win.mcode, win.keep)
        got, err, f64 = _agree(window, phi_ops, cfg, state, *args, True,
                               f"chain window at {shape}")
        worst = max(worst, err)
        n = cfg.N
        for ci in range(c):
            rows = slice(ci * n, (ci + 1) * n)
            one = window.window_apply_cuda(
                cfg, state._replace(pi=state.pi[rows].clone(),
                                    phi_sum=state.phi_sum[rows].clone(),
                                    theta=state.theta[ci],
                                    beta=state.beta[ci]),
                window.index_operands(win.xs_t, ci), win.mcode[ci],
                win.keep[ci])
            part = (got.pi[rows], got.phi_sum[rows], got.theta[ci],
                    got.beta[ci])
            if not all(torch.equal(a, b) for a, b in zip(_outs(one), part)):
                raise AssertionError(f"chain {ci} of the {c}-chain launch "
                                     f"differs from its own launch, {shape}")
        scratch, plain_scratch = _fresh(state), _fresh(state)
        ms = time_ms(lambda: window.window_chain_apply_cuda(cfg, scratch,
                                                            *args), hold=True)
        ms_b2b = time_ms(lambda: window.window_chain_apply_cuda(
            cfg, scratch, *args))
        plain_ms = time_ms(lambda: window.window_chain_apply_torch(
            cfg, plain_scratch, *args), reps=5)
        b_ms, b_by = window_bound(win.xs_t, win.mcode, win.keep, shape[5],
                                  cfg.N)
        main = main or (ms, plain_ms, b_ms, b_by)
        phase("kernel", f"chain window C,T,B,n,E,K={','.join(map(str, shape))}"
              f": {c} clusters, {plan_text}; "
              f"kernel vs plain max abs err {err:.3e} (vs float64: kernel "
              f"{f64[0]:.3e}, plain {f64[1]:.3e}); bit-equal to {c} "
              f"single-chain launches; {ms:.4f} ms/window on the device = "
              f"{1e3 * ms / t_win:.2f} us/step, {ms_b2b:.4f} ms/window "
              f"back to back with the host, {plain_ms:.4f} ms/window "
              f"plain; bound {b_ms * 1e3:.3f} us ({b_by}), "
              f"{100 * b_ms / ms:.2f}% of it; {smi}")
    return worst, main


def check_phi_kernel(phi_pallas, kernels, testing):
    """Phase 3, both phi entries: {entry: (max abs err over the shapes,
    and the kernel ms, plain ms, bound ms and what sets it at the main
    path's shape)}. Bound: the pre-gathered entry reads its operands once
    and writes rows and sums once; the by-index entry reads each distinct
    row of pi once; ~4 n K + 12 K float32 operations per valid node."""
    errs, times = {}, {}
    limit = kernels.smem_limit(torch.device("cuda"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for seed, (b_cap, n_smpl, k) in enumerate(PHI_SHAPES):
        g = phi_pallas.phi_cluster_size(b_cap, n_smpl, k, sms, limit)
        nc = phi_pallas.phi_neighbor_chunk(n_smpl, k, g, limit)
        smem = phi_pallas.phi_smem_bytes(n_smpl, k, nc, g)
        if phi_pallas._phi_lib().phi_kernel_smem_bytes(n_smpl, k, nc,
                                                       g) != smem:
            raise AssertionError(f"phi shared memory of {(n_smpl, k)}: "
                                 f"the kernel and the rule differ")
        case = testing.phi_case(seed, b_cap, n_smpl, k)
        cfg = testing.phi_case_config(case)
        t = {f: torch.as_tensor(case[f], device="cuda") for f in
             ("pi", "phi_sum", "beta", "nodes", "nbrs", "y", "noise")}
        step = case["step_count"]
        by_index = (cfg, t["pi"], t["phi_sum"], t["beta"], t["nodes"],
                    t["nbrs"], t["y"], step, t["noise"])
        pi_n, phis, pi_nb = phi_pallas._gather(cfg, t["pi"], t["phi_sum"],
                                               t["nodes"], t["nbrs"])
        gathered = (cfg, pi_n, phis, pi_nb, t["y"], t["beta"], step,
                    t["noise"])
        for entry, cuda, plain, args in (
                ("pre-gathered", phi_pallas.phi_update_core_cuda,
                 phi_pallas.phi_update_core_torch, gathered),
                ("by-index", phi_pallas.phi_update_rows_cuda,
                 phi_pallas.phi_update_rows_torch, by_index)):
            got = cuda(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            err = max(max_err(a, b, f"phi {entry} {name} at "
                                    f"B,n,K={b_cap},{n_smpl},{k}")
                      for a, b, name in zip(got, want, ("rows", "sums")))
            errs[entry] = max(errs.get(entry, 0.0), err)
            ref = plain(*_float64(args))
            f64 = [f64_distance(out, ref) for out in (got, want)]
            if f64[0] > 2 * f64[1]:
                raise AssertionError(
                    f"phi {entry} at {(b_cap, n_smpl, k)}: relative "
                    f"distance to float64 {f64[0]:.3e} > 2 x the plain "
                    f"version's {f64[1]:.3e}")
            ms = time_ms(lambda: cuda(*args), hold=True)
            plain_ms = time_ms(lambda: plain(*args))
            valid = int((t["nodes"] < cfg.N).sum())
            if entry == "pre-gathered":
                moved = nbytes(pi_n, phis, pi_nb, t["y"], t["beta"],
                               t["noise"])
            else:
                ids = torch.cat([t["nodes"].clamp(max=cfg.N - 1),
                                 t["nbrs"].reshape(-1)])
                moved = (int(torch.unique(ids).numel()) * k * 4
                         + valid * 4 + nbytes(t["beta"], t["nodes"],
                                              t["nbrs"], t["y"], t["noise"]))
            b_ms, b_by = bound(moved + nbytes(*got),
                               valid * (4 * n_smpl * k + 12 * k))
            if (b_cap, n_smpl, k) == PHI_MAIN_SHAPE[entry]:
                times[entry] = (ms, plain_ms, b_ms, b_by)
            phase("kernel", f"phi {entry} B,n,K={b_cap},{n_smpl},{k}: "
                  f"{g} block(s) per node, chunks of {nc} neighbors, "
                  f"{smem} B shared per block; "
                  f"kernel vs plain max abs err {err:.3e} (relative "
                  f"distance to float64: kernel {f64[0]:.3e}, plain "
                  f"{f64[1]:.3e}); {ms:.4f} ms/call kernel, "
                  f"{plain_ms:.4f} ms/call plain; bound "
                  f"{b_ms * 1e3:.3f} us ({b_by}), {100 * b_ms / ms:.2f}% "
                  f"of it")
    return {e: (errs[e], *times[e]) for e in errs}


def _mmsb_outs(st):
    return (st.pi, st.phi_sum, st.theta_b)


MMSB_FIELDS = ("pi", "phi_sum", "theta_b")


def _mmsb_window_f64(window, window_mmsb, phi_ops, cfg, state, xs, mcode,
                     keep):
    """The MMSB window in float64: the plain version's gather (float32
    values, exact in float64), its steps on the operands in float64, its
    scatter into a float64 copy of pi."""
    g, sums = window._window_gather(cfg, state, xs[0], xs[1])
    rows, sums_o, theta = window_mmsb.mmsb_window_core_torch(
        *_float64((cfg, state, xs, g, sums, mcode)))
    pi, phi_sum = phi_ops.scatter_rows(state.pi.double(),
                                       state.phi_sum.double(),
                                       xs[0].nodes.reshape(-1),
                                       keep.reshape(-1), rows, sums_o)
    return pi, phi_sum, theta


def mmsb_bound(xs, mcode, keep, k: int, n_rows: int):
    """Bound of one fused MMSB window: the pi rows and sums it must read
    (each distinct pre-window row once), every operand once, theta read
    and written once, the kept rows and sums written once; per step 2 n
    K^2 for g_link and ~15 K^2 for the theta step, ~8 n K per valid node,
    ~10 K^2 per valid edge (the p_e contraction and the fan-in)."""
    batch, nbrs, y_w, nphi_w, tn_w, ye_w, lu, lv = xs
    t_win, b_cap = batch.nodes.shape
    n_smpl = nbrs.shape[-1]
    ids = torch.cat([batch.nodes.clamp(max=n_rows - 1), nbrs], dim=-1)
    pre = mcode == 0
    rows_read = int(torch.unique(ids[pre]).numel())
    sums_read = int(torch.unique(ids[:, :b_cap][pre[:, :b_cap]]).numel())
    kept = int(keep.sum())
    operands = nbytes(y_w, batch.nodes, nbrs, batch.node_mask, keep,
                      nphi_w, tn_w, ye_w, batch.edge_mask, lu, lv, mcode,
                      batch.weight)
    moved = ((rows_read + kept) * k * 4 + (sums_read + kept) * 4 + operands
             + 2 * k * k * 2 * 4)
    b_valid = int(batch.node_mask.sum())
    e_valid = int(batch.edge_mask.sum())
    return bound(moved, (2 * n_smpl + 15) * k * k * t_win
                 + 8 * b_valid * n_smpl * k + 10 * e_valid * k * k)


def check_mmsb_kernel(window, window_mmsb, kernels, testing, phi_ops, smi):
    """Phase 3, the fused MMSB window (gather, T steps on a cluster,
    scatter; each version on its own copy of the state): (max abs err at
    T=1, and the kernel ms, plain ms, bound ms and what sets it at the
    main path's shape (12, 33, 32, 32, 64))."""
    lib = window_mmsb._mmsb_lib()
    limit = kernels.smem_limit(torch.device("cuda"))
    worst, times = 0.0, None
    for seed, shape in enumerate(MMSB_SHAPES):
        t_win, b_cap, n_smpl, e_cap, k = shape
        case = testing.mmsb_window_case(seed, *shape)
        cfg = testing.window_case_config(case)
        state, xs = testing.mmsb_window_case_torch(case, "cuda")
        batch = xs[0]
        mcode = window._correction_codes(cfg, batch.nodes, batch.node_mask,
                                          xs[1])
        keep = window._last_write_wins(batch.nodes, batch.node_mask, t_win)
        if t_win > 1 and not (mcode > 0).any():
            raise AssertionError("the case has no in-window collision")
        s_cl = window_mmsb.mmsb_window_cluster_size(*shape, limit)
        smem = window_mmsb.mmsb_window_smem_bytes(*shape, s_cl)
        if lib.mmsb_window_smem_bytes(*shape, s_cl) != smem:
            raise AssertionError(
                f"MMSB shared memory of {shape}: kernel "
                f"{lib.mmsb_window_smem_bytes(*shape, s_cl)} B, rule {smem} B")
        args = (mcode, keep)
        got = window_mmsb.mmsb_window_apply_cuda(cfg, _fresh(state), xs,
                                                 *args)
        torch.cuda.synchronize()
        want = window_mmsb.mmsb_window_apply_torch(cfg, _fresh(state), xs,
                                                   *args)
        if not torch.equal(got.theta_b, got.theta_b.transpose(0, 1)):
            raise AssertionError(f"MMSB kernel theta not symmetric at {shape}")
        ref = _mmsb_window_f64(window, window_mmsb, phi_ops, cfg,
                               _fresh(state), xs, *args)
        f64 = [f64_distance(_mmsb_outs(out), ref) for out in (got, want)]
        if t_win == 1:
            errs = [max_err(a, b, f"MMSB {name} at {shape}") for a, b, name
                    in zip(_mmsb_outs(got), _mmsb_outs(want), MMSB_FIELDS)]
            worst = max(worst, *errs)
            verdict = f"max abs err {max(errs):.3e} (normwise)"
        else:
            if not all(torch.isfinite(o).all() for o in _mmsb_outs(got)):
                raise AssertionError(f"MMSB kernel non-finite at {shape}")
            err = max(float((a - b).abs().max()) for a, b in
                      zip(_mmsb_outs(got), _mmsb_outs(want)))
            verdict = f"max abs diff {err:.3e} (conditioning-bound)"
        if f64[0] > 2 * f64[1]:
            raise AssertionError(
                f"MMSB kernel at {shape}: relative distance to float64 "
                f"{f64[0]:.3e} > 2 x the plain version's {f64[1]:.3e}")
        scratch, plain_scratch = _fresh(state), _fresh(state)
        ms = time_ms(lambda: window_mmsb.mmsb_window_apply_cuda(
            cfg, scratch, xs, *args), hold=True)
        ms_b2b = time_ms(lambda: window_mmsb.mmsb_window_apply_cuda(
            cfg, scratch, xs, *args))
        plain_ms = time_ms(lambda: window_mmsb.mmsb_window_apply_torch(
            cfg, plain_scratch, xs, *args), reps=10)
        b_ms, b_by = mmsb_bound(xs, mcode, keep, k, cfg.N)
        if shape == (12, 33, 32, 32, 64):
            times = (ms, plain_ms, b_ms, b_by)
        phase("kernel", f"MMSB window T,B,n,E,K={','.join(map(str, shape))}: "
              f"cluster of {s_cl} CTAs, {smem} B shared per CTA; kernel vs "
              f"plain {verdict}; relative distance to float64: kernel "
              f"{f64[0]:.3e}, plain {f64[1]:.3e}; theta bit-symmetric; "
              f"{ms:.4f} ms/window on the device = {1e3 * ms / t_win:.2f} "
              f"us/step, {ms_b2b:.4f} ms/window back to back with the host, "
              f"{plain_ms:.4f} ms/window plain; bound {b_ms * 1e3:.3f} us "
              f"({b_by}), {100 * b_ms / ms:.3f}% of it; {smi}")
    return worst, times


def _slice_learner(mods, engine, hoist, **kw):
    """A CPU learner (``engine``) on the N=300 collision-heavy graph, the
    operands of 23 device-sampled steps (``hoist``), and its state as a
    CPU and a GPU copy."""
    data, config, learner_mod, sampling, _ = mods
    n, u, v = data.synthetic_edges(300, 8, seed=9)
    split = data.generate_sets(n, u, v, heldout_ratio=0.1, seed=10)
    graph = data.Graph.from_edges(n, split.training_u, split.training_v)
    cfg = config.Config(mini_batch_size=8, num_node_sample=8,
                        device_sampling=True, **kw).finalize(
        n, split.total_edges, graph.max_fan_out)
    cpu = engine(cfg, graph, split, "cpu")
    ds = sampling.sample_minibatches_device(
        cfg, cpu.training_set, cpu.heldout_set, cpu.streams.sample, 23,
        cpu.adjacency)
    xs = hoist(cfg, cpu.training_set, learner_mod.DeviceBatch(*ds),
               cpu.streams)
    gpu_state = _to(cpu.state._replace(pi=cpu.state.pi.clone(),
                                       phi_sum=cpu.state.phi_sum.clone()),
                    "cuda")
    return cfg, cpu.state, gpu_state, xs


def check_host_slices(mods, phi_pallas, testing_mod):
    """Phase 4, host-sampled: 23 steps on the GPU against the CPU from one
    state, the same host batches (padded lanes hold id 0) and the same
    operands, drawn once on the CPU."""
    _, config, learner_mod, _, _ = mods
    fields = ("pi", "phi_sum", "theta", "beta")
    from mcmc_ammsb_tpu_torch.ops import edgeset
    from mcmc_ammsb_tpu_torch.ops.window import index_operands

    def both(case):
        cfg = case["cfg"]
        cpu = learner_mod.Learner(cfg, case["graph"], case["split"], "cpu",
                                  prefetch=False)
        batches = learner_mod.DeviceBatch.from_stacked(case["stacked"], "cpu")
        xs = learner_mod.hoist_operands(cfg, cpu.training_set, batches,
                                        cpu.streams)
        gpu_set = edgeset.build_edge_set(
            cfg.edgeset_backend, cfg.N, case["graph"].edges_u,
            case["graph"].edges_v, "cuda")
        gpu_state = _to(cpu.state._replace(
            pi=cpu.state.pi.clone(), phi_sum=cpu.state.phi_sum.clone()),
            "cuda")
        return cfg, cpu, xs, gpu_set, gpu_state

    # (a) one train_step per step, --phi-impl pallas: the pre-gathered entry
    case = testing_mod.host_case(9, 23, K=24, steps_per_call=1,
                                 phi_impl=config.PhiImpl.PALLAS)
    cfg, cpu, xs, gpu_set, got = both(case)
    gxs, want = _to(xs, "cuda"), cpu.state
    phi_pallas.phi_update_core_cuda.launches = 0
    phi_pallas.phi_update_rows_cuda.launches = 0
    for i in range(23):
        x, gx = (index_operands(t, i) for t in (xs, gxs))
        want = learner_mod.train_step(cfg, cpu.training_set, want, x[0],
                                      x[1], x[3], x[4])
        got = learner_mod.train_step(cfg, gpu_set, got, gx[0], gx[1], gx[3],
                                     gx[4])
    launched = phi_pallas.phi_update_core_cuda.launches
    errs = [max_err(getattr(got, f), getattr(want, f), f"host step slice {f}")
            for f in fields]
    if launched != 23 or phi_pallas.phi_update_rows_cuda.launches:
        raise AssertionError(
            f"host step slice: {launched} pre-gathered and "
            f"{phi_pallas.phi_update_rows_cuda.launches} by-index launches, "
            f"not 23 and 0")
    phase("slice", f"host-sampled, one train_step per step, --phi-impl "
          f"pallas, 23 steps ({launched} pre-gathered phi launches), N=300 "
          f"K=24, {int((~case['stacked'].node_mask).sum())} padded lanes of "
          f"id 0: GPU kernel vs CPU plain max abs err {max(errs):.3e}")

    # (b) one scanned chunk, private draws, the jnp phi
    case = testing_mod.host_case(10, 23, K=24, steps_per_call=23)
    cfg, cpu, xs, _, gpu_state = both(case)
    got = learner_mod.run_hoisted(cfg, gpu_state, _to(xs, "cuda"))
    want = learner_mod.run_hoisted(cfg, cpu.state, xs)
    errs = [max_err(getattr(got, f), getattr(want, f), f"host scan slice {f}")
            for f in fields]
    phase("slice", f"host-sampled, one scanned chunk of 23 steps, private "
          f"draws, jnp phi, N=300 K=24: GPU vs CPU max abs err "
          f"{max(errs):.3e}")


@contextlib.contextmanager
def host_law_pi(learner_mod, chains_flat, rng):
    """Within the block, pi is drawn by the numpy host law: each init's
    rows continue its theta's host stream (``rng.host_gamma_rng``, one
    block of ``pi_block_rows`` after another), not by pi's device. The
    slice phases compare a GPU loop with a CPU loop over 23 steps from
    one state, and their float32 gaps grow with that state's
    conditioning (from the device law's CPU state of the a-MMSB slice, a
    relative change of 1e-7 in pi moves beta after 23 steps much farther
    than from this one); the host law keeps their states, and so their
    tolerances, as they were before pi moved to the device."""
    streams = {}
    real_rng = rng.host_gamma_rng
    real_rows = learner_mod.gamma_rows

    def host_gamma_rng(cfg):
        streams[cfg.init_seed] = real_rng(cfg)
        return streams[cfg.init_seed]

    def gamma_rows(cfg, device, dtype=torch.float32, out=None, rows=None):
        if rows is not None:
            raise ValueError("host_law_pi draws whole inits only")
        draws = streams.pop(cfg.init_seed)
        pi, phi_sum = out or (
            torch.empty(cfg.N, cfg.K, device=device,
                        dtype=learner_mod.pi_storage_dtype(cfg)),
            torch.empty(cfg.N, dtype=dtype, device=device))
        block = learner_mod.pi_block_rows(cfg.K)
        for start in range(0, cfg.N, block):
            g = learner_mod.gamma_draws(cfg, draws, (
                min(block, cfg.N - start), cfg.K), device).to(dtype)
            s = g.sum(dim=-1)
            pi[start:start + g.shape[0]] = g / s[:, None]
            phi_sum[start:start + g.shape[0]] = s
        return pi, phi_sum

    rng.host_gamma_rng = host_gamma_rng
    learner_mod.gamma_rows = chains_flat.gamma_rows = gamma_rows
    try:
        yield
    finally:
        rng.host_gamma_rng = real_rng
        learner_mod.gamma_rows = chains_flat.gamma_rows = real_rows


def check_slices(mods, window, window_mmsb, phi_pallas, chains_flat,
                 testing_mod):
    """Phase 4: the hoisted loops on the GPU vs the CPU from one state."""
    data, config, learner_mod, sampling, mmsb = mods
    fields = ("pi", "phi_sum", "theta", "beta")

    a_mmsb = (learner_mod.Learner, learner_mod.hoist_operands)
    cfg, cpu_state, gpu_state, xs = _slice_learner(
        mods, *a_mmsb, K=24, shared_neighbors=True, window=5)
    window.window_apply_cuda.launches = 0
    got = learner_mod.run_hoisted(cfg, gpu_state, _to(xs, "cuda"))
    launched = window.window_apply_cuda.launches
    want = learner_mod.run_hoisted(cfg, cpu_state, xs)
    errs = [max_err(getattr(got, f), getattr(want, f), f"slice {f}")
            for f in fields]
    phase("slice", f"a-MMSB 23 steps (4 windows of 5 + 3 tail steps, "
          f"{launched} kernel launches), N=300 K=24: GPU kernel vs CPU "
          f"plain max abs err {max(errs):.3e}")

    cfg, cpu_state, gpu_state, xs = _slice_learner(
        mods, mmsb.FullMMSBLearner, mmsb.mmsb_hoist_operands, K=8,
        shared_neighbors=True, window=5)
    window_mmsb.mmsb_window_apply_cuda.launches = 0
    got = mmsb.mmsb_run_hoisted(cfg, gpu_state, _to(xs, "cuda"))
    launched = window_mmsb.mmsb_window_apply_cuda.launches
    want = mmsb.mmsb_run_hoisted(cfg, cpu_state, xs)
    pi_err = within(got.pi, want.pi, "MMSB slice pi", atol=PI_ATOL)
    th_err = within(got.theta_b, want.theta_b, "MMSB slice theta", **TH_TOLS)
    within(got.b, want.b, "MMSB slice b", **B_TOLS)
    if launched != 4:
        raise AssertionError(f"MMSB slice: {launched} kernel launches, not 4")
    phase("slice", f"MMSB 23 steps (4 windows of 5 + 3 tail steps, "
          f"{launched} kernel launches), N=300 K=8: GPU kernel vs CPU plain "
          f"max abs err pi {pi_err:.3e}, theta {th_err:.3e} (envelope: pi "
          f"{PI_ATOL}, theta rtol 0.1 atol 0.15)")

    cfg, cpu_state, gpu_state, xs = _slice_learner(
        mods, *a_mmsb, K=24, shared_neighbors=False,
        phi_impl=config.PhiImpl.PALLAS)
    phi_pallas.phi_update_rows_cuda.launches = 0
    got = learner_mod.run_hoisted(cfg, gpu_state, _to(xs, "cuda"))
    launched = phi_pallas.phi_update_rows_cuda.launches
    want = learner_mod.run_hoisted(cfg, cpu_state, xs)
    errs = [max_err(getattr(got, f), getattr(want, f), f"phi slice {f}")
            for f in fields]
    if launched != 23:
        raise AssertionError(f"phi slice: {launched} kernel launches, not 23")
    phase("slice", f"--phi-impl pallas 23 steps, private draws "
          f"({launched} by-index phi launches), N=300 K=24: GPU kernel vs "
          f"CPU plain max abs err {max(errs):.3e}")

    # the flat chain engine: 3 chains, 4 windows of 5 through the chain
    # kernel and 3 batched tail steps
    n, u, v = data.synthetic_edges(300, 8, seed=9)
    split = data.generate_sets(n, u, v, heldout_ratio=0.1, seed=10)
    graph = data.Graph.from_edges(n, split.training_u, split.training_v)
    cfg = config.Config(K=24, mini_batch_size=8, num_node_sample=8,
                        device_sampling=True, shared_neighbors=True,
                        window=5).finalize(n, split.total_edges,
                                           graph.max_fan_out)
    cpu = chains_flat.FlatChainLearner(cfg, graph, split, 3, "cpu")
    xs = chains_flat.hoist_chain_operands(cfg, 3, cpu.training_set,
                                          cpu.heldout_set, cpu.adjacency,
                                          cpu.streams, 23)
    gpu_state = _to(cpu.state._replace(pi=cpu.state.pi.clone(),
                                       phi_sum=cpu.state.phi_sum.clone()),
                    "cuda")
    window.window_chain_apply_cuda.launches = 0
    got = chains_flat.run_chain_hoisted(cfg, 3, gpu_state, _to(xs, "cuda"))
    launched = window.window_chain_apply_cuda.launches
    want = chains_flat.run_chain_hoisted(cfg, 3, cpu.state, xs)
    errs = [max_err(getattr(got, f), getattr(want, f), f"chain slice {f}")
            for f in fields]
    if launched != 4:
        raise AssertionError(f"chain slice: {launched} kernel launches, "
                             f"not 4")
    phase("slice", f"flat chains, C=3, 23 steps (4 windows of 5 + 3 tail "
          f"steps, {launched} fused chain launches), N=300 K=24: GPU "
          f"kernel vs CPU plain max abs err {max(errs):.3e}")

    check_host_slices(mods, phi_pallas, testing_mod)

    # the MMSB learner on the GPU learns a planted partition: the
    # identifiability knobs and the check of tests/test_mmsb.py:84-117
    n, u, v = data.synthetic_sbm_edges(300, 3, p_in=0.25, p_out=0.004,
                                       seed=31)
    split = data.generate_sets(n, u, v, heldout_ratio=0.1, seed=32)
    graph = data.Graph.from_edges(n, split.training_u, split.training_v)
    cfg = config.Config(
        K=3, mini_batch_size=16, num_node_sample=12, steps_per_call=1000,
        device_sampling=True, shared_neighbors=True, window=12,
        mmsb_prior_diag=(1.0, 50.0), mmsb_noise_scale=0.3, b=4096.0,
        eta0=50.0, eta1=1.0).finalize(n, split.total_edges,
                                      graph.max_fan_out)
    lrn = mmsb.FullMMSBLearner(cfg, graph, split, "cuda")
    window_mmsb.mmsb_window_apply_cuda.launches = 0
    p0 = lrn.heldout_perplexity()
    ppx = [e["ppx"] for e in lrn.run_with_ppx(8000, 1000)]
    launched = window_mmsb.mmsb_window_apply_cuda.launches
    b = lrn.state.b
    gap = float(b.diagonal().mean()
                - b[~torch.eye(3, dtype=torch.bool, device=b.device)].mean())
    if not all(math.isfinite(p) and p < p0 for p in ppx):
        raise AssertionError(f"planted MMSB ppx does not fall: {p0} {ppx}")
    if gap <= 0.5 or launched != 8 * (1000 // 12):
        raise AssertionError(f"planted MMSB: diag - off {gap:.3f}, "
                             f"{launched} kernel launches")
    if not torch.equal(lrn.state.theta_b, lrn.state.theta_b.transpose(0, 1)):
        raise AssertionError("planted MMSB: theta not symmetric")
    phase("slice", f"MMSB on a planted 3-block partition (N={n}, K=3, "
          f"window 12, 8000 steps, {launched} kernel launches): ppx "
          f"{p0:.4f} -> {[round(p, 4) for p in ppx]}, diag(B) - off(B) "
          f"{gap:.3f} > 0.5")


def _run_cli(cli, args):
    """cli.main(args) with its log records kept: (ppx series [(step,
    ppx, created)] — ppx a float, or a list of the chains' — and every
    logged message)."""
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append((record.created, record.getMessage()))

    handler = Keep()
    logging.getLogger("mcmc_ammsb_tpu_torch").addHandler(handler)
    try:
        rc = cli.main(args)
    finally:
        logging.getLogger("mcmc_ammsb_tpu_torch").removeHandler(handler)
    if rc != 0:
        raise AssertionError(f"cli.main{tuple(args)} returned {rc}")
    series = []
    for created, msg in records:
        m = re.fullmatch(r"ppx\[(\d+)\] = (\S+|\[.*\])", msg)
        if m:
            text = m.group(2)
            value = ([float(x) for x in text[1:-1].split()]
                     if text.startswith("[") else float(text))
            series.append((int(m.group(1)), value, created))
    values = [x for _, p, _ in series
              for x in (p if isinstance(p, list) else [p])]
    if not all(math.isfinite(x) for x in values):
        raise AssertionError(f"non-finite ppx {series}")
    return series, [msg for _, msg in records]


def _counts(mods, what):
    """Reset every kernel's launch count (``what`` None), or read them:
    {kernel: launches}, and "chains", the chains the chain-mode launches
    ran in all."""
    window, window_mmsb, phi_pallas, refblock = mods
    counters = {"window": (window.window_apply_cuda, "launches"),
                "window_wide": (window.window_apply_cuda, "wide_launches"),
                "window_chain": (window.window_chain_apply_cuda, "launches"),
                "window_chain_wide": (window.window_chain_apply_cuda,
                                      "wide_launches"),
                "mmsb": (window_mmsb.mmsb_window_apply_cuda, "launches"),
                "phi": (phi_pallas.phi_update_core_cuda, "launches"),
                "phi_gather": (phi_pallas.phi_update_rows_cuda, "launches"),
                "randn": (refblock.randn_lanes, "launches"),
                "neighbors": (refblock.neighbors_lanes, "launches"),
                "gamma": (refblock.gamma_lanes, "launches")}
    if what is None:
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        window.window_chain_apply_cuda.chains = 0
        return None
    return {**{k: getattr(fn, attr) for k, (fn, attr) in counters.items()},
            "chains": window.window_chain_apply_cuda.chains}


def run_main(cli, kmods):
    """Phase 5, the a-MMSB main path: (launches of each kernel,
    ppx[0])."""
    _counts(kmods, None)
    series, _ = _run_cli(cli, MAIN_ARGS)
    launches = _counts(kmods, "read")
    steps = [s for s, _, _ in series]
    if steps != [0, 500, 1000, 1500, 2000]:
        raise AssertionError(f"unexpected ppx steps {steps}")
    ppx = [p for _, p, _ in series]
    if not (all(p < ppx[0] for p in ppx[1:]) and ppx[-1] < ppx[1]):
        raise AssertionError(f"ppx does not decrease: {ppx}")
    expected = 4 * (500 // 12)     # 4 intervals of 41 windows + 8 tail
    if launches["window"] != expected:
        raise AssertionError(f"window kernel launched {launches['window']} "
                             f"times, expected {expected}")
    # steady state: the second 1000-step call, whose numbers reach the
    # host only after the device finished it
    t1000 = next(c for s, _, c in series if s == 1000)
    t2000 = next(c for s, _, c in series if s == 2000)
    rate = 1000 / (t2000 - t1000)
    phase("main", f"a-MMSB: rc 0, ppx {ppx}, window-kernel launches "
          f"{launches['window']} (= {expected} windows), steady state "
          f"{rate:.1f} updates/s")
    return launches, ppx, rate


def run_wide_main(cli, kmods, main_l, main_rate, main_mem, smi):
    """Phase 5, the main path at K = 4096 (WIDE_ARGS, 2000 steps): the
    automatic window 12 runs unclamped on the window kernel, with as many
    launches as the K = 256 main path, every one in the wide mode (the
    layout of the plan printed), and no other kernel entry; ppx falls
    below ppx[0]. Returns (launches, ppx, steady-state updates/s, peak
    device memory, seconds of the run)."""
    torch.cuda.reset_peak_memory_stats()
    _counts(kmods, None)
    t0 = time.perf_counter()
    series, messages = _run_cli(cli, WIDE_ARGS)
    seconds = time.perf_counter() - t0
    mem = torch.cuda.max_memory_allocated()
    launches = _counts(kmods, "read")
    if (any("window auto-clamped" in m for m in messages)
            or not any(m.startswith("windows of 12 steps run the window "
                                    "kernel") for m in messages)):
        raise AssertionError(f"-k 4096: not windowed at T = 12 on the "
                             f"kernel: {[m for m in messages if 'window' in m]}")
    ppx = [p for _, p, _ in series]
    if ([st for st, _, _ in series] != [0, 500, 1000, 1500, 2000]
            or not all(p < ppx[0] for p in ppx[1:])):
        raise AssertionError(f"-k 4096: ppx series {series}")
    want = {k: 0 for k in launches}
    want.update(window=main_l["window"], window_wide=main_l["window"])
    if launches != want:
        raise AssertionError(f"-k 4096: launches {launches}, expected "
                             f"{want}")
    t = {st: c for st, _, c in series}
    rate = 1000 / (t[2000] - t[1000])
    win = kmods[0]
    s_cl, layout, wc = win.window_plan(
        *WIDE_MAIN_SHAPE, win.kernels.smem_limit(torch.device("cuda")))
    phase("main", f"a-MMSB -k 4096: rc 0, ppx {ppx}, window-kernel "
          f"launches {launches['window']} (the K = 256 main path: "
          f"{main_l['window']}), all {launches['window_wide']} in the wide "
          f"mode ({layout} layout, S = {s_cl}, wc = {wc}); steady state "
          f"{rate:.1f} updates/s (the K = 256 main path: {main_rate:.1f}); "
          f"peak device memory {mem} B (K = 256: {main_mem} B); "
          f"{seconds:.1f} s in all (host init included); {smi}")
    return launches, ppx, rate, mem, seconds


def run_mmsb_main(cli, kmods):
    """Phase 5, --model mmsb --window 12. On this uniform random graph
    there is no structure to learn: the held-out population is half
    links and half non-links, and ppx[0] is already at 2, the bound of
    any model that gives every pair the same link probability, so the
    series does not fall (a CPU run of the same command read 2.0002,
    2.0008, 2.0041). The check is a finite series within 5% of ppx[0];
    learning is checked on the planted partition in phase 4."""
    _counts(kmods, None)
    series, _ = _run_cli(cli, MMSB_ARGS)
    launches = _counts(kmods, "read")
    ppx = [p for _, p, _ in series]
    if [s for s, _, _ in series] != [0, 500, 1000]:
        raise AssertionError(f"unexpected MMSB ppx steps {series}")
    if not all(abs(p / ppx[0] - 1.0) < 0.05 for p in ppx):
        raise AssertionError(f"MMSB ppx leaves the plateau: {ppx}")
    expected = 2 * (500 // 12)
    if (launches["mmsb"] != expected or launches["window"]
            or launches["window_chain"]):
        raise AssertionError(f"MMSB run launches {launches}, expected "
                             f"{expected} fused MMSB window launches and "
                             f"no other window entry")
    rate = 1000 / (series[-1][2] - series[0][2])
    phase("main", f"MMSB: rc 0, ppx {ppx}, fused MMSB-kernel launches "
          f"{launches['mmsb']} (= {expected} windows), a-MMSB window "
          f"launches {launches['window']}, {rate:.1f} updates/s "
          f"over the 1000 steps after ppx[0]")
    return launches


def run_phi_main(cli, kmods):
    """Phase 5, --phi-impl pallas --device-sampling."""
    _counts(kmods, None)
    series, _ = _run_cli(cli, PHI_ARGS)
    launches = _counts(kmods, "read")
    ppx = [p for _, p, _ in series]
    if [s for s, _, _ in series] != [0, 500, 1000]:
        raise AssertionError(f"unexpected phi ppx steps {series}")
    if not all(p < ppx[0] for p in ppx[1:]):
        raise AssertionError(f"phi path ppx does not decrease: {ppx}")
    if launches["phi_gather"] != 1000 or launches["window"]:
        raise AssertionError(f"phi path launches {launches}, expected 1000 "
                             f"by-index phi launches and no window kernel")
    rate = 1000 / (series[-1][2] - series[0][2])
    phase("main", f"--phi-impl pallas: rc 0, ppx {ppx}, by-index phi "
          f"launches {launches['phi_gather']}, window-kernel launches "
          f"{launches['window']}, {rate:.1f} updates/s over the 1000 steps "
          f"after ppx[0]")
    return launches


def run_chain_main(cli, kmods):
    """Phase 5, --num-chains 16 at the JAX bench's chain configuration:
    (launches, aggregate updates/s over the second interval, host
    seconds of the chains' init)."""
    _counts(kmods, None)
    series, messages = _run_cli(cli, CHAIN_ARGS)
    launches = _counts(kmods, "read")
    if [s for s, _, _ in series] != [0, 504, 1008]:
        raise AssertionError(f"unexpected chain ppx steps {series}")
    ppx = [p for _, p, _ in series]
    if not all(isinstance(p, list) and len(p) == CHAINS for p in ppx):
        raise AssertionError(f"chain ppx is not a {CHAINS}-vector: {ppx}")
    if not all(q < q0 for p in ppx[1:] for q, q0 in zip(p, ppx[0])):
        raise AssertionError(f"a chain's ppx does not fall: {ppx}")
    expected = 2 * (504 // 6)     # 2 intervals of 84 windows, no tail
    if (launches["window_chain"] != expected
            or launches["chains"] != CHAINS * expected
            or launches["window"]):
        raise AssertionError(f"chain run launches {launches}, expected "
                             f"{expected} chain-kernel launches of "
                             f"{CHAINS} chains and no single-chain one")
    init = next(float(m.group(1)) for m in (
        re.search(r"chains initialized in (\S+) s", msg) for msg in messages)
        if m)
    rate = CHAINS * 504 / (series[2][2] - series[1][2])
    phase("main", f"--num-chains {CHAINS}: rc 0, ppx[0] {ppx[0]}, ppx[1008] "
          f"{ppx[2]}; chain-kernel launches {launches['window_chain']} "
          f"(= {expected} windows, {launches['chains']} chain blocks), "
          f"single-chain launches {launches['window']}; aggregate "
          f"{rate:.1f} updates/s over the second 504-step interval; init "
          f"of the {CHAINS} chains {init:.3f} s (pi drawn on the card)")
    return launches, rate, init


def run_host_main(cli, kmods, name, smi):
    """Phase 5, one of HOST_RUNS: its launches."""
    args, steps, interval, expected, needles = HOST_RUNS[name]
    _counts(kmods, None)
    series, messages = _run_cli(cli, args)
    launches = _counts(kmods, "read")
    if [s for s, _, _ in series] != list(range(0, steps + 1, interval)):
        raise AssertionError(f"{name}: unexpected ppx steps {series}")
    ppx = [p for _, p, _ in series]
    if not ppx[-1] < ppx[0]:
        raise AssertionError(f"{name}: ppx does not fall: {ppx}")
    want = {k: expected.get(k, 0) for k in launches}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    for needle in needles:
        if not any(needle in m for m in messages):
            raise AssertionError(f"{name}: the log lacks {needle!r}")
    rate = steps / (series[-1][2] - series[0][2])
    phase("main", f"{name}: rc 0, ppx {ppx}; launches: pre-gathered phi "
          f"{launches['phi']}, by-index phi {launches['phi_gather']}, window "
          f"entries {launches['window'] + launches['window_chain'] + launches['mmsb']}"
          f"; logged {needles}; {rate:.1f} updates/s over the {steps} steps "
          f"after ppx[0], evaluations included; {smi}")
    return launches


def run_rhat(cli):
    """Phase 5, the R-hat line of --rhat-draws 2 (a small graph)."""
    _, messages = _run_cli(cli, RHAT_ARGS)
    line = next(m for m in messages if m.startswith("beta R-hat"))
    vals = [float(x) for x in re.findall(r"(?:max|median) (\S+)", line)]
    if len(vals) != 2 or not all(math.isfinite(x) for x in vals):
        raise AssertionError(f"R-hat line not finite: {line}")
    phase("main", f"--num-chains 3 --rhat-draws 2: {line}")


def check_mmsb_engine_slices(mods, testing_mod):
    """Phase 4, the MMSB engines without a kernel: 23 steps on the GPU
    against the CPU from one state and one operand tuple (the MMSB
    envelope: GPU and CPU matrix products sum in other orders and the
    1/theta conditioning amplifies it), then the chain learner on the
    planted partition."""
    data, config, learner_mod, _, mmsb = mods

    def agree(got, want, what):
        pi = within(got.pi, want.pi, f"{what} pi", atol=PI_ATOL)
        th = within(got.theta_b, want.theta_b, f"{what} theta", **TH_TOLS)
        within(got.b, want.b, f"{what} b", **B_TOLS)
        return pi, th

    n, u, v = data.synthetic_edges(300, 8, seed=9)
    split = data.generate_sets(n, u, v, heldout_ratio=0.1, seed=10)
    graph = data.Graph.from_edges(n, split.training_u, split.training_v)
    cfg = config.Config(K=8, mini_batch_size=8, num_node_sample=8,
                        device_sampling=True, shared_neighbors=True
                        ).finalize(n, split.total_edges, graph.max_fan_out)
    cpu = mmsb.MMSBChainLearner(cfg, graph, split, 3, "cpu")
    xs = mmsb.mmsb_hoist_chain_operands(cfg, 3, cpu.training_set,
                                        cpu.heldout_set, cpu.adjacency,
                                        cpu.streams, 23)
    got = mmsb.mmsb_run_chain_hoisted(cfg, 3, _to(_fresh(cpu.state), "cuda"),
                                      _to(xs, "cuda"))
    want = mmsb.mmsb_run_chain_hoisted(cfg, 3, cpu.state, xs)
    pi_err, th_err = agree(got, want, "MMSB chain slice")
    phase("slice", f"MMSB chain engine, C=3, 23 batched steps (torch ops, no "
          f"kernel), N=300 K=8: GPU vs CPU max abs err pi {pi_err:.3e}, "
          f"theta {th_err:.3e} (envelope: pi {PI_ATOL}, theta rtol 0.1 atol "
          f"0.15)")

    case = testing_mod.host_case(11, 23, K=8, steps_per_call=23)
    cfg = case["cfg"]
    cpu = mmsb.FullMMSBLearner(cfg, case["graph"], case["split"], "cpu",
                               prefetch=False)
    xs = mmsb.mmsb_hoist_operands(
        cfg, cpu.training_set,
        learner_mod.DeviceBatch.from_stacked(case["stacked"], "cpu"),
        cpu.streams)
    got = mmsb.mmsb_run_hoisted(cfg, _to(_fresh(cpu.state), "cuda"),
                                _to(xs, "cuda"))
    want = mmsb.mmsb_run_hoisted(cfg, cpu.state, xs)
    pi_err, th_err = agree(got, want, "host MMSB slice")
    phase("slice", f"host-sampled MMSB, one scanned chunk of 23 steps, "
          f"private draws, N=300 K=8: GPU vs CPU max abs err pi "
          f"{pi_err:.3e}, theta {th_err:.3e}")

    n, u, v = data.synthetic_sbm_edges(300, 3, p_in=0.25, p_out=0.004,
                                       seed=31)
    split = data.generate_sets(n, u, v, heldout_ratio=0.1, seed=32)
    graph = data.Graph.from_edges(n, split.training_u, split.training_v)
    cfg = config.Config(
        K=3, mini_batch_size=16, num_node_sample=12, steps_per_call=1000,
        device_sampling=True, shared_neighbors=True,
        mmsb_prior_diag=(1.0, 50.0), mmsb_noise_scale=0.3, b=4096.0,
        eta0=50.0, eta1=1.0).finalize(n, split.total_edges,
                                      graph.max_fan_out)
    lrn = mmsb.MMSBChainLearner(cfg, graph, split, 3, "cuda")
    p0 = lrn.heldout_perplexity()
    ppx = [e["ppx"] for e in lrn.run_with_ppx(4000, 1000)]
    b = lrn.state.b
    eye = torch.eye(3, dtype=torch.bool, device=b.device)
    gaps = [float(b[c].diagonal().mean() - b[c][~eye].mean())
            for c in range(3)]
    if not all((p < p0).all() for p in ppx):
        raise AssertionError(f"planted MMSB chains: ppx does not fall: "
                             f"{p0} {ppx}")
    if min(gaps) <= 0.5:
        raise AssertionError(f"planted MMSB chains: diag - off {gaps}")
    if not torch.equal(lrn.state.theta_b, lrn.state.theta_b.transpose(1, 2)):
        raise AssertionError("planted MMSB chains: theta not symmetric")
    phase("slice", f"MMSB chains on a planted 3-block partition (N={n}, K=3, "
          f"C=3, 4000 steps): ppx {p0.round(4).tolist()} -> "
          f"{ppx[-1].round(4).tolist()}, diag(B) - off(B) per chain "
          f"{[round(g, 3) for g in gaps]}, all > 0.5")


def run_new_main(cli, kmods, name, smi):
    """Phase 5, one of NEW_RUNS: an engine that launches no kernel."""
    args, steps, interval, chains, falls = NEW_RUNS[name]
    _counts(kmods, None)
    series, messages = _run_cli(cli, args)
    launches = _counts(kmods, "read")
    if [s for s, _, _ in series] != list(range(0, steps + 1, interval)):
        raise AssertionError(f"{name}: unexpected ppx steps {series}")
    ppx = [p if isinstance(p, list) else [p] for _, p, _ in series]
    if not all(len(p) == chains for p in ppx):
        raise AssertionError(f"{name}: not {chains} values per line: {ppx}")
    if falls and not all(q < q0 for q, q0 in zip(ppx[-1], ppx[0])):
        raise AssertionError(f"{name}: ppx does not fall: {ppx}")
    if not falls and not all(abs(q / q0 - 1.0) < 0.05
                             for p in ppx for q, q0 in zip(p, ppx[0])):
        # the structure-free plateau at 2 (see run_mmsb_main)
        raise AssertionError(f"{name}: ppx leaves the plateau: {ppx}")
    if any(launches.values()):
        raise AssertionError(f"{name}: launches {launches}, expected none")
    rate = chains * steps / (series[-1][2] - series[0][2])
    phase("main", f"{name}: rc 0, ppx[0] {ppx[0]}, ppx[{steps}] {ppx[-1]}; no "
          f"kernel launch (torch ops); {rate:.1f} updates/s"
          f"{' aggregate' if chains > 1 else ''} over the {steps} steps "
          f"after ppx[0], evaluations included; {smi}")


def run_train_ppx_main(cli, kmods, smi):
    """Phase 5, --calc-train-ppx on the main path."""
    _counts(kmods, None)
    t0 = time.perf_counter()
    series, messages = _run_cli(cli, TRAIN_PPX_ARGS + ["--device", "cuda"])
    launches = _counts(kmods, "read")
    train = [(int(m.group(1)), float(m.group(2))) for m in (
        re.fullmatch(r"train_ppx\[(\d+)\] = (\S+)", msg) for msg in messages)
        if m]
    ppx = [p for _, p, _ in series]
    if [s for s, _ in train] != [500, 1000]:
        raise AssertionError(f"train_ppx lines {train}")
    if not all(math.isfinite(p) and p > 1.0 for _, p in train):
        raise AssertionError(f"train_ppx not finite: {train}")
    if not ppx[-1] < ppx[0] or launches["window"] != 2 * (500 // 12):
        raise AssertionError(f"--calc-train-ppx run: ppx {ppx}, launches "
                             f"{launches}")
    phase("main", f"--calc-train-ppx --train-ppx-ratio 0.00001: rc 0, ppx "
          f"{ppx}, train_ppx {train} ("
          f"{'falls' if train[1][1] < train[0][1] else 'does not fall'}), "
          f"window-kernel launches {launches['window']}; "
          f"{time.perf_counter() - t0:.1f} s with the population's host "
          f"build; {smi}")
    return launches


def run_cache_main(cli, tmp, main_ppx0):
    """Phase 5, --dump-data then --load-data: the main path's ppx[0]."""
    import os

    cache = os.path.join(tmp, "graph.npz")
    t0 = time.perf_counter()
    if cli.main(["--synthetic", "317080,7", "--dump-data", "--dump-file",
                 cache, "--device", "cuda"]) != 0:
        raise AssertionError("--dump-data did not return 0")
    dump_s = time.perf_counter() - t0
    series, messages = _run_cli(cli, ["--load-data", "--load-file", cache,
                                      "-k", "256", "-x", "500", "-i", "500",
                                      "--device", "cuda"])
    ppx = [p for _, p, _ in series]
    if ppx[0] != main_ppx0 or not ppx[1] < ppx[0]:
        raise AssertionError(f"--load-data: ppx {ppx}, the main path's "
                             f"ppx[0] is {main_ppx0}")
    phase("main", f"--dump-data ({os.path.getsize(cache)} B, {dump_s:.2f} s "
          f"with the graph's generation) then --load-data: ppx {ppx}, "
          f"ppx[0] equal to the main path's")


def _ref_host_chunk(cli, sampler_cls, bench, steps):
    """A chunk of ``steps`` host batches of the --rng reference path (its
    64 node lanes and real masks) on the card: (nodes, node_mask)."""
    n, split, graph = bench
    args = cli.build_arg_parser().parse_args(REF_ARGS)
    cli.resolve_fast_defaults(args)
    cfg = cli.config_from_args(args).finalize(n, split.total_edges,
                                              graph.max_fan_out)
    chunk = sampler_cls(cfg, graph, split).sample_many(steps)
    return (torch.as_tensor(chunk.nodes, device="cuda"),
            torch.as_tensor(chunk.node_mask, device="cuda"), cfg)


def check_ref_rng_kernel(cli, refblock, ref_rng, sampler_cls, bench):
    """Phase 3, csrc/ref_rng_kernel.cu: each entry against the plain
    version (rng/reference.py) on the same CUDA seeds, values and seeds
    bit for bit, at the --rng reference path's launch shapes: the phi
    noise of a 200-step chunk of real host batches (64 lanes, K=256) in
    one launch, its theta noise (200, 256 lanes, 2), its neighbor draws
    (200, 64 lanes, n=32, N=317,080) and the pi init's Gamma draws
    (317,080 x 32 lanes, 8 column blocks); and Gamma draws with a < 1
    (the boost pre-pass) on 1280 lanes. The plain phi noise runs a
    rejection loop per draw (~1 s per step of the chunk on the card), so
    it draws only the chunk's last REF_PLAIN_STEPS steps, from the seeds a
    kernel launch over the steps before them leaves; the whole launch's
    earlier steps equal that launch's values. Kernel times by CUDA events
    (20 calls at the launch shape), the plain version's by its one
    comparison call (for the phi noise: its REF_PLAIN_STEPS steps).
    Returns {entry: (0.0, (ms, plain_ms, bound_ms, bound_by), plain
    steps)} for the main path's three entries."""
    nodes, mask, cfg = _ref_host_chunk(cli, sampler_cls, bench, 200)
    s_len, lanes = mask.shape
    seeds = ref_rng.make_seeds(cfg.phi_seed, lanes, "cuda")
    beta_seeds = ref_rng.make_seeds(cfg.beta_seed, cfg.K, "cuda")
    every = torch.ones(s_len, cfg.K, dtype=torch.bool, device="cuda")
    width = (cfg.K - 32 * torch.arange(-(-cfg.K // 32), device="cuda")
             ).clamp(max=32)
    g_mask = (torch.arange(32, device="cuda")[None, :] < width[:, None]
              ).repeat(1, cfg.N)
    g_seeds = ref_rng.make_seeds((11, 113), cfg.N * 32, "cuda")
    boost_seeds = ref_rng.make_seeds((5, 7), 1280, "cuda")
    boost_mask = torch.ones(4, 1280, dtype=torch.bool, device="cuda")
    cut = s_len - REF_PLAIN_STEPS
    head, head_seeds = refblock.randn_lanes(seeds, cfg.K, mask[:cut])

    def state(streams):
        # xorshift128+ state: four 32-bit words per stream, read and written
        return 2 * 16 * streams

    # entry: (kernel, plain, the kernel's (values, seeds) the plain ones
    # are held against, the bytes the function must move, its float32
    # operations: one product per Gaussian draw (the ziggurat's j * w), one
    # for the rest at least)
    cases = {
        "randn_lanes": (
            lambda: refblock.randn_lanes(seeds, cfg.K, mask),
            lambda: ref_rng.randn_lanes(head_seeds, cfg.K, mask[cut:]),
            lambda got: (got[0][cut:], got[1]),
            state(lanes) + nbytes(mask) + s_len * lanes * cfg.K * 4,
            int(mask.sum()) * cfg.K),
        "randn_lanes (theta noise)": (
            lambda: refblock.randn_lanes(beta_seeds, 2, every),
            lambda: ref_rng.randn_lanes(beta_seeds, 2, every),
            lambda got: got, state(cfg.K) + s_len * cfg.K * 2 * 4,
            s_len * cfg.K * 2),
        "neighbors_lanes": (
            lambda: refblock.neighbors_lanes(seeds, nodes, mask, cfg.N,
                                             cfg.num_node_sample),
            lambda: ref_rng.neighbors_lanes(seeds, nodes, mask, cfg.N,
                                            cfg.num_node_sample),
            # node ids and drawn ids fit 32 bits
            lambda got: got, state(lanes) + nbytes(mask) + s_len * lanes
            * (1 + cfg.num_node_sample) * 4, 0),
        "gamma_lanes": (
            lambda: refblock.gamma_lanes(g_seeds, cfg.eta0, cfg.eta1, g_mask),
            lambda: ref_rng.gamma_lanes(g_seeds, cfg.eta0, cfg.eta1, g_mask),
            # the mask follows from K alone (all true at K = 256)
            lambda got: got, state(g_seeds.shape[0]) + g_mask.numel() * 4,
            int(g_mask.sum())),
    }
    for a in (0.5, 0.3):
        cases[f"gamma_lanes (a={a}, the boost pre-pass)"] = (
            lambda a=a: refblock.gamma_lanes(boost_seeds, a, 2.0, boost_mask),
            lambda a=a: ref_rng.gamma_lanes(boost_seeds, a, 2.0, boost_mask),
            lambda got: got, state(1280) + boost_mask.numel() * 4,
            boost_mask.numel())
    out = {}
    for name, (kernel, plain, pick, need, draws) in cases.items():
        got = kernel()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain()
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        for g, w, what in zip(pick(got), want, ("values", "seeds")):
            if not torch.equal(g, w):
                raise AssertionError(
                    f"{name}: kernel {what} differ from the plain version's "
                    f"at {int((g != w).sum())} of {g.numel()} elements")
        note = ""
        if name == "randn_lanes":
            if not torch.equal(got[0][:cut], head):
                raise AssertionError(
                    f"randn_lanes: the {s_len}-step launch's first {cut} "
                    f"steps differ from a {cut}-step launch's")
            note = (f" (its last {REF_PLAIN_STEPS} steps, from the seeds a "
                    f"{cut}-step launch leaves; the first {cut} equal that "
                    f"launch's)")
        plain_steps = want[0].shape[0]
        ms = time_ms(kernel, reps=20)
        b_ms, by = bound(need, draws)
        out[name] = (0.0, (ms, plain_ms, b_ms, by), plain_steps)
        phase("kernel", f"ref_rng {name} {tuple(got[0].shape)}: values and "
              f"seeds bit-equal to the plain version{note}; {ms:.4f} ms per "
              f"launch vs plain {plain_ms:.1f} ms (one call of {plain_steps} "
              f"steps); bound {b_ms * 1e3:.3f} us ({by})")
    return out


def run_ref_main(cli, kmods, name, smi):
    """Phase 5, one of REF_RUNS: the reference-RNG and device-BF paths,
    each with a finite series (falling where the strategy shows links)
    and exact launch counts."""
    args, steps, interval, expected, falls, needles = REF_RUNS[name]
    _counts(kmods, None)
    series, messages = _run_cli(cli, args + ["--device", "cuda"])
    launches = _counts(kmods, "read")
    if [s for s, _, _ in series] != list(range(0, steps + 1, interval)):
        raise AssertionError(f"{name}: unexpected ppx steps {series}")
    ppx = [p if isinstance(p, list) else [p] for _, p, _ in series]
    if falls and not all(q < q0 for q, q0 in zip(ppx[-1], ppx[0])):
        raise AssertionError(f"{name}: ppx does not fall: {ppx}")
    want = {k: expected.get(k, 0) for k in launches}
    want["chains"] = launches["chains"]
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    for needle in needles:
        if not any(needle in m for m in messages):
            raise AssertionError(f"{name}: the log lacks {needle!r}")
    chains = len(ppx[0])
    rate = chains * steps / (series[-1][2] - series[0][2])
    phase("main", f"{name}: rc 0, ppx[0] {ppx[0]}, ppx[{steps}] {ppx[-1]}; "
          f"launches {({k: v for k, v in launches.items() if v})}; logged "
          f"{needles}; {rate:.1f} updates/s{' aggregate' if chains > 1 else ''}"
          f" over the {steps} steps after ppx[0], evaluations included; "
          f"{smi}")
    return launches


def run_profile_tune_main(cli, kmods, smi):
    """Phase 5, --profile --auto-tune-window on the main path: every
    window candidate probed without a failure, the stage table printed
    from a trace of the card's kernels."""
    _counts(kmods, None)
    t0 = time.perf_counter()
    series, messages = _run_cli(cli, PROFILE_ARGS)
    wall = time.perf_counter() - t0
    tuned = [m for m in messages if m.startswith("window auto-tuned to ")]
    if len(tuned) != 1 or "failed" in tuned[0]:
        raise AssertionError(f"--auto-tune-window: {tuned or 'no pick'}")
    table = [m for m in messages if m.startswith("fused per-step stage "
                                                 "profile")]
    if not table or "device-kernel time" not in table[0]:
        raise AssertionError(f"--profile: no traced device table "
                             f"{[m for m in messages if 'profile' in m]}")
    start = messages.index(table[0])
    end = next(i for i in range(start, len(messages))
               if messages[i].startswith("TOTAL OPS"))
    rows = messages[start + 1:end + 1] + [
        m for m in messages[end + 1:end + 2] if m.startswith("(of OTHER")]
    # the hand kernel's device time must be in the table, under its stage
    if not rows[0].startswith("WINDOW_KERNEL"):
        raise AssertionError(f"--profile: window_kernel is not the largest "
                             f"stage: {rows}")
    ppx = [p for _, p, _ in series]
    if not ppx[-1] < ppx[0]:
        raise AssertionError(f"--profile --auto-tune-window: ppx {ppx}")
    phase("main", f"--profile --auto-tune-window: {tuned[0]}; ppx {ppx}; "
          f"{table[0]}: {rows}; {wall:.1f} s in all; {smi}")


def check_ref_api(cli, native, kmods, window, bench, smi):
    """Checks through the API on the card: --rng reference against
    --no-ref-rng-block over 20 steps (every state field and seed bit-equal:
    the kernel's draws, init included, are the plain version's), with the
    seconds of each; --theta-init libstdc++ (theta the native stream's);
    window_correction='auto' (run as 'always') against 'always' over 1008
    main-path steps, bit-equal, with the number of dirty windows."""
    def state_diffs(a, b):
        out = []
        for f, x, y in zip(a._fields, a, b):
            xs = x if isinstance(x, tuple) else (x,)
            ys = y if isinstance(y, tuple) else (y,)
            for u, v in zip(xs, ys):
                if isinstance(u, torch.Tensor):
                    if not torch.equal(u, v):
                        out.append(f)
                elif u != v:
                    out.append(f)
        return out

    runs, secs = [], []
    for extra in ([], ["--no-ref-rng-block"]):
        lrn = _api_learner(cli, REF_API_ARGS + extra, bench)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lrn.run(20)
        secs.append(time.perf_counter() - t0)
        runs.append(lrn.state)
        lrn.close()
    diffs = state_diffs(*runs)
    if diffs:
        raise AssertionError(f"--no-ref-rng-block differs in {diffs}")
    phase("api", f"--rng reference vs --no-ref-rng-block, 20 steps in "
          f"chunks of 10, K=256: every state field and the three seed "
          f"arrays bit-equal; {secs[0]:.3f} s with the kernel, {secs[1]:.3f} "
          f"s with the plain version; {smi}")

    lrn = _api_learner(cli, REF_API_ARGS + ["--theta-init", "libstdc++"],
                       bench)
    want = native.ref_theta_init(lrn.cfg.eta0, lrn.cfg.eta1,
                                 lrn.cfg.init_seed, 2 * lrn.cfg.K)
    if not torch.equal(lrn.state.theta.cpu().reshape(-1),
                       torch.from_numpy(want)):
        raise AssertionError("--theta-init libstdc++: theta is not the "
                             "native stream's")
    lrn.close()
    phase("api", "--theta-init libstdc++: theta equals native.ref_theta_init "
          "(std::mt19937 + std::gamma_distribution) bit for bit")

    # 'auto' runs as 'always'; the windows JAX would skip the codes of
    # are counted by _dirty_windows on the operands of the call
    found, real = [], window.iter_windows

    def counted(cfg, xs, nbrs):
        t = cfg.window
        s_len = nbrs.shape[0] // t * t
        found.append(int(window._dirty_windows(
            *(a[:s_len].reshape(s_len // t, t, -1)
              for a in (xs[0].nodes, xs[0].node_mask, nbrs)), t).sum()))
        return real(cfg, xs, nbrs)

    states = []
    for corr in ("always", "auto"):
        lrn = _api_learner(cli, AUTO_ARGS, bench, window_correction=corr)
        found.clear()
        window.iter_windows = counted
        _counts(kmods, None)
        try:
            lrn.run(1008)
        finally:
            window.iter_windows = real
        launches = _counts(kmods, "read")["window"]
        states.append(lrn.state)
        lrn.close()
        if launches != 84:
            raise AssertionError(f"window_correction={corr!r}: {launches} "
                                 f"window launches")
    diffs = state_diffs(*states)
    if diffs:
        raise AssertionError(f"window_correction='auto' differs in {diffs}")
    phase("api", f"window_correction='auto' (run as 'always') vs 'always', "
          f"1008 main-path steps: every state field bit-equal; "
          f"{sum(found)} of 84 windows dirty, 84 window launches each")


def run_sharded_phases(cli, kmods, main_l, main_rate, testing, bench, smi):
    """Phase sharded: the multi-GPU paths on the one card, each through
    NCCL process groups of size 1 and the sharded code (row fetch,
    write-back, collectives): the CLI at --mesh 1,1 on the main path, one
    sharded window against the single-GPU kernel and its plain version,
    ShardedChainLearner with G = 1, --partitioned-ingest on the bench
    graph as a SNAP file. Returns {path: launches} and the window check's
    numbers."""
    import os

    from mcmc_ammsb_tpu_torch.ops import window
    from mcmc_ammsb_tpu_torch.parallel import multihost
    from mcmc_ammsb_tpu_torch.parallel.chains_sharded import (
        ShardedChainLearner, make_chain_mesh)
    from mcmc_ammsb_tpu_torch.parallel.mesh import make_mesh
    from mcmc_ammsb_tpu_torch.parallel.sharded import (ShardCtx,
                                                       sharded_window_apply)

    import torch.distributed as dist

    out = {}
    # the CLI at --mesh 1,1: it starts and ends its own group of size 1
    _counts(kmods, None)
    series, messages = _run_cli(cli, SHARDED_ARGS)
    launches = _counts(kmods, "read")
    if not any("torch.distributed: rank 0 of 1 (nccl)" in m
               for m in messages):
        raise AssertionError("--mesh 1,1 did not start an NCCL group")
    ppx = [p for _, p, _ in series]
    if ([st for st, _, _ in series] != [0, 500, 1000, 1500, 2000]
            or not (all(p < ppx[0] for p in ppx[1:]) and ppx[-1] < ppx[1])):
        raise AssertionError(f"--mesh 1,1: ppx series {series}")
    if (launches["window"] != main_l["window"]
            or any(v for k, v in launches.items() if k != "window")):
        raise AssertionError(f"--mesh 1,1 launches {launches}, the "
                             f"single-GPU main path {main_l['window']}")
    t = {st: c for st, _, c in series}
    rate = 1000 / (t[2000] - t[1000])
    out["mesh"] = launches
    phase("sharded", f"--mesh 1,1 (NCCL, a group of size 1), 2000 steps: rc "
          f"0, ppx {ppx}, window-kernel launches {launches['window']} (the "
          f"single-GPU main path: {main_l['window']}, "
          f"{launches['window'] / 2} per 1000 steps), steady state "
          f"{rate:.1f} updates/s (the single-GPU main path {main_rate:.1f} "
          f"in this run); {smi}")

    started = multihost.initialize(device="cuda")
    try:
        # one sharded window against the single-GPU kernel on the same
        # operand tuple, and against its own plain version: at the main
        # path's shape (the resident mode) and the K = 4096 path's (wide)
        for key, shape in (("window", WINDOW_SHAPES[0]),
                           ("wide_window", WIDE_MAIN_SHAPE)):
            case = testing.window_case(0, *shape)
            cfg = testing.window_case_config(case)
            state, xs = testing.window_case_torch(case, "cuda")
            batch, nbrs = xs[0], xs[1][:, 0, :]
            mcode = window._correction_codes(cfg, batch.nodes,
                                              batch.node_mask, nbrs)
            keep = window._last_write_wins(batch.nodes, batch.node_mask,
                                            cfg.window)
            ctx = ShardCtx(cfg, make_mesh(1, 1, device="cuda"), cfg.N, None)
            want = window.window_apply_cuda(cfg, _fresh(state), xs, mcode,
                                            keep)
            before = (window.window_apply_cuda.launches,
                      window.window_apply_cuda.wide_launches)
            got = sharded_window_apply(ctx, _fresh(state), xs, mcode, keep)
            wide = int(key == "wide_window")
            if (window.window_apply_cuda.launches != before[0] + 1
                    or window.window_apply_cuda.wide_launches
                    != before[1] + wide):
                raise AssertionError(f"the sharded window at {shape} did "
                                     f"not launch the window kernel once "
                                     f"in the {'wide' if wide else 'resident'}"
                                     f" mode")
            plain = sharded_window_apply(
                ctx._replace(cfg=cfg.replace(window_impl="jnp")),
                _fresh(state), xs, mcode, keep)
            err = max(max_err(a, b, f"sharded window {f}") for a, b, f in
                      zip(_outs(got), _outs(want), STATE_FIELDS))
            err_plain = max(max_err(a, b, f"sharded window vs plain {f}")
                            for a, b, f in zip(_outs(got), _outs(plain),
                                               STATE_FIELDS))
            scratch = _fresh(state)
            ms = time_ms(lambda: sharded_window_apply(ctx, scratch, xs,
                                                      mcode, keep))
            ms_single = time_ms(lambda: window.window_apply_cuda(
                cfg, scratch, xs, mcode, keep))
            out[key] = (err, ms, ms_single)
            phase("sharded", f"ShardedLearner window at (1,1), (T,B,n,E,K) "
                  f"= {shape}: row fetch + one window-kernel launch "
                  f"({'wide' if wide else 'resident'} mode) on the fetched "
                  f"table + local write-back vs the single-GPU kernel max "
                  f"abs err {err:.3e}, vs its --window-impl jnp version "
                  f"{err_plain:.3e} (normwise rtol {RTOL}); {ms:.4f} "
                  f"ms/window against {ms_single:.4f} back to back with the "
                  f"host; {smi}")

        # chains over the ranks of a chain mesh of one
        n, split, graph = bench
        args = cli.build_arg_parser().parse_args(SHARDED_CHAIN_ARGS)
        cli.resolve_fast_defaults(args)
        ccfg = cli.config_from_args(args).replace(
            device_sampling=True).finalize(n, split.total_edges,
                                           graph.max_fan_out)
        chains = ShardedChainLearner(ccfg, graph, split, SHARDED_CHAINS,
                                     make_chain_mesh(1, device="cuda"))
        p0 = chains.heldout_perplexity()
        _counts(kmods, None)
        t0 = time.perf_counter()
        evs = chains.run_with_ppx(1008, 504)
        seconds = time.perf_counter() - t0
        launches = _counts(kmods, "read")
        expected = 1008 // 6
        if (launches["window_chain"] != expected or launches["window"]
                or launches["chains"] != SHARDED_CHAINS * expected):
            raise AssertionError(f"ShardedChainLearner launches {launches}, "
                                 f"expected {expected} chain launches")
        last = evs[-1]["ppx"]
        if not (len(last) == SHARDED_CHAINS and (last < p0).all()):
            raise AssertionError(f"a chain's ppx does not fall: {p0} -> "
                                 f"{last}")
        out["chains"] = launches
        phase("sharded", f"ShardedChainLearner G = 1, C = {SHARDED_CHAINS}, "
              f"window 6, 1008 steps: chain-entry launches "
              f"{launches['window_chain']} (= {expected} windows, "
              f"{launches['chains']} chain blocks), ppx "
              f"{[round(float(x), 4) for x in p0]} -> "
              f"{[round(float(x), 4) for x in last]}, "
              f"{SHARDED_CHAINS * 1008 / seconds:.1f} "
              f"updates/s aggregate (evaluations included), init "
              f"{chains.init_seconds:.3f} s; {smi}")
        del chains
    finally:
        if started:
            dist.destroy_process_group()

    # --partitioned-ingest on the bench graph written as a SNAP file
    import numpy as np

    from mcmc_ammsb_tpu_torch import data
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bench.txt")
        _, u, v = data.synthetic_edges(317080, 7, seed=1)
        t0 = time.perf_counter()
        np.savetxt(path, np.stack([u, v], 1), fmt="%d", delimiter="\t",
                   header="bench graph, synthetic_edges(317080, 7, seed=1)")
        write_s = time.perf_counter() - t0
        _counts(kmods, None)
        series, messages = _run_cli(cli, ["--file", path] + PARTITIONED_ARGS)
        launches = _counts(kmods, "read")
    ingest = next(m for m in messages if m.startswith("partitioned ingest"))
    ppx = [p for _, p, _ in series]
    if ([st for st, _, _ in series] != [0, 500, 1000]
            or not all(p < ppx[0] for p in ppx[1:])):
        raise AssertionError(f"--partitioned-ingest: ppx series {series}")
    if launches["window"] != 2 * (500 // 12):
        raise AssertionError(f"--partitioned-ingest launches {launches}")
    out["partitioned"] = launches
    phase("sharded", f"--partitioned-ingest --mesh 1,1 on the bench graph "
          f"as a SNAP file ({write_s:.2f} s to write): {ingest}; ppx {ppx}, "
          f"window-kernel launches {launches['window']}; {smi}")
    return out


def _api_learner(cli, argv, bench, **cfg_fields):
    """The learner the CLI builds for ``argv`` on the bench graph, with
    ``cfg_fields`` replaced in its config."""
    n, split, graph = bench
    args = cli.build_arg_parser().parse_args(argv)
    cli.resolve_fast_defaults(args)
    cfg = cli.config_from_args(args).replace(**cfg_fields)
    if args.num_chains > 1:
        cfg = cfg.replace(device_sampling=True)
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    return cli.make_learner(args, cfg, graph, split, "cuda")


def check_resume(cli, checkpoint, kmods, bench, tmp, name, smi):
    """Phase 6, one of RESUME_RUNS through the API: run, save, run against
    a fresh learner, restore, run. Every field of the state bit-equal,
    the same kernel launches in both second halves. A sharded path runs
    in a process group of size 1 that it starts and ends."""
    if "--mesh" in RESUME_RUNS[name][0]:
        import torch.distributed as dist

        from mcmc_ammsb_tpu_torch.parallel import multihost

        started = multihost.initialize(device="cuda")
        try:
            return _check_resume(cli, checkpoint, kmods, bench, tmp, name,
                                 smi)
        finally:
            if started:
                dist.destroy_process_group()
    return _check_resume(cli, checkpoint, kmods, bench, tmp, name, smi)


def _check_resume(cli, checkpoint, kmods, bench, tmp, name, smi):
    import os

    argv, steps, entry, expected, *rest = RESUME_RUNS[name]
    backend = rest[0] if rest else "npz"
    path = os.path.join(tmp, "resume.npz" if backend == "npz"
                        else "resume.dir")
    a = _api_learner(cli, argv, bench)
    a.heldout_perplexity()
    a.run(steps)
    t0 = time.perf_counter()
    checkpoint.save_checkpoint(path, a, backend=backend)
    save_s = time.perf_counter() - t0
    pending = len(getattr(a, "_pending", []))
    _counts(kmods, None)
    a.run(steps)
    first = _counts(kmods, "read")
    ppx_a = a.heldout_perplexity()
    a.close()
    b = _api_learner(cli, argv, bench)
    t0 = time.perf_counter()
    checkpoint.load_checkpoint(path, b)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if b.step_count != steps + 1:
        raise AssertionError(f"{name}: restored at step {b.step_count}")
    _counts(kmods, None)
    b.run(steps)
    second = _counts(kmods, "read")
    ppx_b = b.heldout_perplexity()
    b.close()
    diffs = {}
    for f, x, y in zip(a.state._fields, a.state, b.state):
        if isinstance(x, torch.Tensor):
            if not torch.equal(x, y):
                diffs[f] = float((x.double() - y.double()).abs().max())
        elif x != y:
            diffs[f] = (x, y)
    if diffs or not (torch.as_tensor(ppx_a) == torch.as_tensor(ppx_b)).all():
        raise AssertionError(f"{name}: the resumed run differs from the "
                             f"uninterrupted one: max abs {diffs}, ppx "
                             f"{ppx_a} vs {ppx_b}")
    if first != second or first[entry] != expected:
        raise AssertionError(f"{name}: launches {first} then {second} after "
                             f"the restore, expected {expected} of {entry}")
    if backend == "npz":
        size = os.path.getsize(path)
        os.remove(path)
    else:
        import shutil

        size = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, files in os.walk(path) for f in files)
        shutil.rmtree(path)
    phase("checkpoint", f"{name}: run {steps}, save, run {steps} == restore, "
          f"run {steps}: {len(a.state._fields)} state fields bit-equal "
          f"(step {b.step_count}), ppx equal; {first[entry]} {entry} launches "
          f"in each second half; {pending} pending host chunk(s) in the "
          f"file; {size} B, save {save_s:.3f} s, load {load_s:.3f} s "
          f"({'np.savez' if backend == 'npz' else 'a DCP directory'}, host "
          f"clock, the device copies included); {smi}")


def check_cli_resume(cli, kmods, tmp):
    """Phase 6 through the CLI: --checkpoint, then --restore."""
    import os

    ck = os.path.join(tmp, "cli.npz")
    base = ["--synthetic", "317080,7", "-k", "256", "-x", "1000", "-i",
            "500", "--device", "cuda"]
    first, messages = _run_cli(cli, base + ["--checkpoint", ck])
    if f"checkpoint saved to {ck}" not in messages:
        raise AssertionError("--checkpoint: no 'checkpoint saved' line")
    _counts(kmods, None)
    second, messages = _run_cli(cli, base + ["--restore", ck])
    launches = _counts(kmods, "read")
    if f"restored checkpoint {ck} (step=1001)" not in messages:
        raise AssertionError(f"--restore: no restored line at step 1001 in "
                             f"{[m for m in messages if 'restored' in m]}")
    ppx0 = first[0][1]
    resumed = [p for _, p, _ in second]
    if not all(p < ppx0 for p in resumed) or launches["window"] != 82:
        raise AssertionError(f"--restore: ppx {resumed} against the first "
                             f"run's ppx[0] {ppx0}, launches {launches}")
    phase("checkpoint", f"CLI: --checkpoint ({os.path.getsize(ck)} B) then "
          f"--restore: rc 0, 'restored checkpoint ... (step=1001)', first "
          f"run ppx {[p for _, p, _ in first]}, resumed ppx {resumed} (all "
          f"below the first ppx[0]), {launches['window']} window launches")
    os.remove(ck)


def check_bf16_kernels(window, chains_flat, testing, smi):
    """Phase bf16, the window kernel's bf16 row mode at the main path's,
    the chain path's and the com-youtube rung's shapes, and in the wide
    mode at the K = 4096 path's (``bf16_agree``), timed against the
    float32 launches on the same operands in this call (turns: f32,
    bf16, bf16, f32). Returns {kernel: (gaps, max abs err, bf16 ms, f32
    ms, bound ms with pi's row bytes halved, what sets it)}."""
    out = {}
    for name, shape in (("window_kernel", WINDOW_SHAPES[0]),
                        ("window_kernel_chains", CHAIN_SHAPES[0]),
                        ("window_kernel_wide", WIDE_MAIN_SHAPE),
                        ("window_kernel_ladder", LADDER_SHAPE)):
        cfg, state, args, cuda, plain = window_operands(
            window, chains_flat, testing, shape)
        gaps, err = bf16_agree(testing, cfg, state, args, cuda, plain,
                               f"{name} at {shape}")
        s32 = _fresh(state)
        s16 = _fresh(state._replace(pi=state.pi.to(torch.bfloat16)))
        t = [time_ms(lambda st=st: cuda(cfg, st, *args), hold=True)
             for st in (s32, s16, s16, s32)]
        b_ms, b_by = window_bound(*args, shape[-1], cfg.N, pi_bytes=2)
        ms16, ms32 = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        out[name] = (gaps, err, ms16, ms32, b_ms, b_by)
        phase("bf16", f"{name} bf16 rows at {','.join(map(str, shape))}: "
              f"the bf16 launch is the float32 launch on the upcast rows, "
              f"rounded, bit for bit; against the plain version at bf16 "
              f"{gaps['one_ulp']} stored values 1 ulp apart, "
              f"{gaps['more_ulps']} more (max {gaps['max_ulps']} ulps, each "
              f"within its float32 gap), phi_sum/theta/beta max abs err "
              f"{err:.3e}; ms/window bf16 {t[1]:.4f} {t[2]:.4f}, float32 "
              f"{t[0]:.4f} {t[3]:.4f} ({100 * (ms16 / ms32 - 1):+.2f}%); "
              f"bound {b_ms * 1e3:.3f} us ({b_by}, pi rows at 2 B); {smi}")
    return out


@contextlib.contextmanager
def spied(module, name, record):
    """``module.name`` wrapped for the block: ``record`` sees every call's
    arguments first."""
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        record(*args, **kwargs)
        return real(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, real)


def run_bf16_phases(cli, kmods, main_ppx, main_mem, smi):
    """Phase bf16 through the CLI: the main path with --pi-dtype
    bfloat16 (2000 steps: 164 window launches, every one on bf16 rows,
    ppx falls and ends within 5% of the float32 main path's, JAX's
    test_bf16_tracks_fp32_ppx rule; the peak device memory of both
    runs), --num-chains 4 (window 6, 504 steps: 84 chain launches on bf16
    rows, every chain falls) and --mesh 1,1 (1000 steps: 82 window
    launches on the fetched float32 rows, write-backs into bf16 rows).
    Returns {run: launches}."""
    from mcmc_ammsb_tpu_torch.ops import phi as phi_ops
    from mcmc_ammsb_tpu_torch.ops import window

    out = {}
    seen = set()
    torch.cuda.reset_peak_memory_stats()
    _counts(kmods, None)
    with spied(window, "_launch",
               lambda cfg, st, *a, **k: seen.add(st.pi.dtype)):
        series, _ = _run_cli(cli, BF16_ARGS)
    mem = torch.cuda.max_memory_allocated()
    launches = _counts(kmods, "read")
    ppx = [p for _, p, _ in series]
    gap = abs(ppx[-1] - main_ppx[-1]) / main_ppx[-1]
    if ([st for st, _, _ in series] != [0, 500, 1000, 1500, 2000]
            or not all(p < ppx[0] for p in ppx[1:]) or gap >= 0.05
            or launches["window"] != 164 or seen != {torch.bfloat16}):
        raise AssertionError(f"--pi-dtype bfloat16: ppx {ppx} against "
                             f"float32 {main_ppx}, launches {launches}, "
                             f"pi dtypes {seen}")
    out["main"] = launches
    phase("bf16", f"main path --pi-dtype bfloat16, 2000 steps: rc 0, ppx "
          f"{ppx} (float32 {main_ppx}: final within {100 * gap:.3f}%), "
          f"{launches['window']} window launches, all on bf16 rows; peak "
          f"device memory {mem} B (float32 main path {main_mem} B); {smi}")

    seen.clear()
    _counts(kmods, None)
    with spied(window, "_launch",
               lambda cfg, st, *a, **k: seen.add(st.pi.dtype)):
        series, _ = _run_cli(cli, BF16_CHAIN_ARGS)
    launches = _counts(kmods, "read")
    ppx = [p for _, p, _ in series]
    if ([st for st, _, _ in series] != [0, 252, 504]
            or not all(q < q0 for q, q0 in zip(ppx[-1], ppx[0]))
            or launches["window_chain"] != 84 or launches["chains"] != 336
            or seen != {torch.bfloat16}):
        raise AssertionError(f"--num-chains 4 --pi-dtype bfloat16: ppx "
                             f"{ppx}, launches {launches}, dtypes {seen}")
    out["chains"] = launches
    phase("bf16", f"--num-chains 4 --pi-dtype bfloat16 --window 6, 504 "
          f"steps: rc 0, ppx {ppx[0]} -> {ppx[-1]}, "
          f"{launches['window_chain']} chain launches on bf16 rows")

    kernel_rows, stored = set(), set()
    _counts(kmods, None)
    with spied(window, "_launch",
               lambda cfg, st, *a, **k: kernel_rows.add(st.pi.dtype)), \
            spied(phi_ops, "scatter_rows",
                  lambda pi, *a, **k: stored.add(pi.dtype)):
        series, _ = _run_cli(cli, BF16_MESH_ARGS)
    launches = _counts(kmods, "read")
    ppx = [p for _, p, _ in series]
    if (not all(p < ppx[0] for p in ppx[1:]) or launches["window"] != 82
            or kernel_rows != {torch.float32}
            or stored != {torch.bfloat16}):
        raise AssertionError(f"--mesh 1,1 --pi-dtype bfloat16: ppx {ppx}, "
                             f"launches {launches}, kernel rows "
                             f"{kernel_rows}, stored {stored}")
    out["mesh"] = launches
    phase("bf16", f"--mesh 1,1 --pi-dtype bfloat16, 1000 steps: rc 0, ppx "
          f"{ppx}, {launches['window']} window launches on the fetched "
          f"float32 rows, write-backs into the bf16 shard; {smi}")
    return out


def check_sort(sort_mod):
    """bitonic_sort_rows on the card equals torch.sort."""
    x = torch.randn(1024, 100, device="cuda")
    if not torch.equal(sort_mod.bitonic_sort_rows(x),
                       torch.sort(x, dim=-1).values):
        raise AssertionError("bitonic_sort_rows differs from torch.sort")
    phase("sort", "ops/sort.bitonic_sort_rows of [1024, 100] on the card "
          "equals torch.sort")


def run_refckpt_phase(cli, refckpt, kmods, bench, tmp, smi):
    """Phase refckpt: --checkpoint-ref after a main-path run (the bytes
    and the export's seconds; the strict parse of the reference binary's
    checks accepts the file in the default build layout), then
    --restore-ref of that file for 1000 steps on the window kernel (10
    chunks of 100 steps: 80 launches): the first ppx after the import
    within 2% of the exporter's last."""
    import os

    path = os.path.join(tmp, "main.ref")
    seconds = {}

    def timed(module, name):
        real = getattr(module, name)

        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            seconds[name] = time.perf_counter() - t0
            return out

        return run

    real_export, real_import = refckpt.export_learner, cli._import_reference
    refckpt.export_learner = timed(refckpt, "export_learner")
    cli._import_reference = timed(cli, "_import_reference")
    try:
        first, messages = _run_cli(cli, REF_EXPORT_ARGS
                                   + ["--checkpoint-ref", path])
        if not any(m.startswith(f"reference-format checkpoint saved to "
                                f"{path} (step=1001)") for m in messages):
            raise AssertionError("--checkpoint-ref: no saved line")
        n, split, graph = bench
        args = cli.build_arg_parser().parse_args(REF_EXPORT_ARGS)
        cli.resolve_fast_defaults(args)
        cfg = cli.config_from_args(args).finalize(n, split.total_edges,
                                                  graph.max_fan_out)
        t0 = time.perf_counter()
        props = refckpt.simulate_reference_parse(
            path, refckpt.ReferenceLayout.from_config(
                cfg, len(split.heldout_edges_u)))
        parse_s = time.perf_counter() - t0
        _counts(kmods, None)
        second, messages = _run_cli(cli, REF_EXPORT_ARGS
                                    + ["--restore-ref", path])
        launches = _counts(kmods, "read")
    finally:
        refckpt.export_learner, cli._import_reference = (real_export,
                                                         real_import)
    last, resumed = first[-1][1], second[0][1]
    gap = abs(resumed - last) / last
    if (f"imported reference checkpoint {path} (step=1001)" not in messages
            or gap >= 0.02 or launches["window"] != 80
            or props["learner_props"][1][0] != 1001):
        raise AssertionError(f"--restore-ref: ppx {second} after the "
                             f"export's last {last}, launches {launches}")
    phase("refckpt", f"--checkpoint-ref after 1000 main-path steps: "
          f"{os.path.getsize(path)} B in {seconds['export_learner']:.3f} s "
          f"(host clock, the device copy included); the strict parse "
          f"accepts it in the default build layout ({parse_s:.3f} s, "
          f"samples of {props['sample0_edges']} and {props['sample1_edges']} "
          f"edges); --restore-ref: imported in "
          f"{seconds['_import_reference']:.3f} s, ppx[0] {resumed} against "
          f"the export's last {last} ({100 * gap:.4f}%), then "
          f"{[p for _, p, _ in second]}, {launches['window']} window "
          f"launches; {smi}")
    os.remove(path)


def _read_dir(path):
    """A directory checkpoint's state leaves ({leaf_i: CPU tensor}) and
    generator states, read with DCP in this process."""
    import os

    import numpy as np
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint import FileSystemReader

    state_dir = os.path.join(path, "state")
    meta = FileSystemReader(state_dir).read_metadata().state_dict_metadata
    leaves = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
              for k, m in meta.items()}
    dcp.load(leaves, checkpoint_id=state_dir, no_dist=True)
    with np.load(os.path.join(path, "streams.npz")) as z:
        streams = {k: z[k] for k in z.files}
    return leaves, streams


def check_cli_async(cli, checkpoint, bench, tmp, smi):
    """Phase checkpoint: --checkpoint-interval 500 with the directory
    backend through the CLI (1000 steps): its async saves at steps 501
    and 1001 (kept under their own paths here) return while training
    goes on; the one at 1001 holds what the synchronous save at exit of
    the same step holds, leaf for leaf and stream for stream, and a
    learner restored from the one at 501 and run 500 steps ends in the
    exit save's state, bit for bit."""
    import os
    import shutil

    import numpy as np

    ck = os.path.join(tmp, "async_ck")
    real, kept = cli.save_checkpoint, []

    def keep_async(path, learner, **kw):
        if kw.get("async_save"):
            path = f"{path}.at{learner.step_count}"
            kept.append(path)
        t0 = time.perf_counter()
        out = real(path, learner, **kw)
        kept_s.append(time.perf_counter() - t0)
        return out

    kept_s = []
    cli.save_checkpoint = keep_async
    try:
        _, messages = _run_cli(cli, ASYNC_ARGS + ["--checkpoint", ck])
    finally:
        cli.save_checkpoint = real
    if (kept != [f"{ck}.at501", f"{ck}.at1001"]
            or sum("[async]" in m for m in messages) != 2):
        raise AssertionError(f"async saves {kept}")
    a_leaves, a_streams = _read_dir(f"{ck}.at1001")
    b_leaves, b_streams = _read_dir(ck)
    if (a_leaves.keys() != b_leaves.keys()
            or not all(torch.equal(a_leaves[k], b_leaves[k])
                       for k in a_leaves)
            or a_streams.keys() != b_streams.keys()
            or not all(np.array_equal(a_streams[k], b_streams[k])
                       for k in a_streams)):
        raise AssertionError("the async save differs from the synchronous "
                             "save of the same step")
    lrn = _api_learner(cli, ASYNC_ARGS, bench)
    checkpoint.load_checkpoint(f"{ck}.at501", lrn)
    lrn.run(500)
    lrn.heldout_perplexity()
    got = checkpoint.state_leaves(lrn.state)
    lrn.close()
    diff = [i for i, leaf in enumerate(got) if f"leaf_{i}" in b_leaves
            and not np.array_equal(leaf, b_leaves[f"leaf_{i}"].numpy())]
    if diff:
        raise AssertionError(f"resumed from the step-501 async save, leaves "
                             f"{diff} differ from the exit save")
    phase("checkpoint", f"CLI --checkpoint-interval 500 --checkpoint-backend "
          f"orbax: async saves at steps 501 and 1001 returned in "
          f"{kept_s[0]:.3f} and {kept_s[1]:.3f} s (the synchronous exit save "
          f"{kept_s[2]:.3f} s, host clock); the step-1001 one equals the "
          f"exit save leaf for leaf and stream for stream ({len(a_leaves)} "
          f"leaves); restored from the step-501 one and run 500 steps, every "
          f"leaf bit-equal to the exit save; {smi}")
    for path in kept + [ck]:
        shutil.rmtree(path)


def start_ladder_data(ladder, data_dir):
    """Phase ladder's host data: ``ladder.rung_data`` of every rung in two
    worker processes (spawned, so no CUDA state is inherited), the largest
    rung first, while the earlier phases run. ``data_dir`` holds no SNAP
    file, so each rung builds its power-law surrogate. Returns (the pool,
    {rung: its pending result}); the caller terminates the pool."""
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(2)
    order = sorted(ladder.RUNGS, key=lambda r: -ladder.RUNGS[r][2][0])
    jobs = {name: pool.apply_async(ladder.rung_data, (name, data_dir))
            for name in order}
    pool.close()
    return pool, jobs


def host_gamma_ns() -> float:
    """ns per float32 Gamma(1, 1) draw of numpy on this host: the rate of
    the host init law the port drew pi with before it drew on the card."""
    import numpy as np

    draws = np.random.default_rng(0)
    draws.standard_gamma(1.0, 1 << 16, dtype=np.float32)
    t0 = time.perf_counter()
    draws.standard_gamma(1.0, HOST_GAMMA_DRAWS, dtype=np.float32)
    return (time.perf_counter() - t0) / HOST_GAMMA_DRAWS * 1e9


def run_ladder_phase(ladder, window, kernels, kmods, jobs, smi):
    """Phase 7, the config ladder at full size (LADDER_ITERS steps a rung,
    ``ladder.run_rung`` on the workers' data): N, E and max fan-out equal
    to the JAX artifact's, every ppx finite and the last below ppx[0],
    the window launches all of the rung's LADDER_WINDOWS kind (mode, pi
    dtype, K) and as many as its windows, the peak device memory minus pi
    within the K rule's working set. Returns {rung: (launches by
    "mode/dtype/K", stage seconds, updates/s, peak bytes)}."""
    root = Path(__file__).resolve().parent
    limit = kernels.smem_limit(torch.device("cuda"))
    gamma_ns = host_gamma_ns()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ladder.RUNGS:
            ref = json.loads((root / "bench_results" / f"ppx_{name}.json")
                             .read_text())
            t0 = time.perf_counter()
            data = jobs[name].get()
            waited = time.perf_counter() - t0
            seen = {}

            def record(cfg, s, xs_t, *args, **kwargs):
                batch, nbrs, ye = xs_t[0], xs_t[1], xs_t[5]
                mode = window.window_plan(
                    *batch.nodes.shape[-2:], nbrs.shape[-1], ye.shape[-1],
                    cfg.K, limit)[1]
                key = (mode, str(s.pi.dtype).removeprefix("torch."), cfg.K)
                seen[key] = seen.get(key, 0) + 1

            _counts(kmods, None)
            with spied(window, "_launch", record):
                art = ladder.run_rung(name, tmp, tmp, LADDER_ITERS,
                                      LADDER_INTERVAL, "cuda", data)
            launches = _counts(kmods, "read")
            series = [(p["iter"], p["ppx"]) for p in art["series"]]
            ppx = [p for _, p in series]
            want = LADDER_WINDOWS[name]
            n_win = 0 if want is None else (
                LADDER_ITERS // LADDER_INTERVAL) * (LADDER_INTERVAL // 12)
            expect = {k: 0 for k in launches}
            expect.update(window=n_win,
                          window_wide=n_win if want and want[0] != "resident"
                          else 0)
            over = art["peak_memory_bytes"] - art["pi_bytes"]
            rule = art["k_rule"]
            work = rule["working_bytes"]
            bad = [f"{f} {art[f]} (JAX artifact {ref[f]})"
                   for f in ("N", "E", "max_fan_out") if art[f] != ref[f]]
            if ([i for i, _ in series] != list(range(
                    0, LADDER_ITERS + 1, LADDER_INTERVAL))
                    or not all(math.isfinite(p) for p in ppx)
                    or not ppx[-1] < ppx[0]):
                bad.append(f"ppx series {series}")
            if launches != expect or set(seen) != (
                    set() if want is None else {want}):
                bad.append(f"launches {launches} (expected {expect}), by "
                           f"mode/dtype/K {seen} (expected {want})")
            if over > work:
                bad.append(f"peak {art['peak_memory_bytes']} B - pi "
                           f"{art['pi_bytes']} B = {over} B over the K "
                           f"rule's working set {work} B")
            if bad:
                raise AssertionError(f"ladder {name}: " + "; ".join(bad))
            sec = art["seconds"]
            host_s = art["N"] * art["K"] * gamma_ns * 1e-9
            out[name] = ({"/".join(map(str, k)): v for k, v in seen.items()},
                         sec, art["updates_per_s"], art["peak_memory_bytes"])
            phase("ladder", f"{name}: N={art['N']} E={art['E']} max fan-out "
                  f"{art['max_fan_out']} (the JAX artifact's), K={art['K']}"
                  f" (reference {ladder.RUNGS[name][1]}), pi "
                  f"{art['pi_dtype']}, window {art['window']}; seconds: "
                  + ", ".join(f"{k} {v:.2f}" for k, v in sec.items())
                  + f" (waited {waited:.2f} s for the workers' data); "
                  f"{art['updates_per_s']:.1f} updates/s; ppx {series}; "
                  f"peak device memory {art['peak_memory_bytes']} B, minus "
                  f"pi's {art['pi_bytes']} B: {over} B (the K rule's "
                  f"working set {work} B of {rule['device_memory_bytes']} "
                  f"B); window launches {launches['window']}, by "
                  f"mode/dtype/K {seen}; pi init {sec['init']:.2f} s on the "
                  f"card against ~{host_s:.1f} s for the host law ("
                  f"{art['N'] * art['K']} numpy draws at {gamma_ns:.2f} ns "
                  f"each on this host); {art['device']}")
    return out


def run_entry_phase(graft):
    """Phase entry: ``graft.entry()`` on the card, its step once."""
    fn, args = graft.entry()
    state = fn(*args)
    torch.cuda.synchronize()
    gap = float((state.pi.sum(-1) - 1.0).abs().max())
    if (state.step_count != 2 or not state.pi.is_cuda
            or not torch.isfinite(state.pi).all() or gap > 1e-5):
        raise AssertionError(f"entry(): step_count {state.step_count}, pi "
                             f"on {state.pi.device}, row sums off by {gap}")
    phase("entry", f"graft.entry(): one train_step on the card, pi "
          f"{tuple(state.pi.shape)} rows sum to 1 within {gap:.2e}, "
          f"step_count {state.step_count}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    # the port's package: an ImportError here (no checkout around the
    # script) ends the run before anything is printed
    from mcmc_ammsb_tpu_torch import (chains_flat, checkpoint, cli, config,
                                      data, graft, kernels, ladder, native,
                                      refckpt, rng, testing)
    from mcmc_ammsb_tpu_torch import learner as learner_mod
    from mcmc_ammsb_tpu_torch.models import mmsb
    from mcmc_ammsb_tpu_torch.ops import (device_sampling, edgeset, neighbor,
                                          phi_pallas, sort, window,
                                          window_mmsb)
    from mcmc_ammsb_tpu_torch.ops import phi as phi_ops
    from mcmc_ammsb_tpu_torch.rng import reference as ref_rng
    from mcmc_ammsb_tpu_torch.rng import refblock
    from mcmc_ammsb_tpu_torch.sampling import MiniBatchSampler

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    phase("device", f"{torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False

    ladder_dir = tempfile.TemporaryDirectory()
    pool, jobs = start_ladder_data(ladder, ladder_dir.name)
    try:
        parent = build_all(kernels, native)
        n, split, graph = _bench_graph(data)
        check_native(edgeset, graph)
        check_membership((config, edgeset, device_sampling, neighbor, rng), n,
                         split, graph, smi)
        bench = (n, split, graph)
        w = check_window_kernel(window, kernels, testing, phi_ops, smi)
        parent_t = check_resident_parent(window, chains_flat, testing,
                                         kernels, parent)
        wide_t = check_wide_parent(window, chains_flat, testing, kernels,
                                   parent)
        c_err, c_t = check_chain_kernel(window, kernels, chains_flat, testing,
                                        phi_ops, smi)
        bf16_k = check_bf16_kernels(window, chains_flat, testing, smi)
        check_sort(sort)
        phi = check_phi_kernel(phi_pallas, kernels, testing)
        m_err, m_t = check_mmsb_kernel(window, window_mmsb, kernels, testing,
                                       phi_ops, smi)
        rr = check_ref_rng_kernel(cli, refblock, ref_rng, MiniBatchSampler,
                                  bench)
        smods = (data, config, learner_mod, device_sampling, mmsb)
        with host_law_pi(learner_mod, chains_flat, rng):
            check_slices(smods, window, window_mmsb, phi_pallas,
                         chains_flat, testing)
            check_mmsb_engine_slices(smods, testing)
        kmods = (window, window_mmsb, phi_pallas, refblock)
        torch.cuda.reset_peak_memory_stats()
        main_l, main_ppx, main_rate = run_main(cli, kmods)
        main_mem = torch.cuda.max_memory_allocated()
        wide_l, _, wide_rate, wide_mem, _ = run_wide_main(
            cli, kmods, main_l, main_rate, main_mem, smi)
        shard = run_sharded_phases(cli, kmods, main_l, main_rate, testing,
                                   bench, smi)
        bf16 = run_bf16_phases(cli, kmods, main_ppx, main_mem, smi)
        mmsb_l = run_mmsb_main(cli, kmods)
        phi_l = run_phi_main(cli, kmods)
        chain_l, _, _ = run_chain_main(cli, kmods)
        run_rhat(cli)
        host_l = {name: run_host_main(cli, kmods, name, smi)
                  for name in HOST_RUNS}
        for name in NEW_RUNS:
            run_new_main(cli, kmods, name, smi)
        run_train_ppx_main(cli, kmods, smi)
        ref_l = {name: run_ref_main(cli, kmods, name, smi)
                 for name in REF_RUNS}
        run_profile_tune_main(cli, kmods, smi)
        check_ref_api(cli, native, kmods, window, bench, smi)
        with tempfile.TemporaryDirectory() as tmp:
            run_cache_main(cli, tmp, main_ppx[0])
            run_refckpt_phase(cli, refckpt, kmods, bench, tmp, smi)
            for name in RESUME_RUNS:
                check_resume(cli, checkpoint, kmods, bench, tmp, name, smi)
            check_cli_resume(cli, kmods, tmp)
            check_cli_async(cli, checkpoint, bench, tmp, smi)
        ladder_l = run_ladder_phase(ladder, window, kernels, kmods, jobs,
                                    smi)
        run_entry_phase(graft)
    finally:
        pool.terminate()
        pool.join()
        ladder_dir.cleanup()

    def times(t):
        # no single PyTorch call computes any of these functions
        return {"ms": t[0], "plain_ms": t[1], "bound_ms": t[2],
                "bound_by": t[3], "library_ms": None}

    def bf16_fields(kernel, run):
        # the kernel's bf16 row mode: its launches on the CLI's bf16 run,
        # the rows' ulp gaps to the plain version, its ms beside the
        # float32 launch's in the same call, and its bound
        gaps, err, ms16, ms32, b_ms, b_by = bf16_k[kernel]
        return {"bf16_launches": bf16[run]["window_chain" if run == "chains"
                                              else "window"],
                "bf16_one_ulp": gaps["one_ulp"],
                "bf16_more_ulps": gaps["more_ulps"],
                "bf16_max_ulps": gaps["max_ulps"], "bf16_max_abs_err": err,
                "bf16_ms": ms16, "bf16_f32_ms": ms32, "bf16_bound_ms": b_ms,
                "bf16_bound_by": b_by}

    def ref_times(name):
        # ms and bound_ms are the main path's launch (a 200-step chunk);
        # plain_ms covers the plain_steps the plain version drew of it
        err, t, plain_steps = rr[name]
        return {"max_abs_err": err, **times(t), "plain_steps": plain_steps}

    src = "mcmc_ammsb_tpu_torch/csrc/"
    print(json.dumps({"kernels": [
        # one launch per window: gather, T steps on a cluster, scatter
        {"name": "window_kernel", "route": "cuda",
         "source": src + "window_kernel.cu",
         "replaces": "mcmc_ammsb_tpu/ops/window.py:321",
         "launches": main_l["window"], "max_abs_err": w["resident"][0],
         **times(w["resident"][1]),
         # the resident mode against the build of PARENT_SRC, float32, at
         # the main path's shape, in turns (bit-equal at every shape)
         "resident_parent_ms": parent_t[WINDOW_SHAPES[0]][0],
         "resident_change_ms": parent_t[WINDOW_SHAPES[0]][1],
         # the wide mode: its launches on the -k 4096 main path (2000
         # steps), its checks at the wide shapes, its times at the K = 4096
         # path's window, the path's rate and peak memory
         "wide_launches": wide_l["window_wide"],
         "wide_max_abs_err": w["wide"][0], "wide_ms": w["wide"][1][0],
         "wide_plain_ms": w["wide"][1][1], "wide_bound_ms": w["wide"][1][2],
         "wide_bound_by": w["wide"][1][3],
         "wide_updates_per_s": wide_rate, "wide_peak_bytes": wide_mem,
         "main_updates_per_s": main_rate, "main_peak_bytes": main_mem,
         "wide_sharded_window_max_abs_err": shard["wide_window"][0],
         "wide_bf16_max_abs_err": bf16_k["window_kernel_wide"][1],
         "wide_bf16_ms": bf16_k["window_kernel_wide"][2],
         "wide_bf16_f32_ms": bf16_k["window_kernel_wide"][3],
         # the wide mode against the build of PARENT_SRC (its chunked
         # layout) in turns, at the K = 4096 path's window and at every
         # wide shape, with the layout this build took there
         "wide_parent_ms": wide_t[WIDE_MAIN_SHAPE][0],
         "wide_change_ms": wide_t[WIDE_MAIN_SHAPE][1],
         "wide_turns_ms": {",".join(map(str, sh)): v[2]
                           for sh, v in wide_t.items()},
         "wide_layouts": {",".join(map(str, sh)): v[3]
                          for sh, v in wide_t.items()},
         # the same kernel on the sharded paths (NCCL groups of size 1):
         # --mesh 1,1 (2000 steps), --partitioned-ingest (1000 steps), and
         # one sharded window (fetch, launch, write-back) against it
         "sharded_launches": shard["mesh"]["window"],
         "partitioned_launches": shard["partitioned"]["window"],
         "sharded_window_max_abs_err": shard["window"][0],
         "sharded_window_ms": shard["window"][1],
         **bf16_fields("window_kernel", "main"),
         # the config ladder (2000 steps a rung at full size): launches by
         # mode/pi dtype/K, stage seconds, updates/s, peak device memory
         "ladder": {name: {"launches": v[0], "seconds": v[1],
                           "updates_per_s": v[2], "peak_bytes": v[3]}
                    for name, v in ladder_l.items()}},
        # the wide mode's kernel (window_kernel_wide, the same entry and
        # source) on its own: the -k 4096 main path's launches, all wide
        {"name": "window_kernel_wide", "route": "cuda",
         "source": src + "window_kernel.cu",
         "replaces": "mcmc_ammsb_tpu/ops/window.py:321 (K >= 1536)",
         "launches": wide_l["window_wide"], "max_abs_err": w["wide"][0],
         **times(w["wide"][1])},
        # the same kernel and entry, one cluster per chain: the chain
        # engine's launches
        {"name": "window_kernel_chains", "route": "cuda",
         "source": src + "window_kernel.cu",
         "replaces": "mcmc_ammsb_tpu/ops/window.py:321 (n_chains > 1)",
         "launches": chain_l["window_chain"], "max_abs_err": c_err,
         **times(c_t),
         # ShardedChainLearner, G = 1, C = 4, 1008 steps
         "sharded_launches": shard["chains"]["window_chain"],
         **bf16_fields("window_kernel_chains", "chains")},
        {"name": "mmsb_window_kernel", "route": "cuda",
         "source": src + "mmsb_window_kernel.cu",
         "replaces": "mcmc_ammsb_tpu/ops/window_mmsb.py:96",
         "launches": mmsb_l["mmsb"], "max_abs_err": m_err, **times(m_t)},
        # one Hopper kernel replaces both Pallas phi kernels: the
        # step-at-a-time --phi-impl pallas path launches its pre-gathered
        # entry, the scanned paths its by-index entry
        {"name": "phi_kernel", "route": "cuda",
         "source": src + "phi_kernel.cu",
         "replaces": "mcmc_ammsb_tpu/ops/phi_pallas.py:51",
         "launches": host_l["step at a time, --phi-impl pallas"]["phi"],
         "max_abs_err": phi["pre-gathered"][0],
         **times(phi["pre-gathered"][1:])},
        {"name": "phi_gather", "route": "cuda",
         "source": src + "phi_kernel.cu",
         "replaces": "mcmc_ammsb_tpu/ops/phi_pallas.py:84",
         "launches": phi_l["phi_gather"],
         "max_abs_err": phi["by-index"][0], **times(phi["by-index"][1:])},
        # the reference RNG: one thread per stream, a chunk per launch;
        # launches are the --rng reference run's (400 steps, chunks of 200:
        # the phi and theta noise and the neighbors of each chunk, the
        # theta and pi init)
        {"name": "ref_rng_randn_lanes", "route": "cuda",
         "source": src + "ref_rng_kernel.cu",
         "replaces": "mcmc_ammsb_tpu/rng/refblock.py:144,291 (no "
                     "pallas_call)",
         "launches": ref_l["--rng reference"]["randn"],
         **ref_times("randn_lanes")},
        {"name": "ref_rng_neighbors_lanes", "route": "cuda",
         "source": src + "ref_rng_kernel.cu",
         "replaces": "mcmc_ammsb_tpu/rng/refblock.py:144,291 (no "
                     "pallas_call)",
         "launches": ref_l["--rng reference"]["neighbors"],
         **ref_times("neighbors_lanes")},
        {"name": "ref_rng_gamma_lanes", "route": "cuda",
         "source": src + "ref_rng_kernel.cu",
         "replaces": "mcmc_ammsb_tpu/rng/refblock.py:144,291 (no "
                     "pallas_call; the init's rand_gamma, "
                     "mcmc_ammsb_tpu/learner.py:129)",
         "launches": ref_l["--rng reference"]["gamma"],
         **ref_times("gamma_lanes")},
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
