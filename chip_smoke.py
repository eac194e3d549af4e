"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is not 0:
  1. device  — a CUDA device is required; prints the card's name and
               power limit as nvidia-smi reports them;
  2. build   — compiles the four kernels from csrc/ with nvcc, one
               process per source, the window kernel's source from before
               its wide mode's node-resident layout
               (PARENT_SRC), the reference RNG kernel's from before its
               split (PARENT_RNG_SRC) and the native
               host library (the port's mcmc_ammsb_tpu_torch/csrc/
               sampler.cpp) with g++, all started together;
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
               layout (a step's rows in shared memory, two sets, bulk
               copies), at (8, 33, 32, 32, 6144), (6, 33, 32, 32, 8192)
               and the -k 8192 path's (12, 33, 32, 32, 8192) in its step
               layout with one set of rows, at (3, 33, 32, 32, 16384),
               the -k 16384 path's (12, 33, 32, 32, 16384) and (12, 33,
               32, 32, 12288) in its grid layout (one chain's columns
               over the clusters the card holds at once, a step's rows
               in shared memory, the sums exchanged across clusters
               through L2; each of these six also on five more draws
               against float64: the kernel within 2x the plain version
               on most draws, per field; the ragged (12, 33, 32, 32,
               10242), 4-byte copies, the benchmark cells' chunk tail
               (4, 33, 32, 32, 16384), one short window, and (12, 33,
               32, 32, 10240) on those five draws only: see
               RAGGED_GRID_SHAPE, TAIL_SHAPE and GRID_SHAPES);
               the grid layout at GRID_SHAPES also run twice (the same
               bits), timed in turns against the node-resident layout
               (node rows in shared memory, neighbor rows streamed in
               tiles; the plan forced, each against the plain version),
               its bf16 launch the float32 one rounded; and at
               (23, 33, 32, 32, 16384) in its chunked layout, with its
               mode, layout,
               cluster size, chunk width, shared memory per CTA (equal to
               the rule's) and us per step; its chain mode (one
               cluster per chain) at (C, T, B, n, E, K) = (16, 6, 33, 32,
               32, 256), the bench chain shape, (3, 4, 9, 8, 8, 16), (2,
               3, 6, 7, 5, 12) and, wide, (2, 12, 33, 32, 32, 2048), (2,
               12, 33, 32, 32, 8192) and (2, 12, 33, 32, 32, 16384), also
               bit-equal to C single-chain launches in the chain
               launch's layout — both no farther
               from float64 than 2x the plain version; the resident mode,
               both step layouts and the chunked layout bit-equal to the
               build of PARENT_SRC at every shape above they run, float32
               and bf16 pi, with both timed in turns
               at the main and the chain shapes, and the wide mode timed
               in turns against PARENT_SRC's (at the plan of its own
               rule: its chunked layout where this build takes the
               grid or the node-resident layout) at the ten wide shapes
               and the three
               wide chain shapes, with the layout each took; both
               phi entries
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
               reference RNG's three entries (csrc/ref_rng_kernel.cu:
               each stream split across a warp or a block by exact
               jump-ahead, a chunk per launch) against the plain
               version on the same CUDA seeds, values and seeds bit for
               bit, at the main path's launch shapes: randn_lanes over a
               200-step chunk of a real host mask of 64 lanes, K=256 (one
               launch; the plain version takes ~1 s per step, so it
               draws the last 10 steps from the seeds a 190-step launch
               leaves, and the 200-step launch's first 190 equal that
               launch's) and at (200, 256, 2), neighbors_lanes at (200,
               64, 32) with N = 317,080, gamma_lanes over 317,080 x 32
               lanes and 8 column blocks (the pi init) and with a = 0.5
               and 0.3 (the boost pre-pass) on 1280 lanes; the stress
               cases neighbors_lanes at N = 40 (50 steps), randn_lanes
               on one long stream (2000, 1, 256) and with whole lanes
               off (the phi and the theta noise's shapes), the plain
               version drawing the long launches' last 3 steps; the
               main entries and the long stream also bit-equal to
               PARENT_RNG_SRC's build and timed against it in turns,
               with the kernel's device time and the plain version's;
     bf16    — the window kernel's bf16 row mode (bfloat16 pi storage) at
               the main path's, the chain path's and the com-youtube
               rung's shapes and in the wide mode at the -k 4096 path's
               (its step layout), the -k 8192 path's (its step layout
               with one set of rows) and the -k 16384 path's (its grid
               layout, and its node-resident layout with the plan
               forced): the bf16 launch equals the float32
               launch on the upcast rows, rounded to nearest-even, bit
               for bit; against the plain
               version at bf16 the stored values are equal or 1 ulp
               apart, farther only within their float32 gap
               (testing.bf16_gaps), the counts printed; its ms against
               the float32 launch's in the same call and its bound with
               pi's row bytes halved;
     sort    — ops/sort.bitonic_sort_rows on the card equals torch.sort;
     ppx     — the held-out evaluation's kernel (csrc/ppx_kernel.cu)
               against its plain version (blocked_likelihood then
               fold_likelihood) at the benchmark cells' shapes
               (PPX_SHAPES): two successive evaluations, each pair's
               running average within rtol 2e-5 and neg_avg_log within
               1e-6 relative, the counts exact; two launches bit-equal;
               the launch counter one per evaluation; the kernel's and
               the plain version's ms and the bound of the cell's
               evaluation bytes (2 H K stored values, the ids and the
               averages) over 3.35 TB/s;
  4. slice   — hoisted loops on the GPU against the same loops on the
               CPU from one state and one operand tuple, N=300 (the
               states' pi drawn by the numpy host law, host_law_pi): the
               a-MMSB windows (4 of 5 steps and the 3 tail steps as one
               short window: 5 launches) on SLICE_DRAWS = 5 draws of the
               port's CPU learner, kernel and plain version each against
               float64
               (the kernel within 2x the plain version on most draws,
               per field; check_f64_slice), the
               MMSB windows (the measured envelope of
               tests/test_window_mmsb.py), --phi-impl pallas with
               private draws (normwise rtol 1e-5, atol 1e-8), the flat
               chain engine with C=3 (4 fused chain launches, held as
               the a-MMSB windows), 23 host-sampled steps from the
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
               fused window kernel launches once per window and once
               per chunk's tail steps (one short window; with bf16 pi the
               tail keeps the step body), ppx falls
               below ppx[0]; the same at -k 4096 (pi 5.2 GB): window 12
               unclamped, as many launches as at K=256, every one in the
               wide mode's step layout, ppx falls, its updates/s and peak
               memory; the same at -k 8192 (pi 10.4 GB) and at -k 8192
               --pi-dtype bfloat16, every launch in the step layout with
               one set of rows, and at -k 16384 (pi 20.8 GB) and -k 16384
               --pi-dtype bfloat16, every launch in the grid layout;
     sharded — the multi-GPU paths on the one card, through NCCL process
               groups of size 1 and the sharded code (row fetch over the
               model ranks, write-back, collectives): the CLI at --mesh
               1,1 on the main path (2000 steps; a launch per whole
               window, 164, its tail steps run one at a time by the
               sharded engine; its steady-state updates/s
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
               (84 window launches; a finite train_ppx line after every
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
               steps, 164 window launches on bf16 rows (bf16 tails keep
               the step body), ppx falls and ends
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
               for 1000 steps (90 window launches): the first ppx after the
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
     carry   — runs carried in from the JAX package and across device
               kinds, through the CLI: the two committed JAX-written
               checkpoints (tests/fixtures/jax_ckpt/, the JAX CLI's
               Learner at N=1,000, K=16 after 10 steps with a host chunk
               in flight) restored on the card with their own arguments
               and continued 10 steps: restored at step 11, ppx[0] within
               rtol 1e-5 of JAX's (the sidecar's), the first minibatch
               bit-equal to the sidecar's; the --rng reference one (the
               reference RNG's kernel: 2 randn_lanes and 1
               neighbors_lanes launches) also ppx[10] within rtol 1e-5
               and the digest of pi, theta and phi_sum (sum, 2-norm,
               largest magnitude) within what the normwise contract
               (rtol 5e-5, atol 1e-8) implies, nothing re-seeded; the
               host-sampled one re-seeds its torch streams once; then
               the main path (K=256) 1000 steps on the card (84 window
               launches) and saved, restored on the CPU for 24 steps
               (the plain window) and saved, restored on the card for one
               window (1 launch): at each restore every state leaf
               bit-equal to the file's and the streams re-seeded with
               the log line, every later ppx finite and below the card
               run's ppx[0];
     entry   — graft.entry()'s step once on the card: step_count 2, pi
               finite with rows summing to 1 within 1e-5;
     bench   — mcmc_ammsb_tpu_torch.bench.main on the card at the bench's
               widths (its graphs at full size, K = 256, m = n = 32, T =
               12), its run lengths and trials cut (BENCH_CUT): one JSON
               line (kept off this script's output) with every key
               non-null but vs_baseline, every rate positive, the graphs'
               N, E and max fan-out the JAX bench's, the SBM perplexity
               falling, the measured copy rate within 3.35 TB/s and the
               device nvidia-smi's; each bench phase's kernel launches
               counted: exact in the headline, sharded, chains and
               bit-exact-rng phases, none where a phase runs window 0,
               some in stratified-coin, power-law and autotune
               (bench_launches in the kernels line);
then a JSON line of the kernels, the card's name and power limit, and
the result line last. Each phase line ends with the seconds since the
script began.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
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
           "ref_rng_kernel", "ppx_kernel")
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
# the carry phase: the committed JAX-written checkpoints (made by
# tests/jax_fixtures.py) continued on the card, with the next ppx held
# against the sidecar's at the rtol of the CPU tests; then the main path
# carried across device kinds: CARRY_STEPS on the card, a save, a restore
# on the CPU for CARRY_CPU_STEPS (two windows), a CPU save restored on
# the card for one window
FIXTURE_DIR = Path(__file__).resolve().parent / "tests" / "fixtures" / \
    "jax_ckpt"
CARRY_RTOL, CARRY_PPX_RTOL = 5e-5, 1e-5
CARRY_ARGS = ["--synthetic", "317080,7", "-k", "256"]
CARRY_STEPS, CARRY_CPU_STEPS, CARRY_BACK_STEPS = 1000, 24, 12
# the draws of the window kernel's GPU-vs-CPU slices (check_f64_slice)
SLICE_DRAWS = 5
# phase bench: the port's bench at its widths (N = 317,080, K = 256, m = n =
# 32, T = 12), its run lengths and trials cut (bench.Sizes' other fields
# are the JAX bench's)
BENCH_CUT = dict(iters=2000, trials=2, bitexact_iters=200, chain_iters=504,
                 series_iters=4000, probe_steps=1000, sbm_steps=2000)
BENCH_RATES = ("reference_semantics_rate", "bit_exact_rng_rate",
               "device_bflink_rate", "stratified_coin_rate",
               "chains_aggregate_rate", "sharded_1x1_rate",
               "powerlaw_updates_per_sec", "powerlaw_capped_updates_per_sec",
               "powerlaw_capped_eval_inclusive_updates_per_sec")
# steps at the end of the phi-noise chunk the plain version draws in the
# kernel phase, and at the end of the reference RNG's stress launches
REF_PLAIN_STEPS, REF_STRESS_STEPS = 10, 3
# the reference RNG kernel's source from before its streams were split
# (one thread per stream): its build is held bit-equal to this one and
# timed against it
PARENT_RNG_SRC = "scripts/ref_rng_kernel_per_lane.cu"
REF_API_ARGS = ["--rng", "reference", "--synthetic", "317080,7", "-k", "256",
                "--steps-per-call", "10"]
AUTO_ARGS = ["--synthetic", "317080,7", "-k", "256", "--steps-per-call",
             "1008"]
# the main path at K = 4096, every window in the kernel's wide mode
WIDE_ARGS = ["--synthetic", "317080,7", "-k", "4096", "-x", "2000", "-i",
             "500", "--device", "cuda"]
# the main path at K = 8192 (pi 10.4 GB), every window in the wide mode's
# step layout with one set of rows, in float32 and with bf16 pi (the JAX
# package's own K = 8192 configuration)
STEP1_ARGS = ["--synthetic", "317080,7", "-k", "8192", "-x", "2000", "-i",
              "500", "--device", "cuda"]
# the main path at K = 16384 (pi 20.8 GB), every window in the wide mode's
# grid layout, in float32 and with bf16 pi
NODES_ARGS = ["--synthetic", "317080,7", "-k", "16384", "-x", "2000", "-i",
              "500", "--device", "cuda"]
# (T, B, n, E, K) of the fused window kernel's checks; the first is the
# main path's; the first four run its resident mode, the next four its
# wide mode: the K = 4096 path's, the ragged K = 2050 (4-byte copies), and
# the JAX package's longest windows at K = 8192 and 16384; then, in the
# resident mode, the com-youtube rung's window (K = 1024); then in the
# wide mode the JAX package's longest window at K = 6144, the -k 8192
# path's (T = 12), the -k 16384 path's, T = 12 at K = 12288, and the
# shortest window at K = 16384 that the node-resident layout does not
# hold (the chunked layout)
WINDOW_SHAPES = [(12, 33, 32, 32, 256), (3, 6, 7, 5, 12),
                 (12, 33, 32, 32, 100), (48, 33, 32, 32, 256),
                 (12, 33, 32, 32, 4096), (12, 33, 32, 32, 2050),
                 (6, 33, 32, 32, 8192), (3, 33, 32, 32, 16384),
                 (12, 33, 32, 32, 1024), (8, 33, 32, 32, 6144),
                 (12, 33, 32, 32, 8192), (12, 33, 32, 32, 16384),
                 (12, 33, 32, 32, 12288), (23, 33, 32, 32, 16384)]
WIDE_MAIN_SHAPE = WINDOW_SHAPES[4]
LADDER_SHAPE = WINDOW_SHAPES[8]
STEP1_MAIN_SHAPE = WINDOW_SHAPES[10]
NODES_MAIN_SHAPE = WINDOW_SHAPES[11]
# the grid layout's ragged slices (K not a multiple of 4: 4-byte copies),
# held on five draws against float64 only (check_window_f64_draws): on
# the draw its place in WINDOW_SHAPES would give it (seed 13) the plain
# version's beta is 1.39e-5 from float64 and the node-resident layout's
# 1.22e-6 (the chunked layout's 1.25e-6), so kernel and plain are 1.48e-5
# apart, past the normwise bound (NVIDIA H100)
RAGGED_GRID_SHAPE = (12, 33, 32, 32, 10242)
# the benchmark cells' chunk tail (1000 % 12 = 100 % 12 = 4 steps at
# K = 16384), which windowed_scan runs as one short window in the grid
# layout: held on five draws against float64
TAIL_SHAPE = (4, 33, 32, 32, 16384)
# the grid layout's shapes run twice and timed in turns against the
# node-resident layout (the plan forced): the -k 16384 path's window and
# tail, the shortest window, T = 12 at K = 12288 and 10240
GRID_SHAPES = [NODES_MAIN_SHAPE, TAIL_SHAPE, (3, 33, 32, 32, 16384),
               (12, 33, 32, 32, 12288), (12, 33, 32, 32, 10240)]
# the shape of each layout whose times the kernels line carries: the main
# path's, the -k 4096 path's, the -k 8192 path's, the -k 16384 path's (the
# grid layout, and the node-resident layout with the plan forced) and the
# shortest window the node-resident layout does not hold at K = 16384
LAYOUT_SHAPES = {"resident": WINDOW_SHAPES[0], "step": WIDE_MAIN_SHAPE,
                 "step1": STEP1_MAIN_SHAPE, "grid": NODES_MAIN_SHAPE,
                 "nodes": NODES_MAIN_SHAPE, "wide": WINDOW_SHAPES[13]}
# the phase lines' names of the plan's layouts
LAYOUT_TEXT = {"resident": "resident mode", "step": "wide mode, step layout",
               "step1": "wide mode, step layout with one set of rows",
               "nodes": "wide mode, node-resident layout",
               "grid": "wide mode, grid layout",
               "wide": "wide mode, chunked layout"}
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
# the last three run the wide mode (its step layout, its step layout with
# one set of rows and its node-resident layout)
CHAIN_SHAPES = [(CHAINS, 6, 33, 32, 32, 256), (3, 4, 9, 8, 8, 16),
                (2, 3, 6, 7, 5, 12), (2, 12, 33, 32, 32, 2048),
                (2, 12, 33, 32, 32, 8192), (2, 12, 33, 32, 32, 16384)]
# the window kernel's source from before the wide mode's node-resident
# layout: the bits of the resident mode, both step layouts and the
# chunked layout are held against its build, and the wide mode's times
# against it (its chunked layout where this build takes the new one)
PARENT_SRC = "scripts/window_kernel_pr17.cu"
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
# (H, K, pi dtype, cell) of the held-out evaluation in the benchmark's
# cells, and the rows of pi the phase draws the pairs from (many more than
# the 2 H rows read, so the reads come from HBM, not L2)
PPX_SHAPES = [(10226, 16384, torch.float32, "dblp-k16384"),
              (29610, 16384, torch.bfloat16, "youtube-k16384-bf16"),
              (29610, 1024, torch.float32, "youtube-k1024")]
PPX_PI_BYTES = 8 << 30
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


def build_parent(kernels, src: Path = None,
                 name: str = "window_kernel_parent") -> Path:
    """A build of PARENT_SRC (the window kernel from before the wide
    mode's node-resident layout), or of another source, beside the
    kernels' builds."""
    src = src or Path(__file__).resolve().parent / PARENT_SRC
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = kernels.BUILD_DIR / f"lib{name}.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True)
    return out


#: The layouts of PARENT_SRC's wide mode, in the order its plan tries
#: them, with their codes (its C interface is this build's; it has no
#: node-resident layout).
PARENT_LAYOUTS = (("step", 1), ("step1", 2), ("wide", 3))


class ParentWindowLib:
    """A build of PARENT_SRC (a path, or one already loaded) behind this
    build's C interface. A resident launch goes to it unchanged; a wide
    launch at the plan the parent's own rule gives the shape: the first
    cluster size of window._WIDE_CLUSTERS whose slices tile K, with its
    step layout (a chunk of window.step_chunk), else its step layout with
    one set of rows (the same chunk), where that fits the card by the
    parent's own window_kernel_smem_bytes, else the widest chunk of
    WIDE_CHUNKS narrower than the slice that fits. So the resident mode,
    both step layouts and the chunked layout run as in this build, and
    the shapes this build takes in its node-resident or grid layout in
    the parent's chunked layout."""

    #: positions of T..K, the cluster size, the chunk width and the layout
    #: among the arguments of this build's window_kernel_launch
    SHAPE, S, WC, MODE = slice(21, 26), 27, 28, 29

    def __init__(self, lib, window, limit: int):
        if isinstance(lib, (str, Path)):
            lib = ctypes.CDLL(str(lib))
        self.lib = window.bind_window_lib(lib)
        self.window, self.limit = window, limit

    def plan(self, t_win, b_cap, n_smpl, e_cap, k):
        """The parent's (S, wc, layout name) of a wide shape."""
        w = self.window
        for s in w._WIDE_CLUSTERS:
            if not w._tiles(k, s):
                continue
            kw = w.window_slice_width(k, s)
            tries = [(w.step_chunk(k, s), name, code)
                     for name, code in PARENT_LAYOUTS[:2]]
            tries += [(c, *PARENT_LAYOUTS[2]) for c in w.WIDE_CHUNKS
                      if c < kw]
            for wc, name, code in tries:
                if self.lib.window_kernel_smem_bytes(
                        t_win, b_cap, n_smpl, e_cap, k, s, wc,
                        code) <= self.limit:
                    return s, wc, name
        raise ValueError(f"no layout of {PARENT_SRC} fits "
                         f"{(t_win, b_cap, n_smpl, e_cap, k)}")

    def window_kernel_launch(self, *args):
        args = list(args)
        if args[self.MODE] != 0:
            args[self.S], args[self.WC], name = self.plan(*args[self.SHAPE])
            args[self.MODE] = dict(PARENT_LAYOUTS)[name]
        return self.lib.window_kernel_launch(*args)


def build_all(kernels, native):
    """Phase 2: one nvcc per source, one each for PARENT_SRC and
    PARENT_RNG_SRC and one g++ for the native host library, all started
    together. Returns the parents' builds (window kernel, reference
    RNG)."""
    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent
    with ThreadPoolExecutor(len(SOURCES) + 3) as pool:
        host_lib = pool.submit(native.build)
        parent = pool.submit(build_parent, kernels)
        parent_rng = pool.submit(build_parent, kernels,
                                 root / PARENT_RNG_SRC, "ref_rng_parent")
        libs = dict(zip(SOURCES, pool.map(kernels.build, SOURCES)))
        host_lib = host_lib.result()
        parent, parent_rng = parent.result(), parent_rng.result()
    for name, lib in libs.items():
        ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text()
                 .splitlines() if "registers" in ln or "spill" in ln]
        phase("build", f"{name}: {'; '.join(ptxas)}")
    if not native.available():
        raise AssertionError(f"native host library: {native.build_error}")
    phase("build", f"{len(SOURCES)} CUDA sources, {PARENT_SRC}, "
          f"{PARENT_RNG_SRC} and {host_lib.name} (g++) built in "
          f"{time.perf_counter() - t0:.2f} s")
    return parent, parent_rng


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


def _plan_line(window, lib, shape, limit, chained=False):
    """(the plan (S, mode, wc) a launch of a per-chain shape takes on the
    card (``launch_plan``; ``chained``: the chain entry's), shared bytes
    per CTA, and its words for a phase line); the card build of the
    kernel's layouts must give the host build's byte count, which the
    plan read."""
    plan = window.launch_plan(shape, torch.device("cuda"), chained)
    s_cl, mode, wc = plan
    smem = window.window_layout_bytes(shape, plan)
    got = lib.window_kernel_smem_bytes(*shape, s_cl, wc,
                                       window.LAYOUTS[mode])
    if got != smem:
        raise AssertionError(f"shared memory of {shape} in the {mode} "
                             f"mode: card build {got} B, host build "
                             f"{smem} B")
    if (mode != "resident") != (shape[4] >= 1536):
        raise AssertionError(f"{shape}: the {mode} mode, expected the "
                             f"{'wide' if shape[4] >= 1536 else 'resident'}")
    if smem > limit:
        raise AssertionError(f"{shape}: {smem} B of shared memory per CTA, "
                             f"the card allows {limit} B")
    text = (LAYOUT_TEXT[mode] + f", cluster of {s_cl} CTAs"
            + (f", chunks of {wc} columns" if mode == "wide" else "")
            + (f", {-(-shape[4] // wc) // s_cl} clusters of {wc}-column "
               f"slices" if mode == "grid" else "")
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
    """Phase kernel: the resident mode and the wide mode's step layout,
    step layout with one set of rows and chunked layout of this build
    against the build of PARENT_SRC at every shape of WINDOW_SHAPES and
    CHAIN_SHAPES the plan runs in them (the parent at the same plan),
    with float32 and with bfloat16 pi: the same bits in every output;
    then the float32 launches at the main path's and the chain path's
    shapes timed in turns (parent, change, change, parent). Returns
    {shape: (parent ms, change ms, the four turns)}."""
    limit = kernels.smem_limit(torch.device("cuda"))
    old = ParentWindowLib(parent, window, limit)
    real = window._window_lib
    new = real()
    dev = torch.device("cuda")
    shapes = [sh for sh in WINDOW_SHAPES + CHAIN_SHAPES
              if window.launch_plan(sh[-5:], dev, len(sh) == 6)[1]
              not in ("nodes", "grid")]
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
                    layout = window.launch_plan(shape[-5:], dev,
                                                len(shape) == 6)[1]
                    raise AssertionError(f"{shape} {dtype}: the {layout} "
                                         f"layout differs from {PARENT_SRC}")
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
    phase("kernel", f"resident mode, step layouts and chunked layout "
          f"bit-equal to {PARENT_SRC} at {len(shapes)} shapes, float32 and "
          f"bf16 pi; "
          f"ms/window in turns "
          f"(parent, change, change, parent): "
          + "; ".join(f"{sh}: {' '.join(f'{x:.4f}' for x in v[2])}"
                      for sh, v in out.items()))
    return out


def check_wide_parent(window, chains_flat, testing, kernels, parent,
                      reps=50):
    """Phase kernel: the wide mode of this build against the build of
    PARENT_SRC (at the plan of its own rule: either step layout where one
    fits, else its chunked one) at every shape of WINDOW_SHAPES and
    CHAIN_SHAPES the plan runs in the wide mode, timed in turns (parent,
    change, change, parent) on the same operands, device time only.
    Returns {shape: (parent ms, change ms, the four turns, this build's
    layout, the parent's (S, wc, layout), max abs difference of the two
    builds' outputs)}."""
    limit = kernels.smem_limit(torch.device("cuda"))
    old = ParentWindowLib(parent, window, limit)
    real = window._window_lib
    new = real()
    dev = torch.device("cuda")
    shapes = [sh for sh in WINDOW_SHAPES + CHAIN_SHAPES
              if window.launch_plan(sh[-5:], dev, len(sh) == 6)[1]
              != "resident"]
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
            s_cl, mode, wc = window.launch_plan(shape[-5:], dev,
                                                len(shape) == 6)
            out[shape] = ((t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t,
                          f"{mode} S={s_cl} wc={wc}",
                          old.plan(*shape[-5:]), diff)
    finally:
        window._window_lib = real
    phase("kernel", "wide mode against " + PARENT_SRC + ", ms/window in "
          "turns (parent, change, change, parent): " + "; ".join(
              f"{sh}: this build {v[3]}, parent {v[4][2]} S={v[4][0]} "
              f"wc={v[4][1]}: {' '.join(f'{x:.4f}' for x in v[2])} "
              f"(change/parent {v[1] / v[0]:.3f}; builds differ by max "
              f"abs {v[5]:.3e})" for sh, v in out.items()))
    return out


def check_window_f64_draws(window, phi_ops, testing, shape):
    """Phase 3, a layout's five-draw float64 check: SLICE_DRAWS windows of
    ``shape`` (seeds 100, 101, ...), each through the kernel and the
    plain version on their own copies of the state and against a float64
    evaluation (``_window_f64``): per field the kernel no farther from
    float64 than 2x the plain version on most draws, check_f64_slice's
    rule. The normwise difference of kernel and plain is printed per
    draw and not held here (check_window_kernel holds it on the shape's
    own draw): on some draws two float32 evaluations of a window drift
    past it, each as far from float64 (beta at (8, ..., 6144) and (12,
    ..., 8192): the chunked layout and the step layout with one set of
    rows both 1.0-1.8e-5 from the plain version on the same draws, NVIDIA
    H100)."""
    rows, within2 = [], {f: 0 for f in STATE_FIELDS}
    for draw in range(SLICE_DRAWS):
        case = testing.window_case(100 + draw, *shape)
        cfg = testing.window_case_config(case)
        state, xs = testing.window_case_torch(case, "cuda")
        batch, nbrs = xs[0], xs[1][:, 0, :]
        mcode = window._correction_codes(cfg, batch.nodes, batch.node_mask,
                                          nbrs)
        keep = window._last_write_wins(batch.nodes, batch.node_mask,
                                        shape[0])
        got = window.window_apply_cuda(cfg, _fresh(state), xs, mcode, keep)
        torch.cuda.synchronize()
        want = window.window_apply_torch(cfg, _fresh(state), xs, mcode, keep)
        gap = max(_rel_dist(a, b) for a, b in zip(_outs(got), _outs(want)))
        exact = _window_f64(window, phi_ops, cfg, _fresh(state), xs, mcode,
                            keep, False)
        d = {f: (_rel_dist(a, r), _rel_dist(b, r)) for a, b, r, f in
             zip(_outs(got), _outs(want), exact, STATE_FIELDS)}
        for f, (k, p) in d.items():
            within2[f] += k <= 2 * p
        rows.append(f"draw {draw}: " + ", ".join(
            f"{f} {k:.3e}/{p:.3e}" for f, (k, p) in d.items())
            + f", kernel vs plain {gap:.3e}")
    phase("kernel", f"window at {shape}, {SLICE_DRAWS} draws, normwise "
          f"distance to float64 kernel/plain: {'; '.join(rows)}; draws with "
          f"the kernel within 2x the plain version: {within2}")
    short = {f: n for f, n in within2.items() if 2 * n <= SLICE_DRAWS}
    if short:
        raise AssertionError(f"window at {shape}: the kernel within 2x the "
                             f"plain version's distance to float64 on only "
                             f"{short} of {SLICE_DRAWS} draws")


def check_window_kernel(window, kernels, testing, phi_ops, smi):
    """Phase 3, the fused a-MMSB window: {layout: (max abs err over the
    layout's shapes held normwise, None where it has none (the chunked
    layout runs only windows longer than 12 on an H100), and the kernel
    ms, plain ms, bound ms and what sets it at the layout's shape of
    LAYOUT_SHAPES)}. Each shape of the step layout with one set of rows
    and of the node-resident layout also takes the five-draw float64
    check (check_window_f64_draws), and so do RAGGED_GRID_SHAPE,
    TAIL_SHAPE and T = 12 at K = 10240; then the grid layout against the
    node-resident layout at
    GRID_SHAPES (check_grid_against_nodes), which gives the node-resident
    layout's entry."""
    lib = window._window_lib()
    limit = kernels.smem_limit(torch.device("cuda"))
    worst, main = {mode: None for mode in LAYOUT_SHAPES}, {}
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
        normwise = t_win <= 12
        _, err, f64 = _agree(window, phi_ops, cfg, state, xs, mcode, keep,
                             False, f"window at {shape}", normwise)
        if normwise:
            worst[mode] = max(worst[mode] or 0.0, err)
        scratch, plain_scratch = _fresh(state), _fresh(state)
        ms = time_ms(lambda: window.window_apply_cuda(cfg, scratch, xs,
                                                      mcode, keep),
                     hold=True)
        ms_b2b = time_ms(lambda: window.window_apply_cuda(cfg, scratch, xs,
                                                          mcode, keep))
        plain_ms = time_ms(lambda: window.window_apply_torch(
            cfg, plain_scratch, xs, mcode, keep), reps=10)
        b_ms, b_by = window_bound(xs, mcode, keep, shape[4], cfg.N)
        if shape == LAYOUT_SHAPES[mode]:
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
        if mode in ("step1", "nodes", "grid"):
            check_window_f64_draws(window, phi_ops, testing, shape)
    (_, mode, _), _, plan_text = _plan_line(window, lib, RAGGED_GRID_SHAPE,
                                            limit)
    if mode != "grid":
        raise AssertionError(f"{RAGGED_GRID_SHAPE}: the {mode} layout, "
                             f"expected the grid layout")
    phase("kernel", f"window T,B,n,E,K="
          f"{','.join(map(str, RAGGED_GRID_SHAPE))}: {plan_text}")
    for shape in (RAGGED_GRID_SHAPE, TAIL_SHAPE, GRID_SHAPES[4]):
        check_window_f64_draws(window, phi_ops, testing, shape)
    worst["nodes"], main["nodes"] = check_grid_against_nodes(
        window, kernels, testing, phi_ops, smi)
    return {mode: (worst[mode], main[mode]) for mode in worst}


@contextlib.contextmanager
def forced_plan(window, plan):
    """Every launch in the block takes ``plan`` (S, mode, wc), whatever
    the rule gives its shape."""
    real = window.window_plan
    window.window_plan = lambda *a, **kw: plan
    try:
        yield
    finally:
        window.window_plan = real


def check_grid_against_nodes(window, kernels, testing, phi_ops, smi,
                             reps=30):
    """Phase 3, the grid layout at every shape of GRID_SHAPES: the plan
    takes it; two launches give the same bits; its bf16 launch is its
    float32 launch on the upcast rows, rounded; it and the node-resident
    layout (the plan forced to (16, "nodes", NODES_TILE)) each against the
    plain version, timed in turns (grid, nodes, nodes, grid). A shape of
    WINDOW_SHAPES takes the draw check_window_kernel gives it, and both
    layouts are held there as that check holds the grid (``_agree``:
    normwise, and no farther from float64 than 2x the plain version);
    elsewhere (the tail, K = 10240: their five-draw float64 checks hold
    the grid) the differences are printed, not held: on some draws two
    float32 evaluations drift apart past the normwise bound. Returns the
    node-resident layout's (max abs err, and its ms, the plain ms, bound
    ms and what sets it at NODES_MAIN_SHAPE)."""
    dev = torch.device("cuda")
    nodes = (16, "nodes", window.NODES_TILE)
    worst, main, lines = 0.0, None, []
    for i, shape in enumerate(GRID_SHAPES):
        held = shape in WINDOW_SHAPES
        seed = WINDOW_SHAPES.index(shape) if held else 20 + i
        plan = window.launch_plan(shape, dev, False)
        if plan[1] != "grid":
            raise AssertionError(f"{shape}: the plan {plan}, expected the "
                                 f"grid layout")
        cfg, state, args, cuda, plain = window_operands(
            window, None, testing, shape, seed=seed)
        runs = [_outs(cuda(cfg, _fresh(state), *args)) for _ in range(2)]
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            raise AssertionError(f"{shape}: two grid launches differ")
        gaps, _ = bf16_agree(testing, cfg, state, args, cuda, plain,
                             f"grid layout at {shape}")
        if held:
            _, err_g, f64_g = _agree(window, phi_ops, cfg, state, *args,
                                     False, f"grid layout at {shape}")
            with forced_plan(window, nodes):
                _, err_n, f64_n = _agree(window, phi_ops, cfg, state, *args,
                                         False, f"node-resident layout at "
                                         f"{shape}")
            worst = max(worst, err_n)
            vs = (f"max abs err grid {err_g:.3e}, nodes {err_n:.3e} (vs "
                  f"float64: grid {f64_g[0]:.3e}, nodes {f64_n[0]:.3e}, "
                  f"plain {f64_g[1]:.3e})")
        else:
            want = _outs(plain(cfg, _fresh(state), *args))
            with forced_plan(window, nodes):
                got_n = _outs(cuda(cfg, _fresh(state), *args))
            diff = [max(float((a - b).abs().max()) for a, b in zip(got, want))
                    for got in (runs[0], got_n)]
            vs = (f"max abs diff from the plain version (not held) grid "
                  f"{diff[0]:.3e}, nodes {diff[1]:.3e}")
        scratch = _fresh(state)
        t = []
        for p in (plan, nodes, nodes, plan):
            with forced_plan(window, p):
                t.append(time_ms(lambda: cuda(cfg, scratch, *args), reps,
                                 hold=True))
        grid_ms, nodes_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        if shape == NODES_MAIN_SHAPE:
            b_ms, b_by = window_bound(*args, shape[4], cfg.N)
            plain_ms = time_ms(lambda: plain(cfg, _fresh(state), *args),
                               reps=5)
            main = (nodes_ms, plain_ms, b_ms, b_by)
        lines.append(
            f"{','.join(map(str, shape))} {plan}: two launches bit-equal; "
            f"bf16 = float32 rounded ({gaps['one_ulp']} values 1 ulp from "
            f"the plain version); {vs}; ms/window grid, nodes, nodes, grid "
            f"{' '.join(f'{x:.4f}' for x in t)} (grid/nodes "
            f"{grid_ms / nodes_ms:.3f}; {1e3 * grid_ms / shape[0]:.2f} vs "
            f"{1e3 * nodes_ms / shape[0]:.2f} us/step)")
    phase("kernel", "grid layout against the node-resident layout (the "
          "plan forced): " + "; ".join(lines) + f"; {smi}")
    return worst, main


def check_chain_kernel(window, kernels, chains_flat, testing, phi_ops, smi):
    """Phase 3, the fused window's chain mode: (max abs err, and the
    kernel ms, plain ms, bound ms and what sets it at the chain path's
    shape). One launch runs C clusters; it must give the same bits as C
    single-chain launches on the chains' blocks in its layout (the plan
    forced where the single-chain entry would take the grid layout)."""
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
        chain_plan, _, plan_text = _plan_line(window, lib, shape[1:], limit,
                                              chained=True)
        args = (win.xs_t, win.mcode, win.keep)
        got, err, f64 = _agree(window, phi_ops, cfg, state, *args, True,
                               f"chain window at {shape}")
        worst = max(worst, err)
        n = cfg.N
        for ci in range(c):
            rows = slice(ci * n, (ci + 1) * n)
            # the single-chain entry would take the grid layout where the
            # chain entry keeps the node-resident one: in the chain's
            with forced_plan(window, chain_plan):
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


def check_ppx_kernel(perplexity):
    """Phase 3, the held-out evaluation: {cell: (ms, plain ms, bound ms,
    what sets it, largest relative gap of a pair's average, relative gap
    of neg_avg_log)}. Pi holds PPX_PI_BYTES // 4K normalized rows, and
    the pairs draw their two rows from it."""
    from mcmc_ammsb_tpu_torch.config import Config

    dev = torch.device("cuda")
    out = {}
    for seed, (h, k, dtype, cell) in enumerate(PPX_SHAPES):
        n = PPX_PI_BYTES // (4 * k)
        cfg = Config(K=k).finalize(n, 10 * n, 8)
        g = torch.Generator(dev).manual_seed(seed)
        pi = torch.empty(n, k, dtype=dtype, device=dev)
        for a in range(0, n, 4096):
            blk = torch.rand(min(4096, n - a), k, device=dev,
                             generator=g) + 0.05
            pi[a:a + 4096] = (blk / blk.sum(-1, keepdim=True)).to(dtype)
        beta = torch.rand(k, device=dev, generator=g) * 0.9 + 0.05
        y = torch.rand(h, device=dev, generator=g) < 0.5
        u, v = (torch.randint(0, n, (h,), device=dev, generator=g,
                              dtype=torch.int32) for _ in range(2))
        ones = torch.ones_like(y)

        def kernel(avg, c):
            """The kernel on the one chain's operands, in its [1, ...]
            layout, returned without the chain axis."""
            return perplexity._one_chain(perplexity.likelihood_cuda(
                cfg, pi, pi, beta[None], u, v, y[None], avg[None], c))

        got_avg = want_avg = torch.zeros(h, device=dev)
        gaps = [0.0, 0.0]
        for count in (1, 2):
            c = perplexity.count_operand(count, got_avg)
            before = perplexity.likelihood_cuda.launches
            got = kernel(got_avg, c)
            again = kernel(got_avg, c)
            if perplexity.likelihood_cuda.launches != before + 2:
                raise AssertionError(f"ppx {cell}: the counter read "
                                     f"{perplexity.likelihood_cuda.launches}"
                                     f" after {before} and two launches")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"ppx {cell}: two launches differ")
            want = perplexity.fold_likelihood(
                perplexity.blocked_likelihood(cfg, pi, beta, u, v, y), y,
                ones, want_avg, c)
            within(got.ppx_per_edge, want.ppx_per_edge,
                   f"ppx {cell} count {count}: averages", rtol=2e-5)
            for a, b, what in zip(got[1:4], want[1:4],
                                  ("neg_avg_log", "link", "non-link")):
                within(a, b, f"ppx {cell} count {count}: {what}", rtol=1e-6)
            if not (torch.equal(got.link_count, want.link_count)
                    and torch.equal(got.non_link_count, want.non_link_count)):
                raise AssertionError(f"ppx {cell}: counts differ")
            gaps = [max(gaps[0], float(((got.ppx_per_edge.double()
                                         - want.ppx_per_edge.double()).abs()
                                        / want.ppx_per_edge.double()).max())),
                    max(gaps[1], abs(float(got.neg_avg_log)
                                     / float(want.neg_avg_log) - 1))]
            got_avg, want_avg = got.ppx_per_edge, want.ppx_per_edge
        c = perplexity.count_operand(3, got_avg)
        ms = time_ms(lambda: kernel(got_avg, c), hold=True)
        plain_ms = time_ms(lambda: perplexity.fold_likelihood(
            perplexity.blocked_likelihood(cfg, pi, beta, u, v, y), y, ones,
            want_avg, c), reps=10)
        # as ammsb_bench/counts.eval_bytes counts an evaluation: two rows
        # of every pair, its ids and its average read, the average written
        moved = h * (2 * k * pi.element_size() + 2 * 4 + 2 * 4)
        b_ms, b_by = bound(moved, 6 * h * k)
        vec, tpp = perplexity.ppx_plan(k, pi.element_size())
        out[cell] = (ms, plain_ms, b_ms, b_by, *gaps)
        phase("kernel", f"ppx {cell} (H, K)=({h}, {k}) {dtype}: {tpp} "
              f"threads a pair, {vec} values a load; kernel vs plain: "
              f"largest relative gap of an average {gaps[0]:.3e}, "
              f"neg_avg_log {gaps[1]:.3e}; two launches bit-equal; "
              f"{ms:.4f} ms/call kernel, {plain_ms:.4f} ms/call plain; "
              f"bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f}% of it")
        del pi
    return out


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


@contextlib.contextmanager
def float64_plain():
    """Within the block ``Tensor.float()`` leaves a float64 tensor as it
    is: the plain version casts gathered rows to float32 (pi may be
    stored in bf16), so on float64 operands it runs in float64."""
    real = torch.Tensor.float

    def keep64(self, *args, **kwargs):
        return self if self.dtype == torch.float64 else real(self, *args,
                                                             **kwargs)

    torch.Tensor.float = keep64
    try:
        yield
    finally:
        torch.Tensor.float = real


def _rel_dist(got, want) -> float:
    """Normwise relative distance max |got - want| / max |want|."""
    got, want = got.double().cpu(), want.double().cpu()
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite values")
    return float((got - want).abs().max() / want.abs().max())


def _slice_seeds(config, shift):
    """Config fields of a slice's draw ``shift``: the stream seeds'
    second words and the sample seed moved by ``shift`` (0: the
    config's own)."""
    base = config.Config()
    out = {f: (getattr(base, f)[0], getattr(base, f)[1] + shift)
           for f in ("phi_seed", "beta_seed", "neighbor_seed")}
    return dict(out, sample_seed=base.sample_seed + shift)


def check_f64_slice(what, draw, run, counter, fields, launches):
    """Phase 4, a window-kernel slice: 23 hoisted steps (4 windows of 5
    through the kernel, 3 tail steps) on the GPU and the plain version on
    the CPU from one state, each against a float64 evaluation of the same
    steps on the CPU, on SLICE_DRAWS draws of the port's own CPU learner
    (``draw(shift)``: (cfg, CPU state, GPU state, operands); ``run(cfg,
    state, operands)``; ``counter``, the kernel wrapper, must launch
    ``launches`` times a draw: 5 where the tail is one short window, 4
    where the engine runs it step by step). Per field the kernel may be
    no farther from float64 than 2x the plain version on most draws: the
    23 steps carry a window's rounding through the trajectory, whose
    conditioning the draw sets, so the ratio has a tail and a draw past
    2x is not the rule."""
    rows, within2 = [], {f: 0 for f in fields}
    for shift in range(SLICE_DRAWS):
        cfg, cpu_state, gpu_state, xs = draw(shift)
        with float64_plain():
            exact = run(cfg, *_float64((cpu_state, xs)))
        counter.launches = 0
        got = run(cfg, gpu_state, _to(xs, "cuda"))
        launched = counter.launches
        want = run(cfg, cpu_state, xs)
        if launched != launches:
            raise AssertionError(f"{what} slice: {launched} kernel "
                                 f"launches, not {launches}")
        d = {f: (_rel_dist(getattr(got, f), getattr(exact, f)),
                 _rel_dist(getattr(want, f), getattr(exact, f)))
             for f in fields}
        for f, (k, p) in d.items():
            within2[f] += k <= 2 * p
        gap = max(float((getattr(got, f).cpu() - getattr(want, f)).abs()
                        .max()) for f in fields)
        rows.append(f"draw {shift}: " + ", ".join(
            f"{f} {k:.3e}/{p:.3e}" for f, (k, p) in d.items())
            + f", GPU vs CPU max abs {gap:.3e}")
    phase("slice", f"{what} 23 steps (4 windows of 5 + 3 tail steps, "
          f"{launches} kernel launches each), N=300 K=24, {SLICE_DRAWS} "
          f"draws, normwise distance to float64 kernel/plain: {'; '.join(rows)}; draws with "
          f"the kernel within 2x the plain version: {within2}")
    short = {f: n for f, n in within2.items() if 2 * n <= SLICE_DRAWS}
    if short:
        raise AssertionError(f"{what} slice: the kernel within 2x the plain "
                             f"version's distance to float64 on only "
                             f"{short} of {SLICE_DRAWS} draws")


def check_slices(mods, window, window_mmsb, phi_pallas, chains_flat,
                 testing_mod):
    """Phase 4: the hoisted loops on the GPU vs the CPU from one state."""
    data, config, learner_mod, sampling, mmsb = mods
    fields = ("pi", "phi_sum", "theta", "beta")

    a_mmsb = (learner_mod.Learner, learner_mod.hoist_operands)
    check_f64_slice("a-MMSB", lambda shift: _slice_learner(
        mods, *a_mmsb, K=24, shared_neighbors=True, window=5,
        **_slice_seeds(config, shift)), learner_mod.run_hoisted,
        window.window_apply_cuda, fields, 5)

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

    def chain_draw(shift):
        cfg = config.Config(K=24, mini_batch_size=8, num_node_sample=8,
                            device_sampling=True, shared_neighbors=True,
                            window=5, **_slice_seeds(config, shift)
                            ).finalize(n, split.total_edges,
                                       graph.max_fan_out)
        cpu = chains_flat.FlatChainLearner(cfg, graph, split, 3, "cpu")
        xs = chains_flat.hoist_chain_operands(cfg, 3, cpu.training_set,
                                              cpu.heldout_set, cpu.adjacency,
                                              cpu.streams, 23)
        gpu_state = _to(cpu.state._replace(
            pi=cpu.state.pi.clone(), phi_sum=cpu.state.phi_sum.clone()),
            "cuda")
        return cfg, cpu.state, gpu_state, xs

    check_f64_slice("flat chains, C=3,", chain_draw,
                    lambda cfg, st, xs: chains_flat.run_chain_hoisted(
                        cfg, 3, st, xs),
                    window.window_chain_apply_cuda, fields, 4)

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
    from mcmc_ammsb_tpu_torch.ops import perplexity

    window, window_mmsb, phi_pallas, refblock = mods
    counters = {"ppx": (perplexity.likelihood_cuda, "launches"),
                "window": (window.window_apply_cuda, "launches"),
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
    # 4 intervals of 41 windows and a short window of the 8 tail steps
    expected = 4 * (500 // 12 + 1)
    if launches["window"] != expected:
        raise AssertionError(f"window kernel launched {launches['window']} "
                             f"times, expected {expected}")
    # every evaluation one launch pair of the evaluation kernel
    if launches["ppx"] != len(series):
        raise AssertionError(f"evaluation kernel launched "
                             f"{launches['ppx']} times for {len(series)} "
                             f"evaluations")
    # steady state: the second 1000-step call, whose numbers reach the
    # host only after the device finished it
    t1000 = next(c for s, _, c in series if s == 1000)
    t2000 = next(c for s, _, c in series if s == 2000)
    rate = 1000 / (t2000 - t1000)
    phase("main", f"a-MMSB: rc 0, ppx {ppx}, window-kernel launches "
          f"{launches['window']} (= {expected} windows, short ones in), "
          f"evaluation-kernel launches {launches['ppx']}, "
          f"steady state "
          f"{rate:.1f} updates/s")
    return launches, ppx, rate


def run_wide_main(cli, kmods, main_l, args, shape, smi, beside=""):
    """Phase 5, the main path at a wide K (``args``, 2000 steps; -k 4096,
    -k 8192 and -k 16384): the automatic window 12 runs unclamped on the window
    kernel, with as many launches as the K = 256 main path (less its 4
    short windows with bf16 pi, whose tails keep the step body), every one in
    the wide mode, in the plan's layout of ``shape`` (the layout each
    launch took is recorded where it is launched) and on rows of the
    run's pi dtype, and no other kernel entry; ppx falls below ppx[0].
    ``beside`` ends the phase line. Returns (launches, ppx, steady-state
    updates/s, peak device memory, seconds of the run)."""
    win = kmods[0]
    k = args[args.index("-k") + 1]
    dtype = (args[args.index("--pi-dtype") + 1] if "--pi-dtype" in args
             else "float32")
    s_cl, layout, wc = win.launch_plan(shape, torch.device("cuda"), False)
    layouts, dtypes = [], set()
    real = win._launch

    def launch(cfg, st, *a, **kw):
        dtypes.add(str(st.pi.dtype))
        res = real(cfg, st, *a, **kw)
        layouts.append(res[1])
        return res

    torch.cuda.reset_peak_memory_stats()
    _counts(kmods, None)
    t0 = time.perf_counter()
    win._launch = launch
    try:
        series, messages = _run_cli(cli, args)
    finally:
        win._launch = real
    seconds = time.perf_counter() - t0
    mem = torch.cuda.max_memory_allocated()
    launches = _counts(kmods, "read")
    if (any("window auto-clamped" in m for m in messages)
            or not any(m.startswith("windows of 12 steps run the window "
                                    "kernel") for m in messages)):
        raise AssertionError(f"-k {k} {dtype}: not windowed at T = 12 on "
                             f"the kernel: "
                             f"{[m for m in messages if 'window' in m]}")
    ppx = [p for _, p, _ in series]
    if ([st for st, _, _ in series] != [0, 500, 1000, 1500, 2000]
            or not all(p < ppx[0] for p in ppx[1:])):
        raise AssertionError(f"-k {k} {dtype}: ppx series {series}")
    # the K = 256 main path's launches; bf16 tails keep the step body
    n_win = main_l["window"] - (4 if dtype == "bfloat16" else 0)
    want = {name: 0 for name in launches}
    want.update(window=n_win, window_wide=n_win, ppx=len(series))
    if (launches != want or layouts != [layout] * n_win
            or dtypes != {f"torch.{dtype}"}):
        raise AssertionError(f"-k {k} {dtype}: launches {launches}, "
                             f"expected {want}; layouts "
                             f"{sorted(set(layouts))}, expected {layout}; "
                             f"pi {dtypes}")
    t = {st: c for st, _, c in series}
    rate = 1000 / (t[2000] - t[1000])
    phase("main", f"a-MMSB -k {k}, {dtype} pi: rc 0, ppx {ppx}, "
          f"window-kernel launches {launches['window']} (the K = 256 main "
          f"path: {main_l['window']}), all {len(layouts)} in the wide mode's "
          f"{layout} layout (S = {s_cl}, wc = {wc}); steady state "
          f"{rate:.1f} updates/s; peak device memory {mem} B; "
          f"{seconds:.1f} s in all (host init included){beside}; {smi}")
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
    # one evaluation-kernel launch pair a point of the series
    want = {k: expected.get(k, 0) for k in launches}
    want["ppx"] = len(series)
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
    """Phase 5, one of NEW_RUNS: an engine that launches no kernel but
    the a-MMSB evaluation's (the vmap chains: one launch pair a chain and
    evaluation; the MMSB model evaluates in torch ops)."""
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
    evals = 0 if "mmsb" in args else chains * len(series)
    if launches["ppx"] != evals or any(v for k, v in launches.items()
                                       if k != "ppx"):
        raise AssertionError(f"{name}: launches {launches}, expected "
                             f"{evals} evaluation launches and no other")
    rate = chains * steps / (series[-1][2] - series[0][2])
    phase("main", f"{name}: rc 0, ppx[0] {ppx[0]}, ppx[{steps}] {ppx[-1]}; no "
          f"kernel launch but {evals} of the evaluation kernel (the rest "
          f"torch ops); "
          f"{rate:.1f} updates/s"
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
    if not ppx[-1] < ppx[0] or launches["window"] != 2 * (500 // 12 + 1):
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


class ParentRngLib:
    """A build of PARENT_RNG_SRC (one thread per stream) behind the
    wrapper's calls: each entry on the same CUDA operands, returning
    (values, seeds') as the wrapper does."""

    def __init__(self, path: Path, ref_rng):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib = ctypes.CDLL(str(path))
        lib.randn_lanes_launch.argtypes = [P, P, P, I, I, I, P, P, P, P]
        lib.neighbors_lanes_launch.argtypes = [P, P, P, P, I, I, I, I, P]
        lib.gamma_lanes_launch.argtypes = [P, P, P, I, ctypes.c_longlong,
                                           F, F, F, I, F, P, P, P, P]
        self.lib, self.ref = lib, ref_rng

    def _tables(self):
        return [t.data_ptr() for t in self.ref.ziggurat_tables("cuda")]

    @staticmethod
    def _stream():
        return torch.cuda.current_stream().cuda_stream

    def randn_lanes(self, seeds, k, mask):
        new = seeds.clone()
        s_len, lanes = mask.shape
        out = torch.empty(s_len, lanes, k, device="cuda")
        if self.lib.randn_lanes_launch(new.data_ptr(), mask.data_ptr(),
                                       out.data_ptr(), s_len, lanes, k,
                                       *self._tables(), self._stream()):
            raise AssertionError("parent randn_lanes launch failed")
        return out, new

    def neighbors_lanes(self, seeds, nodes, mask, n, num):
        new = seeds.clone()
        s_len, lanes = mask.shape
        out = torch.empty(s_len, lanes, num, dtype=torch.int64,
                          device="cuda")
        if self.lib.neighbors_lanes_launch(
                new.data_ptr(), nodes.data_ptr(), mask.data_ptr(),
                out.data_ptr(), s_len, lanes, n, num, self._stream()):
            raise AssertionError("parent neighbors_lanes launch failed")
        return out, new

    def gamma_lanes(self, seeds, a, b, mask):
        import numpy as np

        if a < 1.0:
            raise ValueError("the parent's gamma_lanes is called with a >= 1")
        new = seeds.clone()
        s_len, lanes = mask.shape
        out = torch.empty(s_len, lanes, device="cuda")
        if self.lib.gamma_lanes_launch(
                new.data_ptr(), mask.data_ptr(), out.data_ptr(), s_len,
                lanes, float(np.float32(a - 1.0 / 3.0)),
                float(np.float32((1.0 / 3.0) / np.sqrt(a - 1.0 / 3.0))),
                float(np.float32(b)), 0, 1.0, *self._tables(),
                self._stream()):
            raise AssertionError("parent gamma_lanes launch failed")
        return out, new


def check_ref_rng_kernel(cli, refblock, ref_rng, sampler_cls, bench,
                         parent):
    """Phase 3, csrc/ref_rng_kernel.cu: each entry against the plain
    version (rng/reference.py) on the same CUDA seeds, values and seeds
    bit for bit, at the --rng reference path's launch shapes: the phi
    noise of a 200-step chunk of real host batches (64 lanes, K=256) in
    one launch, its theta noise (200, 256 lanes, 2), its neighbor draws
    (200, 64 lanes, n=32, N=317,080) and the pi init's Gamma draws
    (317,080 x 32 lanes, 8 column blocks); Gamma draws with a < 1 (the
    boost pre-pass) on 1280 lanes; and the stress cases: neighbors at
    N = 40 (frequent redraws, several warp rounds a step; the chunk's
    first 50 steps), one long stream (2000, 1, 256), the phi mask with
    whole lanes off and the theta noise with whole lanes off. The plain
    phi noise runs a rejection loop per draw (~1 s per step of the chunk
    on the card), so it draws only a launch's last steps
    (REF_PLAIN_STEPS, REF_STRESS_STEPS), from the seeds a launch over the
    steps before them leaves, whose values equal the whole launch's
    first steps. The main entries and the long stream are also held,
    whole, against the build of PARENT_RNG_SRC (one thread per stream),
    bit for bit, and timed against it in turns (parent, change, change,
    parent). Kernel times by CUDA events over 20 calls at the launch
    shape while the host is held back (device time), the plain version's
    by its one comparison call. Returns ({entry: (0.0, (ms, plain_ms,
    bound_ms, bound_by), plain steps)} for the main path's three entries
    and the theta noise, {entry: (parent ms, change ms)}, {entry: the
    layout's threads per stream})."""
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
    # the stress cases' operands: ids in [0, 40), one long stream, whole
    # lanes off
    gen = torch.Generator().manual_seed(40)
    nodes40 = torch.randint(0, 40, (50, lanes), generator=gen,
                            dtype=torch.int32).cuda()
    long_seeds = ref_rng.make_seeds((2000, 256), 1, "cuda")
    long_mask = torch.ones(2000, 1, dtype=torch.bool, device="cuda")
    off_mask = mask.clone()
    off_mask[:, [0, 17, lanes - 1]] = False
    off_every = every.clone()
    off_every[:, [0, 100, cfg.K - 1]] = False

    # the randn cases whose plain version draws only the last steps: the
    # values and seeds of a launch over the steps before them
    heads = {}
    for name, (kmask, k, n, sd) in {
            "randn_lanes": (mask, cfg.K, REF_PLAIN_STEPS, seeds),
            "randn_lanes (one long stream)": (long_mask, 256,
                                              REF_STRESS_STEPS, long_seeds),
            "randn_lanes (whole lanes off)": (off_mask, cfg.K,
                                              REF_STRESS_STEPS, seeds)
            }.items():
        heads[name] = (*refblock.randn_lanes(sd, k, kmask[:-n]), n)

    def state(streams):
        # xorshift128+ state: four 32-bit words per stream, read and written
        return 2 * 16 * streams

    def tail_case(name, kernel_mask, k, seeds_):
        head, head_seeds, n = heads[name]
        return (lambda: refblock.randn_lanes(seeds_, k, kernel_mask),
                lambda: ref_rng.randn_lanes(head_seeds, k, kernel_mask[-n:]),
                lambda got: (got[0][-n:], got[1]),
                state(kernel_mask.shape[1]) + nbytes(kernel_mask)
                + kernel_mask.numel() * k * 4, int(kernel_mask.sum()) * k)

    # entry: (kernel, plain, the kernel's (values, seeds) the plain ones
    # are held against, the bytes the function must move, its float32
    # operations: one product per Gaussian draw (the ziggurat's j * w), one
    # for the rest at least)
    cases = {
        "randn_lanes": tail_case("randn_lanes", mask, cfg.K, seeds),
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
    cases["neighbors_lanes (N=40)"] = (
        lambda: refblock.neighbors_lanes(seeds, nodes40, mask[:50], 40,
                                         cfg.num_node_sample),
        lambda: ref_rng.neighbors_lanes(seeds, nodes40, mask[:50], 40,
                                        cfg.num_node_sample),
        lambda got: got, state(lanes) + nbytes(mask[:50]) + 50 * lanes
        * (1 + cfg.num_node_sample) * 4, 0)
    cases["randn_lanes (one long stream)"] = tail_case(
        "randn_lanes (one long stream)", long_mask, 256, long_seeds)
    cases["randn_lanes (whole lanes off)"] = tail_case(
        "randn_lanes (whole lanes off)", off_mask, cfg.K, seeds)
    cases["randn_lanes (theta noise, whole lanes off)"] = (
        lambda: refblock.randn_lanes(beta_seeds, 2, off_every),
        lambda: ref_rng.randn_lanes(beta_seeds, 2, off_every),
        lambda got: got, state(cfg.K) + s_len * cfg.K * 2 * 4,
        int(off_every.sum()) * 2)
    # the entries held, whole, against PARENT_RNG_SRC's build and timed
    # against it
    against_parent = {
        "randn_lanes": lambda lib: lib.randn_lanes(seeds, cfg.K, mask),
        "randn_lanes (theta noise)":
            lambda lib: lib.randn_lanes(beta_seeds, 2, every),
        "neighbors_lanes": lambda lib: lib.neighbors_lanes(
            seeds, nodes, mask, cfg.N, cfg.num_node_sample),
        "gamma_lanes": lambda lib: lib.gamma_lanes(g_seeds, cfg.eta0,
                                                   cfg.eta1, g_mask),
        "randn_lanes (one long stream)":
            lambda lib: lib.randn_lanes(long_seeds, 256, long_mask)}
    out, turns, layouts = {}, {}, {}
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
        if name in heads:
            head, _, n = heads[name]
            cut = got[0].shape[0] - n
            if not torch.equal(got[0][:cut], head):
                raise AssertionError(
                    f"{name}: the launch's first {cut} steps differ from a "
                    f"{cut}-step launch's")
            note = (f" (its last {n} steps, from the seeds a {cut}-step "
                    f"launch leaves; the first {cut} equal that launch's)")
        if name in against_parent:
            old = against_parent[name](parent)
            for g, w, what in zip(got, old, ("values", "seeds")):
                if not torch.equal(g, w):
                    raise AssertionError(
                        f"{name}: {what} differ from {PARENT_RNG_SRC}'s "
                        f"build at {int((g != w).sum())} elements")
            first = time_ms(lambda: against_parent[name](parent), reps=20,
                            hold=True)
            mid = [time_ms(kernel, reps=20, hold=True) for _ in range(2)]
            last = time_ms(lambda: against_parent[name](parent), reps=20,
                           hold=True)
            turns[name] = ((first + last) / 2, sum(mid) / 2)
            note += (f"; bit-equal to {PARENT_RNG_SRC}'s build, in turns "
                     f"{first:.4f} / {mid[0]:.4f} / {mid[1]:.4f} / "
                     f"{last:.4f} ms (parent, change, change, parent): "
                     f"{turns[name][0] / turns[name][1]:.1f}x")
        if name.startswith("randn_lanes"):
            k_draws = got[0].shape[2]
            layouts[name] = refblock.randn_layout(got[0].shape[0],
                                                  got[0].shape[1],
                                                  k_draws)[0]
            note += (f"; {'a block' if layouts[name] > 32 else 'a warp'} "
                     f"per stream")
        plain_steps = want[0].shape[0]
        ms = time_ms(kernel, reps=20, hold=True)
        b_ms, by = bound(need, draws)
        if name in ("randn_lanes", "randn_lanes (theta noise)",
                    "neighbors_lanes", "gamma_lanes"):
            out[name] = (0.0, (ms, plain_ms, b_ms, by), plain_steps)
        phase("kernel", f"ref_rng {name} {tuple(got[0].shape)}: values and "
              f"seeds bit-equal to the plain version{note}; {ms:.4f} ms per "
              f"launch (device) vs plain {plain_ms:.1f} ms (one call of "
              f"{plain_steps} steps); bound {b_ms * 1e3:.3f} us ({by})")
    return out, turns, layouts


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
    # the flat chains evaluate every chain in one launch pair
    want = {k: expected.get(k, 0) for k in launches}
    want.update(chains=launches["chains"], ppx=len(series))
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
    # the main path's whole windows: the sharded engine runs each chunk's
    # tail steps one at a time, the single-GPU one as a short window
    whole = 4 * (500 // 12)
    if (launches["window"] != whole or launches["ppx"] != len(series)
            or any(v for k, v in launches.items()
                   if k not in ("window", "ppx"))):
        raise AssertionError(f"--mesh 1,1 launches {launches}, expected "
                             f"{whole} windows (the single-GPU main path "
                             f"{main_l['window']}) and {len(series)} "
                             f"evaluations")
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
    if not all(p < ppx0 for p in resumed) or launches["window"] != 84:
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
    mode at the K = 4096 path's (its step layout), the K = 8192 path's
    (its step layout with one set of rows) and the K = 16384 path's (its
    grid layout, and its node-resident layout with the plan forced)
    (``bf16_agree``), timed
    against the float32 launches on the same operands in this call
    (turns: f32, bf16, bf16, f32). Returns {kernel: (gaps, max abs err,
    bf16 ms, f32 ms, bound ms with pi's row bytes halved, what sets
    it)}."""
    out = {}
    nodes = (16, "nodes", window.NODES_TILE)
    for name, shape in (("window_kernel", WINDOW_SHAPES[0]),
                        ("window_kernel_chains", CHAIN_SHAPES[0]),
                        ("window_kernel_wide", WIDE_MAIN_SHAPE),
                        ("window_kernel_ladder", LADDER_SHAPE),
                        ("window_kernel_step1", STEP1_MAIN_SHAPE),
                        ("window_kernel_grid", NODES_MAIN_SHAPE),
                        ("window_kernel_nodes", NODES_MAIN_SHAPE)):
        cfg, state, args, cuda, plain = window_operands(
            window, chains_flat, testing, shape)
        if name == "window_kernel_nodes":
            real_cuda = cuda

            def cuda(*a, _f=real_cuda):
                with forced_plan(window, nodes):
                    return _f(*a)
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
    chunks of 100 steps: 8 windows and a short one each, 90 launches):
    the first ppx after the import
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
            or gap >= 0.02 or launches["window"] != 90
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
            # a launch per whole window and one per chunk's tail steps,
            # which bf16 pi runs through the step body
            n_win = 0 if want is None else (
                LADDER_ITERS // LADDER_INTERVAL) * (
                    LADDER_INTERVAL // 12 + (want[1] != "bfloat16"
                                             and LADDER_INTERVAL % 12 > 0))
            expect = {k: 0 for k in launches}
            expect.update(window=n_win,
                          window_wide=n_win if want and want[0] != "resident"
                          else 0, ppx=len(series))
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


def _npz_leaves(path):
    """The state leaves (``leaf_i``) of an npz checkpoint, as numpy."""
    import numpy as np

    with np.load(path, allow_pickle=False) as z:
        return [z[f"leaf_{i}"] for i in range(len(z.files))
                if f"leaf_{i}" in z.files]


@contextlib.contextmanager
def restored_leaves(cli, checkpoint, out):
    """The CLI's ``load_checkpoint`` for the block, with the leaves of
    the learner's state right after the restore appended to ``out``."""
    real = cli.load_checkpoint

    def load(path, learner):
        real(path, learner)
        out.append([leaf.copy() for st in checkpoint._states(learner)
                    for leaf in checkpoint.state_leaves(st)])

    cli.load_checkpoint = load
    try:
        yield
    finally:
        cli.load_checkpoint = real


def _carry_fixture(cli, learner_mod, testing, kmods, tmp, name):
    """One committed JAX-written checkpoint continued on the card through
    the CLI with the fixture's own arguments: (launches, ppx series,
    messages)."""
    import os

    import numpy as np

    side = json.loads((FIXTURE_DIR / f"{name}.json").read_text())
    path = str(FIXTURE_DIR / f"{name}.npz")
    cont = os.path.join(tmp, f"carry_{name}.npz")
    first = []
    _counts(kmods, None)
    with spied(learner_mod.Learner, "_scan_chunk",
               lambda lrn, state, batches: first.append(batches)):
        series, messages = _run_cli(cli, side["argv"] + [
            "--restore", path, "--device", "cuda", "--checkpoint", cont])
    launches = _counts(kmods, "read")
    ppx = {s: p for s, p, _ in series}
    reseeded = [m for m in messages if "re-seeded" in m]
    bad = []
    if f"restored checkpoint {path} (step=11)" not in messages:
        bad.append("no 'restored checkpoint ... (step=11)' line")
    for f, want in side["first_minibatch"].items():
        if not np.array_equal(getattr(first[0], f)[0].cpu().numpy(),
                              np.asarray(want)):
            bad.append(f"first minibatch's {f} differs")
    if not math.isclose(ppx[0], side["ppx"]["0"], rel_tol=CARRY_PPX_RTOL):
        bad.append(f"ppx[0] {ppx[0]} vs JAX {side['ppx']['0']}")
    if "reference" in side["argv"]:
        leaves = _npz_leaves(cont)
        got = testing.digest({"pi": leaves[0], "theta": leaves[2],
                              "phi_sum": leaves[1]})
        bad += testing.digest_misses(got, side["digest"], CARRY_RTOL, ATOL)
        if not math.isclose(ppx[10], side["ppx"]["10"],
                            rel_tol=CARRY_PPX_RTOL):
            bad.append(f"ppx[10] {ppx[10]} vs JAX {side['ppx']['10']}")
        # one chunk of 10 steps: its phi and theta noise, its neighbors
        # (and the init's gamma draws before the restore)
        drawn = {k: v for k, v in launches.items()
                 if v and k not in ("gamma", "ppx")}
        if (drawn != {"randn": 2, "neighbors": 1} or reseeded
                or "reference RNG: the kernel" not in " ".join(messages)):
            bad.append(f"launches {launches}, re-seed lines {reseeded}")
    elif reseeded != ["random streams re-seeded at step 11 (checkpoint "
                      "written by jax)"] or not math.isfinite(ppx[10]):
        bad.append(f"re-seed lines {reseeded}, ppx {ppx}")
    if bad:
        raise AssertionError(f"carry {name}: {bad}")
    return launches, ppx, side


def run_carry_phase(cli, checkpoint, learner_mod, testing, kmods, tmp, smi):
    """Phase carry: the committed JAX-written checkpoints continued on the
    card, then a main-path run carried card -> CPU -> card. Returns
    {run: launches}."""
    import os

    out = {}
    for name in ("learner_reference", "learner_host"):
        launches, ppx, side = _carry_fixture(cli, learner_mod, testing,
                                             kmods, tmp, name)
        out[name] = launches
        phase("carry", f"JAX-written {name} (--restore, "
              f"{' '.join(side['argv'])}): restored at step 11, ppx {ppx} "
              f"against JAX's {side['ppx']} (rtol {CARRY_PPX_RTOL}), the "
              f"first minibatch bit-equal to JAX's"
              + (", pi/theta/phi_sum digest within the normwise contract, "
                 "nothing re-seeded" if "reference" in side["argv"]
                 else ", torch streams re-seeded once")
              + f"; launches {({k: v for k, v in launches.items() if v})}")

    # the main path on the card, on the CPU from its checkpoint, and back
    first, second = (os.path.join(tmp, f"carry_{d}.npz")
                     for d in ("cuda", "cpu"))
    legs = [("cuda", CARRY_STEPS, [], first),
            ("cpu", CARRY_CPU_STEPS, ["--restore", first], second),
            ("cuda", CARRY_BACK_STEPS, ["--restore", second], None)]
    ppx0, runs = None, []
    for device, steps, extra, save in legs:
        restored = []
        argv = CARRY_ARGS + ["-x", str(steps), "-i", str(min(500, steps)),
                             "--device", device] + extra
        t0 = time.perf_counter()
        _counts(kmods, None)
        with restored_leaves(cli, checkpoint, restored):
            series, messages = _run_cli(
                cli, argv + (["--checkpoint", save] if save else []))
        launches = _counts(kmods, "read")
        secs = time.perf_counter() - t0
        ppx = [p for _, p, _ in series]
        ppx0 = ppx[0] if ppx0 is None else ppx0
        if not all(math.isfinite(p) and p < ppx0 for p in ppx[1:]):
            raise AssertionError(f"carry on {device}: ppx {ppx} against the "
                                 f"first run's ppx[0] {ppx0}")
        want_launches = (0 if device == "cpu"
                         else (steps // min(500, steps)) * -(
                             -min(500, steps) // 12))
        if launches["window"] != want_launches:
            raise AssertionError(f"carry on {device}: {launches['window']} "
                                 f"window launches, expected {want_launches}")
        note = ""
        if extra:
            src = extra[1]
            wrote = "cuda" if src == first else "cpu"
            file_leaves = _npz_leaves(src)
            # every leaf (pi, theta, the counters...) bit-equal
            differ = [i for i, (a, b) in enumerate(zip(file_leaves,
                                                       restored[0]))
                      if not (a.dtype == b.dtype and a.shape == b.shape
                              and (a == b).all())]
            line = (f"random streams re-seeded at step "
                    f"{int(file_leaves[4])} (checkpoint written by {wrote})")
            if differ or line not in messages:
                raise AssertionError(f"carry to {device}: leaves {differ} "
                                     f"differ at the restore, or no "
                                     f"{line!r} in the log")
            note = (f"restored from the {wrote} save at step "
                    f"{int(file_leaves[4])}: its {len(file_leaves)} state "
                    f"leaves bit-equal, '{line}'; ")
        runs.append(launches)
        phase("carry", f"main path ({' '.join(CARRY_ARGS)}) on {device}, "
              f"{steps} steps: {note}ppx {ppx} (below the card run's "
              f"ppx[0] {ppx0}), {launches['window']} window launches, "
              f"{secs:.1f} s" + (f"; {smi}" if device == "cuda" else ""))
    out["there"], out["back"] = runs[0], runs[2]
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


def _nulls(x, where=""):
    """The paths of every null in a JSON value."""
    if isinstance(x, dict):
        return [p for k, v in x.items() for p in _nulls(v, f"{where}.{k}")]
    return [where] if x is None else []


def run_bench_phase(bench, kmods, smi):
    """Phase bench: ``bench.main`` on the card at BENCH_CUT (the bench's
    widths, its run lengths and trials cut), each phase's kernel launches
    counted: {phase: launches}. The line must have every key non-null
    but ``vs_baseline``, every rate positive, the three graphs' N, E and
    max fan-out the JAX bench's, the SBM perplexity falling, the measured
    copy rate within the card's 3.35 TB/s and the device nvidia-smi's."""
    per_phase = {}

    @contextlib.contextmanager
    def counted(label):
        _counts(kmods, None)
        yield
        per_phase[label] = _counts(kmods, "read")

    s = bench.Sizes(**BENCH_CUT)
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        line = bench.main(device="cuda", sizes=s, phase=counted)
    seconds = time.perf_counter() - t0
    if [json.loads(x) for x in out.getvalue().splitlines()] != [line]:
        raise AssertionError(f"bench printed {out.getvalue()!r}")
    x = line["extra"]
    if (set(line) != {"metric", "value", "unit", "vs_baseline", "extra"}
            or line["vs_baseline"] is not None
            or _nulls(dict(line, vs_baseline=0))):
        raise AssertionError(f"bench line keys or nulls: {line}")
    rates = {"value": line["value"], **{k: x[k] for k in BENCH_RATES},
             **{f"autotune {w}": r for w, r in
                x["autotune_table"]["rates_by_window"].items()}}
    if not all(r > 0 for r in rates.values()):
        raise AssertionError(f"bench rates {rates}")
    graphs = [(x["N"], x["E"]), (x["powerlaw_N"], x["powerlaw_E"],
                                 x["powerlaw_max_fan_out"])]
    if graphs != [(317_079, 1_109_780), (310_310, 1_021_641, 330)]:
        raise AssertionError(f"bench graphs {graphs}")
    roof = x["roofline"]
    if not (0 < roof["hbm_bw_gbps_measured"] <= 3350
            and roof["random_row_gather_ns_per_row_measured"] > 0
            and roof["random_row_scatter_ns_per_row_measured"] > 0
            and x["sbm_ppx_end"] < x["sbm_ppx_start"]
            and ", ".join(x["device"].values()) == smi):
        raise AssertionError(f"bench roofline, SBM or device: {x}")
    calls = 1 + s.trials * s.iters // s.steps_per_call
    # the single-chip engine runs each chunk's tail steps as one short
    # window; the sharded engine one at a time
    want = {"windowed-shared-neighbors": {"window": calls * -(
                -s.steps_per_call // 12), "window_chain": 0},
            "sharded-1x1": {"window": calls * (s.steps_per_call // 12)},
            "chains-c16": {"window": 0, "window_chain": (
                1 + s.trials * s.chain_iters // s.chain_steps_per_call)
                * (s.chain_steps_per_call // 6)},
            "reference-semantics": {"window": 0},
            "device-bflink": {"window": 0},
            "bit-exact-rng": {"randn": 2 * (
                1 + s.short_trials * s.bitexact_iters
                // s.bitexact_steps_per_call), "gamma": 2, "window": 0}}
    want["bit-exact-rng"]["neighbors"] = want["bit-exact-rng"]["randn"] // 2
    for label, counts in want.items():
        got = {k: per_phase[label][k] for k in counts}
        if got != counts:
            raise AssertionError(f"bench {label}: launches {got}, expected "
                                 f"{counts}")
    for label in ("stratified-coin", "power-law", "autotune"):
        if per_phase[label]["window"] == 0:
            raise AssertionError(f"bench {label}: no window launch")
    windows = {k: v["window"] for k, v in per_phase.items() if v["window"]}
    ref = {k: per_phase["bit-exact-rng"][k]
           for k in ("randn", "neighbors", "gamma")}
    phase("bench", f"mcmc_ammsb_tpu_torch.bench at {BENCH_CUT}: "
          f"{seconds:.1f} s, headline {line['value']} updates/s, rates "
          f"{rates}, roofline {roof['hbm_bw_gbps_measured']} GB/s, gather "
          f"{roof['random_row_gather_ns_per_row_measured']} ns/row, scatter "
          f"{roof['random_row_scatter_ns_per_row_measured']} ns/row; "
          f"window launches {windows}, chain launches "
          f"{per_phase['chains-c16']['window_chain']}, ref RNG {ref}")
    return per_phase


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    # the port's package: an ImportError here (no checkout around the
    # script) ends the run before anything is printed
    from mcmc_ammsb_tpu_torch import (chains_flat, checkpoint, cli, config,
                                      data, graft, kernels, ladder, native,
                                      refckpt, rng, testing)
    from mcmc_ammsb_tpu_torch import bench as port_bench
    from mcmc_ammsb_tpu_torch import learner as learner_mod
    from mcmc_ammsb_tpu_torch.models import mmsb
    from mcmc_ammsb_tpu_torch.ops import (device_sampling, edgeset, neighbor,
                                          perplexity, phi_pallas, sort,
                                          window, window_mmsb)
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
        parent, parent_rng = build_all(kernels, native)
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
        ppx_k = check_ppx_kernel(perplexity)
        m_err, m_t = check_mmsb_kernel(window, window_mmsb, kernels, testing,
                                       phi_ops, smi)
        rr, rr_turns, rr_layouts = check_ref_rng_kernel(
            cli, refblock, ref_rng, MiniBatchSampler, bench,
            ParentRngLib(parent_rng, ref_rng))
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
            cli, kmods, main_l, WIDE_ARGS, WIDE_MAIN_SHAPE, smi,
            f"; the K = 256 main path: {main_rate:.1f} updates/s, peak "
            f"{main_mem} B")
        step1_runs = {dtype: run_wide_main(cli, kmods, main_l,
                                           STEP1_ARGS + extra,
                                           STEP1_MAIN_SHAPE, smi)
                      for dtype, extra in (("float32", []),
                                           ("bfloat16", ["--pi-dtype",
                                                         "bfloat16"]))}
        grid_runs = {dtype: run_wide_main(cli, kmods, main_l,
                                          NODES_ARGS + extra,
                                          NODES_MAIN_SHAPE, smi)
                     for dtype, extra in (("float32", []),
                                          ("bfloat16", ["--pi-dtype",
                                                        "bfloat16"]))}
        for dtype, run in grid_runs.items():
            # the peak stays within pi plus 3 GB of working set
            pi_bytes = 317080 * 16384 * (4 if dtype == "float32" else 2)
            if run[3] > pi_bytes + 3e9:
                raise AssertionError(f"-k 16384 {dtype}: peak {run[3]} B, "
                                     f"pi {pi_bytes} B + 3 GB allowed")
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
            carry = run_carry_phase(cli, checkpoint, learner_mod, testing,
                                    kmods, tmp, smi)
        ladder_l = run_ladder_phase(ladder, window, kernels, kmods, jobs,
                                    smi)
        run_entry_phase(graft)
        bench_l = run_bench_phase(port_bench, kmods, smi)
    finally:
        pool.terminate()
        pool.join()
        ladder_dir.cleanup()

    def times(t):
        # no single PyTorch call computes any of these functions
        return {"ms": t[0], "plain_ms": t[1], "bound_ms": t[2],
                "bound_by": t[3], "library_ms": None}

    def bench_launches(counter):
        # the bench phase's launches of one counter, by the bench's phase
        return {label: c[counter] for label, c in bench_l.items()}

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
        # ms and bound_ms are the main path's launch (a 200-step chunk),
        # device time; plain_ms covers the plain_steps the plain version
        # drew of it; parent_ms and change_ms: PARENT_RNG_SRC's build and
        # this one in turns
        err, t, plain_steps = rr[name]
        # carry_launches: the JAX-written --rng reference fixture's
        # continuation on the card (its init's gamma draws included)
        entry = name.replace("_lanes", "")
        return {"max_abs_err": err, **times(t), "plain_steps": plain_steps,
                "parent_ms": rr_turns[name][0],
                "change_ms": rr_turns[name][1],
                "carry_launches": carry["learner_reference"][entry],
                "bench_launches": bench_launches(entry)}

    theta = "randn_lanes (theta noise)"
    theta_fields = {
        # the theta noise's launch (200, 256, 2) beside the phi noise's,
        # and the threads per stream of each
        "theta_ms": rr[theta][1][0], "theta_plain_ms": rr[theta][1][1],
        "theta_bound_ms": rr[theta][1][2],
        "theta_bound_by": rr[theta][1][3],
        "theta_parent_ms": rr_turns[theta][0],
        "theta_change_ms": rr_turns[theta][1],
        "threads_per_stream": rr_layouts}

    src = "mcmc_ammsb_tpu_torch/csrc/"
    print(json.dumps({"kernels": [
        # one launch per window: gather, T steps on a cluster, scatter
        {"name": "window_kernel", "route": "cuda",
         "source": src + "window_kernel.cu",
         "replaces": "mcmc_ammsb_tpu/ops/window.py:321",
         "launches": main_l["window"], "max_abs_err": w["resident"][0],
         **times(w["resident"][1]),
         # the carry phase's card legs: 1000 main-path steps before the
         # save, one window after the CPU leg's restore
         "carry_launches": carry["there"]["window"] + carry["back"]["window"],
         # the resident mode against the build of PARENT_SRC, float32, at
         # the main path's shape, in turns (bit-equal at every shape)
         "resident_parent_ms": parent_t[WINDOW_SHAPES[0]][0],
         "resident_change_ms": parent_t[WINDOW_SHAPES[0]][1],
         # the wide mode: its launches on the -k 4096 main path (2000
         # steps), its checks at the wide shapes, its times at the K = 4096
         # path's window, the path's rate and peak memory
         "wide_launches": wide_l["window_wide"],
         "wide_max_abs_err": w["step"][0], "wide_ms": w["step"][1][0],
         "wide_plain_ms": w["step"][1][1], "wide_bound_ms": w["step"][1][2],
         "wide_bound_by": w["step"][1][3],
         "wide_updates_per_s": wide_rate, "wide_peak_bytes": wide_mem,
         "main_updates_per_s": main_rate, "main_peak_bytes": main_mem,
         "wide_sharded_window_max_abs_err": shard["wide_window"][0],
         "wide_bf16_max_abs_err": bf16_k["window_kernel_wide"][1],
         "wide_bf16_ms": bf16_k["window_kernel_wide"][2],
         "wide_bf16_f32_ms": bf16_k["window_kernel_wide"][3],
         # the wide mode against the build of PARENT_SRC (at its own
         # plan) in turns, at the K = 4096 path's window and at every wide
         # shape, with the layout this build took there
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
                    for name, v in ladder_l.items()},
         # the port's bench (phase bench): launches in each of its phases
         "bench_launches": bench_launches("window"),
         # every layout of the plan: its shape of LAYOUT_SHAPES, its
         # largest normwise difference over its shapes and its times there
         "layouts": {mode: {"shape": list(LAYOUT_SHAPES[mode]),
                            "max_abs_err": w[mode][0], **times(w[mode][1])}
                     for mode in LAYOUT_SHAPES}},
        # the wide mode's step layout (window_kernel_step, the same entry
        # and source) on its own: the -k 4096 main path's launches
        {"name": "window_kernel_wide", "route": "cuda",
         "source": src + "window_kernel.cu",
         "replaces": "mcmc_ammsb_tpu/ops/window.py:321 (K = 1536-4096)",
         "launches": wide_l["window_wide"], "max_abs_err": w["step"][0],
         **times(w["step"][1])},
        # the wide mode's step layout with one set of rows
        # (window_kernel_step1) on its own: the -k 8192 main path's
        # launches, its times at that path's window (T = 12), against the
        # build of PARENT_SRC (its chunked layout) in turns at every shape
        # it takes, and the path's bf16 run
        {"name": "window_kernel_step1", "route": "cuda",
         "source": src + "window_kernel.cu",
         "replaces": "mcmc_ammsb_tpu/ops/window.py:321 (K = 6144-8192)",
         "launches": step1_runs["float32"][0]["window_wide"],
         "max_abs_err": w["step1"][0], **times(w["step1"][1]),
         "parent_ms": wide_t[STEP1_MAIN_SHAPE][0],
         "change_ms": wide_t[STEP1_MAIN_SHAPE][1],
         "turns_ms": {",".join(map(str, sh)): v[2]
                      for sh, v in wide_t.items()
                      if v[3].startswith("step1")},
         "updates_per_s": step1_runs["float32"][2],
         "peak_bytes": step1_runs["float32"][3],
         "bf16_launches": step1_runs["bfloat16"][0]["window_wide"],
         "bf16_updates_per_s": step1_runs["bfloat16"][2],
         "bf16_peak_bytes": step1_runs["bfloat16"][3],
         "bf16_one_ulp": bf16_k["window_kernel_step1"][0]["one_ulp"],
         "bf16_more_ulps": bf16_k["window_kernel_step1"][0]["more_ulps"],
         "bf16_max_abs_err": bf16_k["window_kernel_step1"][1],
         "bf16_ms": bf16_k["window_kernel_step1"][2],
         "bf16_f32_ms": bf16_k["window_kernel_step1"][3]},
        # the wide mode's grid layout (window_kernel_grid) on its own: the
        # -k 16384 main path's launches, its times at that path's window
        # (T = 12), against the build of PARENT_SRC (its chunked layout) in
        # turns at every shape it takes, and the path's bf16 run
        {"name": "window_kernel_grid", "route": "cuda",
         "source": src + "window_kernel.cu",
         "replaces": "mcmc_ammsb_tpu/ops/window.py:321 (K = 10240-16384)",
         "launches": grid_runs["float32"][0]["window_wide"],
         "max_abs_err": w["grid"][0], **times(w["grid"][1]),
         "parent_ms": wide_t[NODES_MAIN_SHAPE][0],
         "change_ms": wide_t[NODES_MAIN_SHAPE][1],
         "turns_ms": {",".join(map(str, sh)): v[2]
                      for sh, v in wide_t.items()
                      if v[3].startswith("grid")},
         "updates_per_s": grid_runs["float32"][2],
         "peak_bytes": grid_runs["float32"][3],
         "bf16_launches": grid_runs["bfloat16"][0]["window_wide"],
         "bf16_updates_per_s": grid_runs["bfloat16"][2],
         "bf16_peak_bytes": grid_runs["bfloat16"][3],
         "bf16_one_ulp": bf16_k["window_kernel_grid"][0]["one_ulp"],
         "bf16_more_ulps": bf16_k["window_kernel_grid"][0]["more_ulps"],
         "bf16_max_abs_err": bf16_k["window_kernel_grid"][1],
         "bf16_ms": bf16_k["window_kernel_grid"][2],
         "bf16_f32_ms": bf16_k["window_kernel_grid"][3]},
        # the wide mode's node-resident layout (window_kernel_nodes): the
        # chain engine's at K = 10240-16384, and the single-chain entry's
        # on a card that holds too few clusters at once for the grid; its
        # times at the -k 16384 path's window with the plan forced
        {"name": "window_kernel_nodes", "route": "cuda",
         "source": src + "window_kernel.cu",
         "replaces": "mcmc_ammsb_tpu/ops/window.py:321 (K = 10240-16384, "
                     "chains)",
         "max_abs_err": w["nodes"][0], **times(w["nodes"][1]),
         "bf16_one_ulp": bf16_k["window_kernel_nodes"][0]["one_ulp"],
         "bf16_more_ulps": bf16_k["window_kernel_nodes"][0]["more_ulps"],
         "bf16_max_abs_err": bf16_k["window_kernel_nodes"][1],
         "bf16_ms": bf16_k["window_kernel_nodes"][2],
         "bf16_f32_ms": bf16_k["window_kernel_nodes"][3]},
        # the same kernel and entry, one cluster per chain: the chain
        # engine's launches
        {"name": "window_kernel_chains", "route": "cuda",
         "source": src + "window_kernel.cu",
         "replaces": "mcmc_ammsb_tpu/ops/window.py:321 (n_chains > 1)",
         "launches": chain_l["window_chain"], "max_abs_err": c_err,
         **times(c_t),
         # ShardedChainLearner, G = 1, C = 4, 1008 steps
         "sharded_launches": shard["chains"]["window_chain"],
         **bf16_fields("window_kernel_chains", "chains"),
         "bench_launches": bench_launches("window_chain")},
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
        # the held-out evaluation: replaces no Pallas kernel (the JAX
        # package leaves it to XLA); one launch pair per evaluation, the
        # main path's evaluations counted, times at the three cells'
        # shapes
        {"name": "ppx_kernel", "route": "cuda",
         "source": src + "ppx_kernel.cu",
         "replaces": "none (mcmc_ammsb_tpu/ops/perplexity.py:56-99 is "
                     "plain jnp)",
         "launches": main_l["ppx"],
         "cells": {cell: {"ms": t[0], "plain_ms": t[1], "bound_ms": t[2],
                          "bound_by": t[3], "max_rel_gap": t[4],
                          "neg_avg_log_rel_gap": t[5]}
                   for cell, t in ppx_k.items()}},
        # the reference RNG: streams split across a warp or a block (the
        # Gamma draws: one thread per stream), a chunk per launch;
        # launches are the --rng reference run's (400 steps, chunks of 200:
        # the phi and theta noise and the neighbors of each chunk, the
        # theta and pi init)
        {"name": "ref_rng_randn_lanes", "route": "cuda",
         "source": src + "ref_rng_kernel.cu",
         "replaces": "mcmc_ammsb_tpu/rng/refblock.py:144,291 (no "
                     "pallas_call)",
         "launches": ref_l["--rng reference"]["randn"],
         **ref_times("randn_lanes"), **theta_fields},
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
