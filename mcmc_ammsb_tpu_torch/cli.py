"""Command-line driver of the port (counterpart of
``mcmc_ammsb_tpu/cli.py``: the single-chain a-MMSB, device-sampled or
host-sampled, with ``--phi-impl jnp`` or ``pallas``, the full MMSB,
``--model mmsb``, also host-sampled, and C independent chains of
either model, ``--num-chains C``: the flat a-MMSB chain engine, the MMSB
chain engine, or with ``--chain-engine vmap`` C whole single-chain
states, the slow cross-check; on several GPUs ``--mesh D,M``, the
row-sharded learner, ``--num-chains C --chain-devices G``, chains spread
over G GPUs, and ``--partitioned-ingest``, each process parsing its byte
range of ``--file``). ``--checkpoint`` saves the run at exit,
after SIGINT and every ``--checkpoint-interval`` steps (one npz file, or
with ``--checkpoint-backend orbax`` a DCP directory, saved
asynchronously at the intervals), ``--restore`` resumes it;
``--checkpoint-ref`` also writes the state in the reference binary's
format at the end and ``--restore-ref`` imports such a file;
``--pi-dtype bfloat16`` stores pi in bf16 (the a-MMSB engines);
``--dump-data`` / ``--load-data`` write and read the dataset cache.

The same flag names, ``resolve_fast_defaults`` semantics and log lines
(config echo, ``ppx[i] = ...`` with the link/non-link quadruple, the
stats table) as the JAX CLI; SIGINT drains the loop. ``--device cuda``
(the default) runs on the GPU and fails when there is none — it never
falls back to the CPU. Every flag of the JAX CLI is taken; a combination
the JAX CLI refuses exits 1 with its message.

Multi-GPU runs are one process per GPU (``parallel/``): started by
``torchrun --nproc-per-node G -m mcmc_ammsb_tpu_torch.cli --mesh D,M ...``
or by ``--coordinator HOST:PORT --num-processes P --process-id I`` in
each process; a lone process with ``--mesh 1,1`` starts a group of size
1 itself. The ranks run NCCL on cards, gloo with ``--device cpu``; only
rank 0 logs the ppx series and the stats.

Usage:
    python -m mcmc_ammsb_tpu_torch.cli --synthetic 317080,7 -k 256 \\
        -x 2000 -i 500 --device cuda
    python -m mcmc_ammsb_tpu_torch.cli --phi-impl pallas \\
        --synthetic 317080,7 -k 256 -x 1000 -i 500
    python -m mcmc_ammsb_tpu_torch.cli --no-device-sampling \\
        --no-shared-neighbors --steps-per-call 1 --phi-impl pallas \\
        --synthetic 317080,7 -k 256 -x 300 -i 100
    python -m mcmc_ammsb_tpu_torch.cli --no-device-sampling -s BFLink \\
        --synthetic 317080,7 -k 256 -x 400 -i 200
    python -m mcmc_ammsb_tpu_torch.cli --synthetic-powerlaw \\
        317080,6.6,343,256 --edgeset perfect --ds-link-cap 64 -k 256 \\
        -x 1000 -i 500
    python -m mcmc_ammsb_tpu_torch.cli --phi-impl pallas --device-sampling \\
        --synthetic 317080,7 -k 256 -x 1000 -i 500 --device cuda
    python -m mcmc_ammsb_tpu_torch.cli --model mmsb --window 12 \\
        --synthetic 317080,7 -k 64 -x 1000 -i 500 --device cuda
    python -m mcmc_ammsb_tpu_torch.cli --num-chains 16 --node-coin \\
        alternate --synthetic 317080,7 -k 256 -x 1008 -i 504 --device cuda
    python -m mcmc_ammsb_tpu_torch.cli --model mmsb --num-chains 4 \\
        --synthetic 317080,7 -k 64 -x 1000 -i 500 --device cuda
    python -m mcmc_ammsb_tpu_torch.cli --synthetic 317080,7 -k 256 \\
        -x 1000 -i 500 --checkpoint run.npz --checkpoint-interval 500
    python -m mcmc_ammsb_tpu_torch.cli --synthetic 317080,7 -k 256 \\
        -x 1000 -i 500 --restore run.npz --checkpoint run.npz
    python -m mcmc_ammsb_tpu_torch.cli --synthetic 317080,7 --dump-data \\
        --dump-file graph.npz [--cache-format ref]
    python -m mcmc_ammsb_tpu_torch.cli --load-data --load-file graph.npz \\
        -k 256 -x 1000 -i 500
    torchrun --nproc-per-node 4 -m mcmc_ammsb_tpu_torch.cli --mesh 2,2 \\
        --synthetic 317080,7 -k 256 -x 1000 -i 500
    torchrun --nproc-per-node 4 -m mcmc_ammsb_tpu_torch.cli --num-chains 16 \\
        --chain-devices 4 --synthetic 317080,7 -k 256 -x 1008 -i 504
    python -m mcmc_ammsb_tpu_torch.cli --partitioned-ingest --file graph.txt \\
        --mesh 1,1 -k 256 -x 1000 -i 500
    python -m mcmc_ammsb_tpu_torch.cli --synthetic 317080,7 -k 256 \\
        -x 2000 -i 500 --pi-dtype bfloat16
    python -m mcmc_ammsb_tpu_torch.cli --synthetic 317080,7 -k 256 \\
        -x 1000 -i 500 --checkpoint run.ckpt --checkpoint-backend orbax \\
        --checkpoint-interval 500 --checkpoint-ref run.ref
    python -m mcmc_ammsb_tpu_torch.cli --synthetic 317080,7 -k 256 \\
        -x 1000 -i 500 --restore-ref run.ref
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from mcmc_ammsb_tpu_torch.chains import MultiChainLearner
from mcmc_ammsb_tpu_torch.chains_flat import FlatChainLearner
from mcmc_ammsb_tpu_torch import refckpt
from mcmc_ammsb_tpu_torch.checkpoint import (load_checkpoint, save_checkpoint,
                                             wait_for_async_saves)
from mcmc_ammsb_tpu_torch.config import (Config, EdgeSetBackend, PhiImpl,
                                         RngBackend, SampleStrategy)
from mcmc_ammsb_tpu_torch.data import (Graph, dump_dataset, generate_sets,
                                       load_dataset, load_snap_edges,
                                       synthetic_edges,
                                       synthetic_powerlaw_edges)
from mcmc_ammsb_tpu_torch.learner import Learner
from mcmc_ammsb_tpu_torch.models.mmsb import (FullMMSBLearner,
                                              MMSBChainLearner)
from mcmc_ammsb_tpu_torch.ops.window import window_plan
from mcmc_ammsb_tpu_torch.parallel import multihost
from mcmc_ammsb_tpu_torch.parallel.chains_sharded import (ShardedChainLearner,
                                                          make_chain_mesh)
from mcmc_ammsb_tpu_torch.parallel.mesh import make_mesh, rank_device
from mcmc_ammsb_tpu_torch.parallel.partitioned import partitioned_ingest
from mcmc_ammsb_tpu_torch.parallel.sharded import ShardedLearner

log = logging.getLogger("mcmc_ammsb_tpu_torch")


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mcmc_ammsb_tpu_torch",
        description="a-MMSB SG-MCMC sampler, PyTorch + CUDA port")
    p.add_argument("--file", "-f", help="graph data file (SNAP edge list)")
    p.add_argument("--synthetic", type=str, default=None,
                   metavar="N,AVG_DEG",
                   help="use a synthetic random graph instead of --file")
    p.add_argument("--synthetic-powerlaw", type=str, default=None,
                   metavar="N,AVG_DEG[,MAX_DEG[,COMMUNITIES]]",
                   help="use a heavy-tailed (Chung-Lu degree-corrected "
                        "planted-partition) synthetic graph, the "
                        "degree-realistic surrogate for SNAP graphs "
                        "(com-DBLP ~ 317080,6.6,343,256; "
                        "com-LiveJournal ~ 3997962,17.35,14815,5000). "
                        "Pair with --ds-link-cap on hubby graphs")
    p.add_argument("--heldout-ratio", "-r", type=float, default=0.01)
    p.add_argument("--alpha", type=float, default=0.0)
    p.add_argument("-a", dest="a", type=float, default=0.0315)
    p.add_argument("-b", dest="b", type=float, default=1024.0)
    p.add_argument("-c", dest="c", type=float, default=0.5)
    p.add_argument("--epsilon", "-e", type=float, default=1e-7)
    p.add_argument("--eta0", type=float, default=1.0)
    p.add_argument("--eta1", type=float, default=1.0)
    p.add_argument("-k", dest="K", type=int, default=32)
    p.add_argument("--mini_batch", "-m", type=int, default=32)
    p.add_argument("--neighbors", "-n", type=int, default=32)
    p.add_argument("--ppx-interval", "-i", type=int, default=100)
    p.add_argument("--max-iters", "-x", type=int, default=100)
    p.add_argument("--sample", "-s", default="Node",
                   help="Node|NodeLink|NodeNonLink|BF|BFLink|BFNonLink")
    p.add_argument("--phi-seed", type=int, nargs=2, default=(42, 43))
    p.add_argument("--beta-seed", type=int, nargs=2, default=(44, 45))
    p.add_argument("--neighbor-seed", type=int, nargs=2, default=(56, 57))
    p.add_argument("--phi-impl", choices=[m.value for m in PhiImpl],
                   default=PhiImpl.JNP.value)
    p.add_argument("--edgeset", choices=[m.value for m in EdgeSetBackend],
                   default=EdgeSetBackend.AUTO.value)
    p.add_argument("--rng", choices=[m.value for m in RngBackend],
                   default=RngBackend.NATIVE.value,
                   help="native = torch generators; reference = the "
                        "reference's bit-exact xorshift128+ streams "
                        "(rng/reference.py; host-sampled by default)")
    p.add_argument("--no-ref-rng-block", dest="ref_rng_block",
                   action="store_false", default=True,
                   help="with --rng reference: draw with the plain "
                        "PyTorch version (rng/reference.py) instead of the "
                        "kernel (csrc/ref_rng_kernel.cu); the same bits")
    p.add_argument("--theta-init", choices=["native", "libstdc++"],
                   default="native",
                   help="theta init stream: libstdc++ reproduces the "
                        "reference's std::mt19937 + "
                        "std::gamma_distribution host stream through the "
                        "native library")
    p.add_argument("--pi-dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="storage of the pi rows; bfloat16 halves pi's "
                        "device memory, compute stays float32 (the "
                        "a-MMSB engines: single-GPU, flat chains, --mesh "
                        "and --chain-devices)")
    p.add_argument("--calc-train-ppx", action="store_true",
                   help="also log the training perplexity at every "
                        "evaluation (train_ppx[i]; the a-MMSB learner)")
    p.add_argument("--train-ppx-ratio", type=float, default=0.01)
    p.add_argument("--phi-disable-noise", action="store_true",
                   help="golden-test mode: the phi noise operand is ones")
    p.add_argument("--steps-per-call", type=int, default=0,
                   help="steps per chunk; 0 = auto (1000 with device "
                        "sampling, min(200, ppx interval) with host "
                        "sampling); 1 host-sampled = one step at a time")
    p.add_argument("--device-sampling",
                   action=argparse.BooleanOptionalAction, default=None,
                   help="sample minibatches on the device (default: on "
                        "for the Node family with the native RNG and the "
                        "jnp phi; --no-device-sampling samples on the "
                        "host, prefetched by a producer thread)")
    p.add_argument("--shared-neighbors",
                   action=argparse.BooleanOptionalAction, default=None,
                   help="one shared n-neighbor draw per step (default: "
                        "on with device sampling on the jnp fast path; "
                        "--no-shared-neighbors draws n neighbors per node)")
    p.add_argument("--window", type=int, default=0,
                   help="T-step window engine (one gather, one CUDA "
                        "kernel launch, one scatter per window); 0 = auto "
                        "[12 on the fast path], -1 = off")
    p.add_argument("--window-impl", choices=["pallas", "jnp"],
                   default="pallas",
                   help="pallas = the window kernel (CUDA); jnp = the "
                        "golden twin: the plain PyTorch version of the "
                        "window on whatever device the run is on")
    p.add_argument("--node-coin", choices=["random", "alternate"],
                   default="random")
    p.add_argument("--ds-link-rounds", type=int, default=2)
    p.add_argument("--ds-nonlink-rounds", type=int, default=1)
    p.add_argument("--ds-link-cap", type=int, default=0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="compute device; cuda fails when no GPU is "
                        "present (no silent CPU fallback)")
    p.add_argument("--model", choices=["ammsb", "mmsb"], default="ammsb",
                   help="model family: 'ammsb' = the assortative MMSB "
                        "(diagonal beta + epsilon background); 'mmsb' = "
                        "full [K,K] block matrix (models/mmsb.py)")
    p.add_argument("--mmsb-prior-diag", type=float, nargs=2, default=None,
                   metavar=("ETA0", "ETA1"),
                   help="full-MMSB: per-cell prior for DIAGONAL theta_B "
                        "cells (assortative regularization)")
    p.add_argument("--mmsb-noise-scale", type=float, default=1.0,
                   help="full-MMSB: SGRLD noise temperature (<1 tempers)")
    p.add_argument("--num-chains", type=int, default=1,
                   help="run C independent chains (a-MMSB: the flat chain "
                        "engine, chains_flat.py; --model mmsb: "
                        "MMSBChainLearner; implies device sampling)")
    p.add_argument("--chain-engine", choices=["flat", "vmap"],
                   default="flat",
                   help="a-MMSB multi-chain engine: 'flat' = one shared "
                        "row space (fast); 'vmap' = C whole single-chain "
                        "states advanced in turn (slow; a cross-check)")
    p.add_argument("--rhat-draws", type=int, default=0,
                   help="with --num-chains >= 2: after training, run this "
                        "many extra steps_per_call chunks keeping beta "
                        "after each and log the Gelman-Rubin R-hat across "
                        "chains (>= 2 draws; 0 = off)")
    p.add_argument("--chain-devices", type=int, default=1,
                   help="spread --num-chains over this many GPUs, one "
                        "process each (a-MMSB flat chains; "
                        "parallel/chains_sharded.py)")
    # dataset cache
    p.add_argument("--dump-data", action="store_true",
                   help="write the loaded graph to --dump-file and exit")
    p.add_argument("--dump-file", type=str, default="")
    p.add_argument("--load-data", action="store_true",
                   help="read the graph (and its held-out ratio) from "
                        "--load-file")
    p.add_argument("--load-file", type=str, default="")
    p.add_argument("--cache-format", choices=["npz", "ref"], default="npz",
                   help="dump format: npz (native) or ref, the "
                        "reference's gzip binary layout (loading detects "
                        "either)")
    # checkpointing
    p.add_argument("--checkpoint", type=str, default="",
                   help="save a checkpoint here at exit / SIGINT")
    p.add_argument("--checkpoint-interval", type=int, default=0,
                   metavar="ITERS",
                   help="also checkpoint every ITERS training steps "
                        "(rounded up to eval-loop boundaries); with "
                        "--checkpoint-backend orbax the save is "
                        "asynchronous: training resumes once the state "
                        "is copied off the live tensors")
    p.add_argument("--checkpoint-backend", choices=["npz", "orbax"],
                   default="npz",
                   help="npz = one file; orbax (the JAX CLI's name) = a "
                        "torch.distributed.checkpoint directory, each rank "
                        "of a sharded run writing its own rows. The port "
                        "and the JAX package read each other's npz files, "
                        "not each other's directories")
    p.add_argument("--restore", type=str, default="",
                   help="restore a checkpoint before training (a file is "
                        "npz, a directory the orbax backend's)")
    p.add_argument("--restore-ref", type=str, default="",
                   help="import a checkpoint written by the REFERENCE "
                        "binary (its length-prefixed protobuf stream) as "
                        "the initial state; match its "
                        "MCMC_CALC_TRAIN_PPX layout with --calc-train-ppx. "
                        "The single-GPU a-MMSB engine only")
    p.add_argument("--checkpoint-ref", type=str, default="",
                   help="at the end of training, also write the state in "
                        "the reference binary's checkpoint format (buffers "
                        "sized to its allocation laws, in-flight Sample "
                        "sections included; refckpt.ReferenceLayout)")
    p.add_argument("--ref-rows-in-block", type=int, default=0,
                   help="rows_in_block of the exported pi row blocks: the "
                        "reference rejects any value but the target "
                        "device's RowsPerBlock; 0 = the CUDA build's "
                        "512 MiB / (K * 4)")
    p.add_argument("--auto-tune-window", action="store_true",
                   help="probe candidate window sizes on the device before "
                        "training and keep the fastest (autotune.py)")
    p.add_argument("--profile", action="store_true",
                   help="print the per-stage table at exit: the device "
                        "time of a traced chunk by stage "
                        "(utils/profiling.py)")
    # multi-GPU execution (parallel/): one process per GPU
    p.add_argument("--mesh", type=str, default="", metavar="DATA,MODEL",
                   help="train on several GPUs: shard pi rows over MODEL "
                        "ranks and the minibatch over DATA ranks of a "
                        "(DATA, MODEL) mesh of DATA*MODEL processes")
    p.add_argument("--coordinator", type=str, default="",
                   metavar="HOST:PORT",
                   help="torch.distributed rendezvous address (process "
                        "0's host); required with --num-processes > 1 "
                        "(torchrun sets its own)")
    p.add_argument("--num-processes", type=int, default=0,
                   help="total process count (0/1 = single-process, or "
                        "torchrun's)")
    p.add_argument("--process-id", type=int, default=0,
                   help="this process's rank")
    p.add_argument("--partitioned-ingest", action="store_true",
                   help="multi-process capacity mode: each process parses "
                        "only its byte range of --file, edges are "
                        "exchanged to their owning model shards, and both "
                        "E-sized device structures (membership set, "
                        "sampling adjacency) are sharded over the mesh's "
                        "model ranks. Requires --mesh and device sampling; "
                        "the held-out split is the hash rule "
                        "(parallel/partitioned.py)")
    p.add_argument("--split-seed", type=int, default=12345,
                   help="seed of the held-out split (the hash rule under "
                        "--partitioned-ingest; generate_sets' shuffle "
                        "otherwise uses its own default)")
    return p


_NODE_FAMILY = (SampleStrategy.NODE, SampleStrategy.NODE_LINK,
                SampleStrategy.NODE_NON_LINK)
_BF_FAMILY = (SampleStrategy.BF, SampleStrategy.BF_LINK,
              SampleStrategy.BF_NON_LINK)


def resolve_fast_defaults(args) -> None:
    """Resolve auto flags to the fast path (in place), by the JAX CLI's
    rule (mcmc_ammsb_tpu/cli.py:297-375): device sampling + shared
    neighbor draws + 1000-step chunks whenever the configuration supports
    them, host sampling with private draws and chunks of min(200, ppx
    interval) otherwise (so for --phi-impl pallas and --rng reference),
    and T-step windows for the a-MMSB only (an MMSB run windows only with
    an explicit --window N). The breadth-first family is device-sampled
    too (the exact host-FIFO replay), with private draws and no windows.
    The reference-exact slow path stays reachable:
    --no-device-sampling --no-shared-neighbors --steps-per-call 1."""
    strategy = SampleStrategy.parse(args.sample)
    native_jnp = (args.rng == RngBackend.NATIVE.value
                  and args.phi_impl == PhiImpl.JNP.value)
    fast_ok = strategy in _NODE_FAMILY and native_jnp
    bf_ok = strategy in _BF_FAMILY and native_jnp
    if args.device_sampling is None:
        args.device_sampling = fast_ok or bf_ok
        if fast_ok:
            log.info("device sampling auto-enabled (Node-family strategy, "
                     "native RNG); --no-device-sampling restores host "
                     "sampling")
        elif bf_ok:
            log.info("device sampling auto-enabled (breadth-first family, "
                     "exact host-FIFO replay); --no-device-sampling "
                     "restores host sampling")
    if args.shared_neighbors is None:
        args.shared_neighbors = fast_ok and bool(args.device_sampling)
    if args.steps_per_call <= 0:
        args.steps_per_call = (max(1000, args.ppx_interval)
                               if args.device_sampling
                               else max(1, min(200, args.ppx_interval)))
        log.info("steps_per_call auto-set to %d", args.steps_per_call)
    # chains: T = 12 up to 8 chains, 96 // C up to 16, none past 16 or
    # on the vmap engine
    c = max(1, args.num_chains)
    if (args.window == 0 and args.device_sampling
            and args.shared_neighbors and args.model == "ammsb"
            and not (c > 1 and args.chain_engine != "flat")):
        if c <= 8:
            args.window = 12
        elif c <= 16:
            args.window = 96 // c
        if args.window:
            args.window_auto = True
            log.info("window auto-set to %d (T-step fused windows; "
                     "--window -1 disables)", args.window)
    if args.window < 0:
        args.window = 0


#: The automatic window's fallbacks, largest first, when the window
#: kernel's rule refuses its T (the JAX CLI's, ops/window.max_safe_window).
WINDOW_CLAMP = (12, 8, 6, 4, 3, 2)


def fit_window(t_win: int, auto: bool, b_cap: int, n_smpl: int, e_cap: int,
               k: int, smem_limit: int) -> int:
    """The window size a run on the card takes, by the rule the kernel's
    launch itself goes by (``ops/window.window_plan`` at ``smem_limit``
    bytes of shared memory per block, for one chain's (B, n, E, K)):
    ``t_win`` where the plan admits it; else, for an automatic T
    (``auto``), the largest smaller one of WINDOW_CLAMP that it admits,
    or 0 (no windows) when none; for an explicit T the plan's
    ValueError. The pi storage type does not enter: both share the
    layout."""
    try:
        window_plan(t_win, b_cap, n_smpl, e_cap, k, smem_limit)
        return t_win
    except ValueError:
        if not auto:
            raise
    for t in WINDOW_CLAMP:
        if t < t_win:
            try:
                window_plan(t, b_cap, n_smpl, e_cap, k, smem_limit)
                return t
            except ValueError:
                continue
    return 0


def kernel_smem_limit(device):
    """Shared memory per block of the card the window kernel runs on
    (``kernels.smem_limit``), or None on the CPU, whose plain window runs
    any T."""
    if device.type != "cuda":
        return None
    from mcmc_ammsb_tpu_torch import kernels
    return kernels.smem_limit(device)


def resolve_kernel_window(args, cfg: Config, device) -> Config:
    """``cfg`` with its window checked against the window kernel's rule
    before any learner is made, where the kernel runs: a card
    (``kernel_smem_limit``), T > 1, the a-MMSB on an engine that
    launches it (one GPU, the flat chains, --chain-devices, --mesh),
    --window-impl pallas. An automatic T that does not fit is clamped and
    logged (the JAX CLI's ``window auto-clamped``); an explicit one
    raises ValueError. The shape is one chain's (never C); --mesh pads
    the batch to a multiple of its data ranks, as ShardedLearner does."""
    limit = kernel_smem_limit(device)
    if (limit is None or cfg.window <= 1 or args.model != "ammsb"
            or cfg.window_impl != "pallas"
            or (args.num_chains > 1 and args.chain_engine != "flat")):
        return cfg
    b_cap, e_cap = cfg.max_batch_nodes, cfg.max_batch_edges
    if args.mesh:
        d = int(args.mesh.split(",")[0])
        b_cap, e_cap = -(-b_cap // d) * d, -(-e_cap // d) * d
    t_win = fit_window(cfg.window, getattr(args, "window_auto", False),
                       b_cap, cfg.num_node_sample, e_cap, cfg.K, limit)
    if t_win != cfg.window:
        log.info("window auto-clamped %d -> %d (window kernel's shared "
                 "memory, %d B per block, at K=%d, B=%d, n=%d, E=%d)",
                 cfg.window, t_win, limit, cfg.K, b_cap,
                 cfg.num_node_sample, e_cap)
        cfg = cfg.replace(window=t_win)
    return cfg


def config_from_args(args) -> Config:
    return Config(
        K=args.K, alpha=args.alpha, a=args.a, b=args.b, c=args.c,
        epsilon=args.epsilon, eta0=args.eta0, eta1=args.eta1,
        mini_batch_size=args.mini_batch, num_node_sample=args.neighbors,
        strategy=SampleStrategy.parse(args.sample),
        heldout_ratio=args.heldout_ratio,
        calc_train_ppx=args.calc_train_ppx,
        training_ppx_ratio=args.train_ppx_ratio,
        phi_disable_noise=args.phi_disable_noise,
        window_impl=args.window_impl,
        device_sampling=args.device_sampling,
        shared_neighbors=args.shared_neighbors,
        ppx_interval=args.ppx_interval,
        phi_seed=tuple(args.phi_seed), beta_seed=tuple(args.beta_seed),
        neighbor_seed=tuple(args.neighbor_seed),
        phi_impl=PhiImpl(args.phi_impl),
        edgeset_backend=EdgeSetBackend(args.edgeset),
        rng_backend=RngBackend(args.rng),
        ref_rng_block=args.ref_rng_block,
        theta_init=args.theta_init,
        pi_dtype=args.pi_dtype,
        steps_per_call=args.steps_per_call,
        window=args.window,
        node_coin=args.node_coin,
        ds_link_rounds=args.ds_link_rounds,
        ds_nonlink_rounds=args.ds_nonlink_rounds,
        ds_link_cap=args.ds_link_cap,
        mmsb_prior_diag=(tuple(args.mmsb_prior_diag)
                         if args.mmsb_prior_diag else None),
        mmsb_noise_scale=args.mmsb_noise_scale,
    )


def make_learner(args, cfg: Config, graph, split, device):
    """The learner of the engine the flags select, on ``device``, in the
    JAX CLI's order: chains (over several GPUs with --chain-devices),
    then the model, then --mesh. A mesh or chain mesh larger than the
    world raises ValueError with the JAX package's wording."""
    if args.num_chains > 1 and args.chain_devices > 1:
        if args.chain_engine != "flat":
            raise ValueError("--chain-devices requires the flat engine")
        mesh = make_chain_mesh(args.chain_devices, device)
        if args.model == "mmsb":
            raise ValueError("--chain-devices spreads the a-MMSB flat "
                             "chain engine; --model mmsb chains run on one "
                             "GPU")
        learner = ShardedChainLearner(cfg, graph, split, args.num_chains,
                                      mesh)
        log.info("%d chains over %d GPUs (%d per rank), this rank's "
                 "initialized in %.3f s", args.num_chains,
                 args.chain_devices, learner.chains_per_group,
                 learner.init_seconds)
        return learner
    if args.num_chains > 1 and args.model == "mmsb":
        return MMSBChainLearner(cfg, graph, split, args.num_chains, device)
    if args.num_chains > 1 and args.chain_engine != "flat":
        return MultiChainLearner(cfg, graph, split, args.num_chains, device)
    if args.num_chains > 1:
        learner = FlatChainLearner(cfg, graph, split, args.num_chains, device)
        log.info("%d chains initialized in %.3f s (init draws of "
                 "C x N x K gammas on the device)", args.num_chains,
                 learner.init_seconds)
        return learner
    if args.model == "mmsb":
        if args.mesh:
            raise ValueError("--model mmsb is single-GPU (use --num-chains "
                             "for parallelism)")
        return FullMMSBLearner(cfg, graph, split, device)
    if args.mesh:
        return ShardedLearner(cfg, graph, split, _mesh(args, device))
    return Learner(cfg, graph, split, device)


def _mesh(args, device):
    """The (DATA, MODEL) mesh of ``--mesh``."""
    n_data, n_model = (int(x) for x in args.mesh.split(","))
    mesh = make_mesh(n_data, n_model, device=device)
    log.info("mesh: data=%d model=%d (pi rows sharded %d-way)", n_data,
             n_model, n_model)
    return mesh


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(levelname).1s %(asctime)s %(name)s] %(message)s",
        stream=sys.stderr)
    args = build_arg_parser().parse_args(argv)
    log.info(" ".join(sys.argv if argv is None else argv))
    if args.restore_ref and (args.num_chains > 1 or args.model == "mmsb"
                             or args.mesh):
        log.fatal("--restore-ref imports the reference's single-GPU "
                  "state; use the single-chip a-MMSB engine")
        return 1
    if args.rhat_draws and (args.rhat_draws < 2 or args.num_chains < 2
                            or args.model == "mmsb"):
        log.fatal("--rhat-draws needs >= 2 draws and --num-chains >= 2 "
                  "a-MMSB chains (R-hat is a between-chain statistic)")
        return 1
    if args.checkpoint_ref and (args.num_chains > 1 or args.model == "mmsb"):
        log.fatal("--checkpoint-ref exports the a-MMSB single-model state "
                  "the reference binary can read (chains/mmsb have no "
                  "reference-format counterpart)")
        return 1
    chains = args.num_chains > 1
    resolve_fast_defaults(args)
    cfg = config_from_args(args)
    if chains:
        cfg = cfg.replace(device_sampling=True)  # as the JAX chain engine

    if args.device == "cuda" and not torch.cuda.is_available():
        log.fatal("--device cuda: no CUDA device is available (pass "
                  "--device cpu to run on the CPU)")
        return 1
    distributed = bool(args.mesh or args.partitioned_ingest
                       or (chains and args.chain_devices > 1)
                       or args.num_processes > 1)
    owns_group = False
    level = log.level
    try:
        if distributed:
            # the backend follows --device (NCCL on a card, gloo on the
            # CPU); a failure to start it ends the run
            owns_group = multihost.initialize(
                args.coordinator or None, args.num_processes or None,
                args.process_id, args.device)
            log.info("torch.distributed: rank %d of %d (%s)",
                     dist.get_rank(), dist.get_world_size(),
                     dist.get_backend())
            if dist.get_rank() != 0:
                log.setLevel(logging.WARNING)   # rank 0 logs the run
        device = (rank_device(args.device) if distributed
                  else torch.device(args.device))
        log.info("torch %s on %s", torch.__version__,
                 torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu")
        if args.partitioned_ingest:
            return _main_partitioned(args, device)
        return _main(args, cfg, chains, device)
    finally:
        log.setLevel(level)
        if owns_group:
            dist.destroy_process_group()


def _main(args, cfg: Config, chains: bool, device) -> int:
    """The run after the device and the process group are set up."""

    # --- dataset ----------------------------------------------------------
    if args.load_data:
        if not args.load_file:
            log.fatal("load-file is required with load-data")
            return 1
        n, ratio, u, v = load_dataset(args.load_file)
        args.heldout_ratio = ratio
        cfg = cfg.replace(heldout_ratio=ratio)
    elif args.synthetic:
        nn, deg = (int(x) for x in args.synthetic.split(","))
        n, u, v = synthetic_edges(nn, deg, seed=1)
    elif args.synthetic_powerlaw:
        parts = args.synthetic_powerlaw.split(",")
        n, u, v = synthetic_powerlaw_edges(
            int(parts[0]), float(parts[1]),
            max_degree=int(parts[2]) if len(parts) > 2 else None,
            num_communities=int(parts[3]) if len(parts) > 3 else 0, seed=1)
    elif args.file:
        n, u, v = load_snap_edges(args.file)
    else:
        log.fatal("one of --file / --synthetic / --synthetic-powerlaw / "
                  "--load-data is required")
        return 1
    if args.dump_data:
        if not args.dump_file:
            log.fatal("dump-file is required with dump-data")
            return 1
        dump_dataset(args.dump_file, n, args.heldout_ratio, u, v,
                     fmt=args.cache_format)
        log.info("dataset cache (%s) written to %s", args.cache_format,
                 args.dump_file)
        return 0
    split = generate_sets(n, u, v, args.heldout_ratio)
    graph = Graph.from_edges(n, split.training_u, split.training_v)
    cfg = cfg.finalize(n, split.total_edges, graph.max_fan_out)
    if getattr(args, "window_auto", False) and cfg.max_batch_nodes > 64:
        # hub-degree-padded batches: the correction scales with T*B
        log.info("window auto-disabled: max_batch_nodes=%d > 64",
                 cfg.max_batch_nodes)
        cfg = cfg.replace(window=0)
    try:
        cfg = resolve_kernel_window(args, cfg, device)
    except ValueError as e:
        log.fatal("--window %d: %s", cfg.window, e)
        return 1
    if args.auto_tune_window:
        cfg = _auto_tune_window(args, cfg, graph, split, device)
    log.info("Loaded %s (N=%d, E=%d, training max fan out = %d)",
             args.load_file or args.file or args.synthetic
             or args.synthetic_powerlaw, cfg.N, cfg.E, cfg.max_fan_out)
    log.info("config: %s", cfg)
    try:
        learner = make_learner(args, cfg, graph, split, device)
    except ValueError as e:           # the learner's config guards
        log.fatal("%s", e)
        return 1

    log.info("edge sets: training %s, held-out %s",
             learner.training_set.backend, learner.heldout_set.backend)
    if cfg.rng_backend == RngBackend.REFERENCE:
        plain = device.type != "cuda" or not cfg.ref_rng_block
        log.info("reference RNG: %s (--rng reference%s on %s)",
                 "the plain PyTorch version (rng/reference.py)" if plain
                 else "the kernel (csrc/ref_rng_kernel.cu)",
                 "" if cfg.ref_rng_block else " --no-ref-rng-block",
                 device.type)
    if cfg.window > 1 and args.model == "ammsb":
        plain = device.type != "cuda" or cfg.window_impl == "jnp"
        log.info("windows of %d steps run %s (--window-impl %s on %s)",
                 cfg.window, "the plain PyTorch version of the window"
                 if plain else "the window kernel", cfg.window_impl,
                 device.type)
    if args.restore:
        try:
            load_checkpoint(args.restore, learner)
        except ValueError as e:
            log.fatal("--restore %s: %s", args.restore, e)
            learner.close()
            return 1
        log.info("restored checkpoint %s (step=%d)", args.restore,
                 learner.step_count)
    if args.restore_ref:
        _import_reference(args, cfg, learner, split)
    if learner.sampler is not None:
        # single batches (steps_per_call 1) are always numpy-sampled
        chunked = cfg.steps_per_call > 1
        log.info("host sampler: %s (host_sampler=%s, %s), prefetch %s",
                 "native C++" if learner.sampler.use_native and chunked
                 else "numpy", cfg.host_sampler,
                 f"chunks of {cfg.steps_per_call}" if chunked
                 else "one batch at a time",
                 "on" if learner._use_prefetch else "off")

    # --- SIGINT drain -----------------------------------------------------
    signaled = {"flag": False}

    def handler(_sig, _frm):
        signaled["flag"] = True

    previous = signal.signal(signal.SIGINT, handler)
    try:
        _train(args, cfg, learner, signaled)
        if args.checkpoint:       # at exit, and after SIGINT
            save_checkpoint(args.checkpoint, learner,
                            backend=args.checkpoint_backend)
            log.info("checkpoint saved to %s", args.checkpoint)
        wait_for_async_saves()
        if args.checkpoint_ref:
            refckpt.export_learner(args.checkpoint_ref, learner, graph,
                                   split,
                                   rows_in_block=args.ref_rows_in_block)
            log.info("reference-format checkpoint saved to %s (step=%d)",
                     args.checkpoint_ref, learner.step_count)
    finally:
        signal.signal(signal.SIGINT, previous)
        learner.close()
    return 0


def _import_reference(args, cfg: Config, learner, split) -> None:
    """--restore-ref: the reference binary's checkpoint becomes the
    learner's state (the JAX CLI's path); with another held-out
    population the running averages restart."""
    raw = refckpt.read_reference_checkpoint(
        args.restore_ref, with_train_ppx=cfg.calc_train_ppx)
    h = len(split.heldout_edges_u)
    if len(raw["ppx_per_edge"]) != h:
        # another held-out population (e.g. another split seed): the
        # model state still imports
        log.warning("reference checkpoint held-out size %d != %d here; "
                    "ppx running averages restart",
                    len(raw["ppx_per_edge"]), h)
        raw = dict(raw, ppx_per_edge=np.zeros(h, np.float32), ppx_count=0)
    learner.state = refckpt.to_train_state(cfg, raw, h, learner.device,
                                           state=learner.state)
    log.info("imported reference checkpoint %s (step=%d)", args.restore_ref,
             learner.step_count)


def _main_partitioned(args, device) -> int:
    """--partitioned-ingest (the JAX CLI's ``_main_partitioned``): every
    process parses its byte range of --file, the edges go to their model
    shards, and ``ShardedLearner.from_partitioned`` trains on the sharded
    CSR. Every rank runs the same loop; rank 0 logs it."""
    if not args.file:
        log.fatal("--partitioned-ingest requires --file (SNAP edge list; "
                  "byte-range split across processes)")
        return 1
    if not args.mesh:
        log.fatal("--partitioned-ingest requires --mesh DATA,MODEL")
        return 1
    if not args.device_sampling:
        log.fatal("--partitioned-ingest requires device sampling (no "
                  "process holds the host graph)")
        return 1
    try:
        mesh = _mesh(args, device)
    except ValueError as e:
        log.fatal("%s", e)
        return 1
    t0 = time.perf_counter()
    pdata = partitioned_ingest(mesh, heldout_ratio=args.heldout_ratio,
                               seed=args.split_seed, path=args.file)
    log.info("partitioned ingest in %.3f s: N=%d E=%d max_fan_out=%d; this "
             "process parsed %d edges, largest shard holds %d (full graph "
             "never materialized)", time.perf_counter() - t0,
             pdata.num_nodes, pdata.num_edges, pdata.max_fan_out,
             pdata.local_parse_edges, pdata.max_shard_edges)
    cfg = config_from_args(args).finalize(pdata.num_nodes, pdata.num_edges,
                                          pdata.max_fan_out)
    try:
        cfg = resolve_kernel_window(args, cfg, device)
    except ValueError as e:
        log.fatal("--window %d: %s", cfg.window, e)
        return 1
    log.info("config: %s", cfg)
    try:
        learner = ShardedLearner.from_partitioned(cfg, pdata, mesh)
    except ValueError as e:
        log.fatal("%s", e)
        return 1
    if args.restore:
        try:
            load_checkpoint(args.restore, learner)
        except ValueError as e:
            log.fatal("--restore %s: %s", args.restore, e)
            return 1
        log.info("restored checkpoint %s (step=%d)", args.restore,
                 learner.step_count)
    signaled = {"flag": False}
    previous = signal.signal(signal.SIGINT,
                             lambda _s, _f: signaled.update(flag=True))
    try:
        _train(args, cfg, learner, signaled)
        if args.checkpoint:
            save_checkpoint(args.checkpoint, learner,
                            backend=args.checkpoint_backend)
            log.info("checkpoint saved to %s", args.checkpoint)
        wait_for_async_saves()
    finally:
        signal.signal(signal.SIGINT, previous)
    return 0


def _auto_tune_window(args, cfg: Config, graph, split, device) -> Config:
    """--auto-tune-window (the JAX CLI's rule, cli.py:618-644): the
    single-chain and flat-chain a-MMSB engines probe every candidate
    window size and keep the fastest; the others keep their window."""
    if args.mesh or args.model == "mmsb" or (
            args.num_chains > 1 and (args.chain_engine != "flat"
                                     or args.chain_devices > 1)):
        log.warning("--auto-tune-window supports the single-chain and "
                    "flat-chain engines; keeping window=%d", cfg.window)
        return cfg
    from mcmc_ammsb_tpu_torch.autotune import tune_window

    def make(c):
        if args.num_chains > 1:
            return FlatChainLearner(c, graph, split, args.num_chains, device)
        return Learner(c, graph, split, device)

    smem = None
    if device.type == "cuda":
        from mcmc_ammsb_tpu_torch import kernels
        smem = kernels.smem_limit(device)
    cfg, table = tune_window(cfg, make, smem_limit=smem)
    log.info("window auto-tuned to %d (probed %s)", cfg.window,
             {w: (f"{r:.0f}/s" if r else "failed") for w, r in table.items()})
    return cfg


def _fmt_ppx(ppx) -> str:
    """A perplexity for the log: a float, or the chains' [C] vector on
    one line."""
    if isinstance(ppx, np.ndarray):
        return "[" + " ".join(str(p) for p in ppx) + "]"
    return str(ppx)


def _train(args, cfg: Config, learner: Learner, signaled: dict) -> None:
    log.info("ppx[0] = %s", _fmt_ppx(learner.heldout_perplexity()))

    def log_eval(i, ppx, st):
        log.info("ppx[%d] = %s", i, _fmt_ppx(ppx))
        if "link_count" in st:      # the a-MMSB's evaluation counts them
            log.info("  links: %d (ll %.4f)  non-links: %d (ll %.4f)",
                     st["link_count"], st["link_likelihood"],
                     st["non_link_count"], st["non_link_likelihood"])
        if train_ppx:
            # the fused series carries the value; the host loop
            # evaluates it here, after the held-out one either way
            log.info("train_ppx[%d] = %s", i,
                     st["train_ppx"] if "train_ppx" in st
                     else learner.training_perplexity())

    # only the a-MMSB learner keeps a training-perplexity population
    train_ppx = learner.train_ppx_u is not None
    # the chain engines force device sampling: read the engine's config
    fused_evals = (learner.cfg.device_sampling
                   and hasattr(learner, "run_with_ppx")
                   and cfg.steps_per_call > cfg.ppx_interval)
    ck_next = [args.checkpoint_interval or None]

    def maybe_checkpoint(i):
        """Periodic checkpoint (--checkpoint-interval), checked at
        eval-loop boundaries; the directory backend's is asynchronous, so
        training resumes once the state is copied."""
        if ck_next[0] is None or i < ck_next[0] or not args.checkpoint:
            return
        directory = args.checkpoint_backend == "orbax"
        save_checkpoint(args.checkpoint, learner,
                        backend=args.checkpoint_backend, async_save=directory)
        log.info("checkpoint saved to %s (step %d)%s", args.checkpoint, i,
                 " [async]" if directory else "")
        while ck_next[0] <= i:
            ck_next[0] += args.checkpoint_interval

    i = 0
    start_step = learner.step_count
    while i < args.max_iters and not signaled["flag"]:
        if fused_evals and args.max_iters - i >= cfg.ppx_interval:
            # whole eval periods, about steps_per_call steps per call;
            # SIGINT is checked between calls
            take = min(args.max_iters - i, cfg.steps_per_call)
            take -= take % cfg.ppx_interval
            for ev in learner.run_with_ppx(take, cfg.ppx_interval):
                log_eval(ev["step"] - start_step, ev["ppx"], ev)
            i += take
            maybe_checkpoint(i)
        else:
            step = min(args.max_iters - i, cfg.ppx_interval)
            learner.run(step)
            i += step
            if not signaled["flag"]:
                log_eval(i, learner.heldout_perplexity(),
                         learner.last_ppx_stats)
            maybe_checkpoint(i)
    if signaled["flag"]:
        log.info("FORCED TERMINATE")
    elif args.rhat_draws >= 2:
        # Gelman-Rubin PSRF over beta across the chains; values near 1
        # mean the chains agree
        r = learner.beta_rhat(draws=args.rhat_draws)
        log.info("beta R-hat over %d chains (%d draws of %d steps): max "
                 "%.4f  median %.4f", args.num_chains, args.rhat_draws,
                 max(1, cfg.steps_per_call), float(np.max(r)),
                 float(np.median(r)))
    learner.print_stats(lambda s: log.info("%s", s))
    if (args.profile and args.model == "ammsb"
            and hasattr(learner, "print_stage_profile")):
        learner.print_stage_profile(lambda s: log.info("%s", s))


if __name__ == "__main__":
    sys.exit(main())
