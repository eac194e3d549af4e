"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is not 0:
  1. device  — a CUDA device is required; prints the card's name and
               power limit as nvidia-smi reports them;
  2. build   — compiles the window kernel from csrc/ with nvcc;
  3. kernel  — window_core_cuda against window_core_torch, the plain
               PyTorch version, on the same CUDA operands at the bench
               shape and two odd ones (rtol 1e-5, atol 1e-8 normwise,
               see max_err), with the time per window of each;
  4. slice   — the whole hoisted loop (windows + tail steps) on the GPU
               against the same loop on the CPU, from the same state and
               operands (rtol 1e-5, atol 1e-8 normwise);
  5. main    — the port's CLI in-process at the bench shape
               (N=317,080, K=256, window 12); the window kernel's launch
               count must equal the window count, and the ppx series
               must be finite and fall below ppx[0];
then a JSON line of the kernels, and the result line last.
"""

from __future__ import annotations

import json
import logging
import math
import re
import subprocess
import sys
import time

import torch

RTOL, ATOL = 1e-5, 1e-8
MAIN_ARGS = ["--synthetic", "317080,7", "-k", "256", "-x", "2000",
             "-i", "500", "--device", "cuda"]


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def max_err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """max |got - want|, required <= ATOL + RTOL * max |want| (normwise
    per output tensor). Elementwise relative error is no measure here:
    the few elements that come out of a cancellation (the abs() of the
    SGRLD steps, s_contrib - n_valid) differ at rtol ~1e-4 between ANY
    two float32 evaluations with different summation orders — the
    kernel and the plain version are equally far from a float64
    evaluation there (printed by check_kernel)."""
    got, want = got.double().cpu(), want.double().cpu()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values")
    err = float((got - want).abs().max())
    bound = ATOL + RTOL * float(want.abs().max())
    if err > bound:
        raise AssertionError(f"{what}: max abs err {err:.3e} > {bound:.3e} "
                             f"(rtol {RTOL}, atol {ATOL}, normwise)")
    return err


def time_ms(fn, reps: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _float64(args):
    """The window-core arguments with every float tensor in float64."""
    def up(x):
        if isinstance(x, torch.Tensor):
            return x.double() if x.is_floating_point() else x
        if hasattr(x, "_fields"):                # NamedTuple
            return type(x)(*(up(a) for a in x))
        if isinstance(x, tuple):
            return tuple(up(a) for a in x)
        return x

    return tuple(up(a) for a in args)


def check_kernel(window, testing):
    """Phase 3: returns (max abs err over shapes, kernel ms, plain ms) at
    the bench shape."""
    shapes = [  # (T, B, n, E, K): bench shape, odd shape, K % 32 != 0
        (12, 33, 32, 32, 256), (3, 6, 7, 5, 12), (12, 33, 32, 32, 100)]
    worst, times = 0.0, None
    for seed, (t_win, b_cap, n_smpl, e_cap, k) in enumerate(shapes):
        case = testing.window_case(seed, t_win, b_cap, n_smpl, e_cap, k)
        cfg = testing.window_case_config(case)
        state, xs = testing.window_case_torch(case, "cuda")
        batch, nbrs = xs[0], xs[1][:, 0, :]
        g, sums_g = window._window_gather(cfg, state, batch, nbrs)
        mcode = window._correction_codes(cfg, batch.nodes, batch.node_mask,
                                          nbrs)
        if not (mcode > 0).any():
            raise AssertionError("the case has no in-window collision")
        args = (cfg, state, xs, g, sums_g, mcode)
        got = window.window_core_cuda(*args)
        torch.cuda.synchronize()
        want = window.window_core_torch(*args)
        names = ("rows", "sums", "theta", "beta")
        shape = (t_win, b_cap, n_smpl, e_cap, k)
        errs = [max_err(a, b, f"{name} at {shape}")
                for a, b, name in zip(got, want, names)]
        worst = max(worst, *errs)
        # float64 evaluation of the same window: how far each float32
        # version is from it
        ref = window.window_core_torch(*_float64(args))
        f64 = [max(float((a.double() - r).abs().max())
                   for a, r in zip(out, ref)) for out in (got, want)]
        ms = time_ms(lambda: window.window_core_cuda(*args))
        plain_ms = time_ms(lambda: window.window_core_torch(*args))
        if times is None:
            times = (ms, plain_ms)
        phase("kernel", f"T,B,n,E,K={t_win},{b_cap},{n_smpl},{e_cap},{k}: "
              f"kernel vs plain max abs err {max(errs):.3e} (vs float64: "
              f"kernel {f64[0]:.3e}, plain {f64[1]:.3e}); "
              f"{ms:.4f} ms/window kernel, {plain_ms:.4f} ms/window plain")
    return worst, times


def check_slice(learner_mod, data, config, sampling):
    """Phase 4: the hoisted loop on the GPU vs the CPU from one state."""
    n, u, v = data.synthetic_edges(300, 8, seed=9)
    split = data.generate_sets(n, u, v, heldout_ratio=0.1, seed=10)
    graph = data.Graph.from_edges(n, split.training_u, split.training_v)
    cfg = config.Config(K=24, mini_batch_size=8, num_node_sample=8,
                        device_sampling=True, shared_neighbors=True,
                        window=5).finalize(n, split.total_edges,
                                           graph.max_fan_out)
    cpu = learner_mod.Learner(cfg, graph, split, "cpu")
    ds = sampling.sample_minibatches_device(
        cfg, cpu.training_set, cpu.heldout_set, cpu.streams.sample, 23,
        cpu.adjacency)
    xs = learner_mod.hoist_operands(cfg, cpu.training_set,
                                    learner_mod.DeviceBatch(*ds),
                                    cpu.streams)

    def to(x, dev):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if hasattr(x, "_fields"):                # NamedTuple
            return type(x)(*(to(a, dev) for a in x))
        if isinstance(x, tuple):
            return tuple(to(a, dev) for a in x)
        return x

    gpu_state = to(cpu.state._replace(pi=cpu.state.pi.clone(),
                                      phi_sum=cpu.state.phi_sum.clone()),
                   "cuda")
    got = learner_mod.run_hoisted(cfg, gpu_state, to(xs, "cuda"))
    want = learner_mod.run_hoisted(cfg, cpu.state, xs)
    errs = [max_err(getattr(got, f), getattr(want, f), f"slice {f}")
            for f in ("pi", "phi_sum", "theta", "beta")]
    phase("slice", f"23 steps (4 windows of 5 + 3 tail steps), N={n} "
          f"K=24: GPU kernel vs CPU plain max abs err {max(errs):.3e}")


def run_main(cli, window):
    """Phase 5: the CLI's main path; returns (launches, rate)."""
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append((record.created, record.getMessage()))

    handler = Keep()
    logging.getLogger("mcmc_ammsb_tpu_torch").addHandler(handler)
    try:
        window.window_core_cuda.launches = 0
        rc = cli.main(MAIN_ARGS)
        launches = window.window_core_cuda.launches
    finally:
        logging.getLogger("mcmc_ammsb_tpu_torch").removeHandler(handler)
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc}")
    series = []
    for created, msg in records:
        m = re.fullmatch(r"ppx\[(\d+)\] = (\S+)", msg)
        if m:
            series.append((int(m.group(1)), float(m.group(2)), created))
    steps = [s for s, _, _ in series]
    if steps != [0, 500, 1000, 1500, 2000]:
        raise AssertionError(f"unexpected ppx steps {steps}")
    ppx = [p for _, p, _ in series]
    if not all(math.isfinite(p) for p in ppx):
        raise AssertionError(f"non-finite ppx {ppx}")
    if not (all(p < ppx[0] for p in ppx[1:]) and ppx[-1] < ppx[1]):
        raise AssertionError(f"ppx does not decrease: {ppx}")
    expected = 4 * (500 // 12)     # 4 intervals of 41 windows + 8 tail
    if launches != expected:
        raise AssertionError(f"window kernel launched {launches} times, "
                             f"expected {expected}")
    # steady state: the second 1000-step call, whose numbers reach the
    # host only after the device finished it
    t1000 = next(c for s, _, c in series if s == 1000)
    t2000 = next(c for s, _, c in series if s == 2000)
    rate = 1000 / (t2000 - t1000)
    phase("main", f"rc 0, ppx {ppx}, window-kernel launches {launches} "
          f"(= {expected} windows), steady state {rate:.1f} updates/s")
    return launches, rate


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    # the port's package: an ImportError here (no checkout around the
    # script) ends the run before anything is printed
    from mcmc_ammsb_tpu_torch import cli, config, data, kernels, testing
    from mcmc_ammsb_tpu_torch import learner as learner_mod
    from mcmc_ammsb_tpu_torch.ops import device_sampling, window

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    phase("device", f"{torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    lib = kernels.build("window_kernel")
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "spill" in ln]
    phase("build", f"window_kernel built in {time.perf_counter() - t0:.2f} s"
          f" ({'; '.join(ptxas)})")

    err, (ms, plain_ms) = check_kernel(window, testing)
    check_slice(learner_mod, data, config, device_sampling)
    launches, _ = run_main(cli, window)

    print(json.dumps({"kernels": [{
        "name": "window_kernel", "route": "cuda",
        "source": "mcmc_ammsb_tpu_torch/csrc/window_kernel.cu",
        "replaces": "mcmc_ammsb_tpu/ops/window.py:321",
        "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
