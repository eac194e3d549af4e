"""Where the time of a randn_lanes launch goes, phase by phase, on one
NVIDIA GPU: the theta noise's launch (200 steps, 256 streams, k = 2: a
warp per stream) and the phi noise's (200 steps, 64 streams, k = 256, a
random mask: a block per stream).

    PYTHONPATH=. python3 scripts/ref_rng_phases.py

A copy of mcmc_ammsb_tpu_torch/csrc/ref_rng_kernel.cu with clock64()
stamps at the phase boundaries of the first group's thread 0 (blocks 0 and
1) is built beside the kernels' builds and launched on the same operands
as the kernel; the stamps' differences are printed in cycles (the loop's
phases for the last round only), beside the device time of the
uninstrumented kernel (CUDA events over 50 launches while the host is held
back). Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from mcmc_ammsb_tpu_torch import kernels  # noqa: E402
from mcmc_ammsb_tpu_torch.rng import reference as ref  # noqa: E402
from mcmc_ammsb_tpu_torch.rng import refblock  # noqa: E402

# (name, the source line a stamp goes before or after) in phase order
STAMPS = [
    ("start", "  bool f[kPre];\n", "before"),
    ("prologue", "  if (!live) return;             // a whole group (kT = 256: "
                 "the block)\n", "after"),
    ("steps", "  bulk_wait(&bar);\n", "before"),
    ("start jumps", "  uint32_t drawn = 0, entry = 0;\n", "before"),
    ("words", "    // the round starting at each position", "before"),
    ("ktab tests", "    const uint32_t c2 = ~acc & kAll;", "before"),
    ("wedge and tail", "    // the segment's map", "before"),
    ("maps", "    // exclusive scan of the maps over the group", "before"),
    ("scan", "    // this thread's draws, staged in draw order", "before"),
    ("staging", "    // ... and written by the group in draw order", "before"),
    ("write", "    entry = r >> 16;\n", "before"),
    ("next jump", "    if (drawn < total) st = jump(sjt + start_tables<kT>(), "
                  "post);\n"
                  "    group_sync<kT>();\n  }\n", "after"),
]


def instrumented_source() -> str:
    src = (kernels._CSRC / "ref_rng_kernel.cu").read_text()
    src = src.replace("namespace {\n",
                      "__device__ long long g_stamps[64];\nnamespace {\n", 1)
    for i, (name, anchor, where) in enumerate(STAMPS):
        if src.count(anchor) != 1:
            raise RuntimeError(f"the kernel source changed: no single "
                               f"{anchor!r} for the stamp {name!r}")
        stamp = (f"  if (threadIdx.x == 0 && blockIdx.x < 2) "
                 f"g_stamps[blockIdx.x * 32 + {i}] = clock64();\n")
        src = src.replace(anchor, stamp + anchor if where == "before"
                          else anchor + stamp)
    return src + ('\nextern "C" int read_stamps(long long* host) {\n'
                  "  return (int)cudaMemcpyFromSymbol(host, g_stamps, "
                  "sizeof(g_stamps));\n}\n")


def build() -> ctypes.CDLL:
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = kernels.BUILD_DIR / "ref_rng_phases.cu"
    src.write_text(instrumented_source())
    out = kernels.BUILD_DIR / "libref_rng_phases.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(out))


def bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.randn_lanes_launch.argtypes = [p, p, p, p, i, i, i, p, p, p, p, i,
                                       p]
    return lib


def device_ms(fn, reps: int = 50) -> float:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("ref_rng_phases: no CUDA device", file=sys.stderr)
        return 1
    inst = bind(build())
    plain = bind(ctypes.CDLL(str(kernels.build("ref_rng_kernel"))))
    zig = [t.data_ptr() for t in ref.ziggurat_tables("cuda")]
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator().manual_seed(0)
    cases = {
        "theta noise (200, 256, 2)": (
            ref.make_seeds((44, 45), 256, "cuda"), 2,
            torch.ones(200, 256, dtype=torch.bool, device="cuda")),
        "phi noise (200, 64, 256)": (
            ref.make_seeds((42, 43), 64, "cuda"), 256,
            (torch.rand(200, 64, generator=gen) < 0.9).cuda()),
    }
    stamps = (ctypes.c_longlong * 64)()
    names = [name for name, _, _ in STAMPS]
    for case, (seeds, k, mask) in cases.items():
        s_len, lanes = mask.shape
        layout = refblock.randn_layout(s_len, lanes, k)
        tables = refblock.jump_tables(layout, "cuda")
        out = torch.empty(s_len, lanes, k, device="cuda")
        new = seeds.clone()

        def launch(lib):
            return lib.randn_lanes_launch(
                seeds.data_ptr(), new.data_ptr(), mask.data_ptr(),
                out.data_ptr(), s_len, lanes, k, *zig, tables.data_ptr(),
                layout[0], stream)

        for _ in range(2):
            launch(inst)
        torch.cuda.synchronize()
        inst.read_stamps(stamps)
        for b in range(2):
            v = [stamps[b * 32 + i] for i in range(len(STAMPS))]
            phases = {names[i + 1]: v[i + 1] - v[i]
                      for i in range(len(STAMPS) - 1)}
            print(f"{case}, {layout[0]} threads a stream, block {b}: "
                  f"cycles {phases}, total {v[-1] - v[0]}")
        print(f"{case}: {device_ms(lambda: launch(plain)) * 1e3:.2f} us a "
              f"launch (device)", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
