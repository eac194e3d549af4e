"""The a-MMSB window kernel's bfloat16 row mode on the card, and its
resident mode against another build of the kernel.

  PYTHONPATH=. python3 scripts/window_bf16.py [--parent-src FILE] [--reps N]

For the main path's window (T, B, n, E, K) = (12, 33, 32, 32, 256), the
16-chain window (C, T, B, n, E, K) = (16, 6, 33, 32, 32, 256), the
com-youtube rung's (12, 33, 32, 32, 1024) and, in the wide mode, the
K = 4096 path's window (12, 33, 32, 32, 4096), the K = 8192 path's
(12, 33, 32, 32, 8192) and the K = 16384 path's (12, 33, 32, 32,
16384), chip_smoke.py's bf16 kernel phase
(``check_bf16_kernels``): the kernel with bf16 pi against its float32
launch on the upcast rows (bit for bit, once rounded) and against the
plain version at bf16 (the stored rows' ulp gaps, phi_sum, theta and
beta by the normwise float32 rule), and ms per window of the float32
and the bf16 launches on the same operands, in turns (f32, bf16, bf16,
f32), device time only.

With ``--parent-src FILE`` (a ``window_kernel.cu`` with the C interface
of chip_smoke.PARENT_SRC, scripts/window_kernel_pr17.cu, the kernel from
before the wide mode's node-resident layout) that source is built too
and chip_smoke.py's ``check_resident_parent`` holds the resident mode,
both step layouts and the chunked layout of this build against it bit
for bit, float32 and bf16, at every shape of chip_smoke.py's kernel
phase they run, with the main and chain shapes
timed in turns (parent, change, change, parent). Prints one line per
check and a JSON line at the end; needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke
from mcmc_ammsb_tpu_torch import chains_flat, kernels, testing
from mcmc_ammsb_tpu_torch.ops import window


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-src", type=Path, default=None)
    ap.add_argument("--reps", type=int, default=50,
                    help="launches per timing of the parent check")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("window_bf16: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    result = {"device": smi, "parent": {}}
    bf16 = chip_smoke.check_bf16_kernels(window, chains_flat, testing, smi)
    result["bf16"] = {
        name: dict(gaps, max_abs_err=err, bf16_ms=ms16, f32_ms=ms32,
                   bound_ms=b_ms, bound_by=b_by)
        for name, (gaps, err, ms16, ms32, b_ms, b_by) in bf16.items()}

    if a.parent_src is not None:
        parent = chip_smoke.build_parent(kernels, a.parent_src)
        turns = chip_smoke.check_resident_parent(
            window, chains_flat, testing, kernels, parent, a.reps)
        result["parent"] = {
            str(shape): dict(bit_equal=True, parent_ms=p_ms, change_ms=c_ms,
                             turns=t)
            for shape, (p_ms, c_ms, t) in turns.items()}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
