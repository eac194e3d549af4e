"""The a-MMSB window kernel's bfloat16 row mode on the card, and its
float32 instantiation against another build of the kernel.

  PYTHONPATH=. python3 scripts/window_bf16.py [--parent-src FILE] [--reps N]

For the main path's window (T, B, n, E, K) = (12, 33, 32, 32, 256) and
the 16-chain window (C, T, B, n, E, K) = (16, 6, 33, 32, 32, 256),
chip_smoke.py's bf16 kernel phase (``check_bf16_kernels``): the kernel
with bf16 pi against its float32 launch on the upcast rows (bit for bit,
once rounded) and against the plain version at bf16 (the stored rows'
ulp gaps, phi_sum, theta and beta by the normwise float32 rule), and ms
per window of the float32 and the bf16 launches on the same operands,
in turns (f32, bf16, bf16, f32), device time only.

With ``--parent-src`` (a ``window_kernel.cu`` of another commit, whose
C interface lacks the ``pi_bf16`` argument) that source is built too and
its launches are held bit for bit against this float32 instantiation at
every shape of chip_smoke.py's kernel phase, with both timed in turns
(parent, change, change, parent). Prints one line per check and a JSON
line at the end; needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke
from mcmc_ammsb_tpu_torch import chains_flat, kernels, testing
from mcmc_ammsb_tpu_torch.ops import window


class _ParentLib:
    """A build of an earlier window_kernel.cu behind this commit's call:
    ``window_kernel_launch`` without the pi_bf16 argument (float32
    only)."""

    #: position of pi_bf16 among window_kernel_launch's arguments
    AT = 19 + 8

    def __init__(self, path: Path):
        lib = ctypes.CDLL(str(path))
        _P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.window_kernel_launch.argtypes = ([_P] * 19 + [_I] * 8 + [_F] * 7
                                             + [_P] * 3)
        lib.window_kernel_launch.restype = _I
        self.lib = lib

    def window_kernel_launch(self, *args):
        if args[self.AT] != 0:
            raise ValueError("the parent's kernel stores float32 only")
        return self.lib.window_kernel_launch(*args[:self.AT],
                                             *args[self.AT + 1:])


def build_parent(src: Path) -> _ParentLib:
    out = kernels.BUILD_DIR / "libwindow_kernel_parent.so"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True)
    return _ParentLib(out)


def single_case(shape, seed=0):
    case = testing.window_case(seed, *shape)
    cfg = testing.window_case_config(case)
    state, xs = testing.window_case_torch(case, "cuda")
    batch, nbrs = xs[0], xs[1][:, 0, :]
    mcode = window._correction_codes(cfg, batch.nodes, batch.node_mask, nbrs)
    keep = window._last_write_wins(batch.nodes, batch.node_mask, shape[0])
    return cfg, state, (xs, mcode, keep), window.window_apply_cuda, \
        window.window_apply_torch


def chain_case(shape, seed=0):
    case = testing.chain_window_case(seed, *shape)
    cfg = testing.chain_window_case_config(case)
    state, xw = testing.chain_window_case_torch(case, "cuda")
    win = chains_flat.chain_windows(cfg, shape[0], xw).at(0)
    return cfg, state, (win.xs_t, win.mcode, win.keep), \
        window.window_chain_apply_cuda, window.window_chain_apply_torch


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
        parent = build_parent(a.parent_src)
        mine = window._window_lib()
        shapes = ([("single", s) for s in chip_smoke.WINDOW_SHAPES]
                  + [("chains", s) for s in chip_smoke.CHAIN_SHAPES])
        for kind, shape in shapes:
            make = single_case if kind == "single" else chain_case
            cfg, state, args, cuda, _ = make(shape, seed=1)
            outs = []
            for lib in (parent, mine):
                window._window_lib = lambda lib=lib: lib
                outs.append(chip_smoke._outs(cuda(cfg, chip_smoke._fresh(
                    state), *args)))
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(*outs)):
                raise AssertionError(f"{kind} {shape}: float32 outputs differ "
                                     f"from the parent's kernel")
            scratch = chip_smoke._fresh(state)
            t = []
            for lib in (parent, mine, mine, parent):
                window._window_lib = lambda lib=lib: lib
                t.append(chip_smoke.time_ms(lambda: cuda(cfg, scratch, *args),
                                            a.reps, hold=True))
            window._window_lib = lambda: mine
            result["parent"][f"{kind} {shape}"] = dict(
                bit_equal=True, parent_ms=(t[0] + t[3]) / 2,
                change_ms=(t[1] + t[2]) / 2, turns=t)
            print(f"{kind} {shape}: float32 bit-equal to the parent's build; "
                  f"ms/window parent {t[0]:.4f} {t[3]:.4f}, change "
                  f"{t[1]:.4f} {t[2]:.4f}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
