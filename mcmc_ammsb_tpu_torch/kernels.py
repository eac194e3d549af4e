"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for Hopper (``sm_90a``) at first use into
``build/torch_kernels/`` of the checkout, under a name that carries a
hash of the source and flags, and loaded with ``ctypes``. Nothing here
runs at import time: this module imports on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"

# IEEE division and square root stay on: no --use_fast_math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless this source was built already;
    returns the shared library's path. The compiler's report
    (registers, shared memory, spills) is kept beside it as ``.log``."""
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"lib{name}_{digest[:12]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` once per process."""
    return ctypes.CDLL(str(build(name)))


def pointer(x, dtype, device) -> int:
    """``x``'s device address for a kernel argument; raises unless ``x``
    is a contiguous ``dtype`` tensor on ``device``."""
    if x.dtype != dtype or not x.is_contiguous() or x.device != device:
        raise ValueError(f"kernel operand: {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}, wants contiguous {dtype} on {device}")
    return x.data_ptr()


def smem_limit(device) -> int:
    """Bytes of shared memory one thread block may use on ``device``
    (232,448 on an H100)."""
    props = torch.cuda.get_device_properties(device)
    return getattr(props, "shared_memory_per_block_optin", 232448)


def check_launch(err: int, what: str) -> None:
    """Raise for a launcher's non-zero cudaGetLastError()."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")
