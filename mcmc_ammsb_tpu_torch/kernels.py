"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for Hopper (``sm_90a``) at first use into
``build/torch_kernels/`` of the checkout, under a name that carries a
hash of the source, the headers it includes and the flags, and loaded
with ``ctypes``. A ``csrc/<name>.cpp``, named with its suffix (the host
build of a kernel's header), is compiled the same way with ``g++``.
Nothing runs at import time: this module imports without a compiler.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"

# IEEE division and square root stay on: no --use_fast_math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# The host build of a kernel's header (csrc/*.cpp).
GXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")
# A header a source includes by a quoted name, found beside it.
_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _command(src: Path) -> list:
    """The compiler and flags of ``src``: nvcc for a .cu, g++ for a .cpp."""
    if src.suffix == ".cu":
        return [_nvcc(), *NVCC_FLAGS]
    gxx = shutil.which("g++")
    if not gxx:
        raise RuntimeError("g++ not found: the host build of a kernel's "
                           "layouts (csrc/*.cpp) needs a C++ compiler")
    return [gxx, *GXX_FLAGS]


def _source(name: str) -> Path:
    return _CSRC / (name if Path(name).suffix else f"{name}.cu")


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>`` (``<name>.cu`` unless ``name``
    has a suffix) lives: named by a hash of the source, the headers it
    includes (recursively) and the flags."""
    files = [_source(name)]
    for path in files:
        for inc in _INCLUDE.findall(path.read_bytes()):
            header = path.parent / inc.decode()
            if header.exists() and header not in files:
                files.append(header)
    flags = NVCC_FLAGS if files[0].suffix == ".cu" else GXX_FLAGS
    digest = hashlib.sha256(b"".join(f.read_bytes() for f in files)
                            + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{files[0].stem}_{digest[:12]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` with nvcc, or ``csrc/<name>`` of a
    ``.cpp`` source with g++, unless this source was built already;
    returns the shared library's path. The compiler's report (registers,
    shared memory, spills) is kept beside it as ``.log``."""
    src, out = _source(name), library_path(name)
    if out.exists():
        return out
    cmd = _command(src)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([*cmd, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(cmd[0]).name} failed on {src.name}:\n"
                           f"{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>`` once per process."""
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
