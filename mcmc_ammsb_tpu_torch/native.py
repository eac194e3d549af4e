"""ctypes binding and lazy build of the native C++ host library
(counterpart of ``mcmc_ammsb_tpu/native.py``).

``csrc/sampler.cpp`` at the root of the checkout (the source the JAX
package compiles too; it is never edited) is built with ``g++`` at first
use into ``build/torch_native/`` under a name that carries a hash of the
source, the flags and the host CPU's features (``-march=native``), as
``kernels.build`` names the CUDA libraries. The
JAX package keeps its own ``build/libmcmc_sampler.so``: the two packages
never load, overwrite or race on each other's library. It gives

  * ``sample_batches``  - a stack of padded host minibatches in one call
                          (``sampling.MiniBatchSampler.sample_many``);
  * ``snap_parse``      - the SNAP edge-list parser (``data.load_snap_edges``);
  * ``chd_build``       - one CHD perfect-hash construction attempt;
  * ``cuckoo_try``      - one cuckoo placement attempt (``ops/edgeset``).

Without a compiler ``available()`` is false and the callers fall back to
their numpy versions, which give the same tables and the same parse.
Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent
SOURCE = _ROOT / "csrc" / "sampler.cpp"
BUILD_DIR = _ROOT / "build" / "torch_native"
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
#: Why the last build or load failed ("" when it did not).
build_error = ""

STRATEGY_CODES = {
    "NodeLink": 0, "NodeNonLink": 1, "Node": 2,
    "BFLink": 3, "BFNonLink": 4, "BF": 5,
}


def _host_cpu() -> str:
    """What ``-march=native`` resolves to on this host: the CPU's feature
    flags, so that a build directory copied to another machine is never
    loaded there."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((ln for ln in f if ln.startswith(("flags",
                                                          "Features"))), "")
    except OSError:
        return platform.processor()


def library_path() -> Path:
    """Where this source, built with these flags on this CPU, lives."""
    digest = hashlib.sha256(
        SOURCE.read_bytes()
        + " ".join((*GXX_FLAGS, platform.machine(), _host_cpu())).encode()
    ).hexdigest()
    return BUILD_DIR / f"libsampler_{digest[:12]}.so"


def build() -> Path:
    """Compile ``csrc/sampler.cpp`` unless this source was built already;
    returns the library's path. Built to a temporary name and renamed, so
    a killed or concurrent build never leaves a truncated library."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    lib.sample_batches.restype = ctypes.c_int
    lib.sample_batches.argtypes = [
        ptr, ptr, i64,                                  # csr
        ptr, i64,                                       # heldout
        ctypes.c_int, i64, ctypes.c_double, ctypes.c_double,
        i64, i64, i64, ctypes.c_uint64,                 # S, caps, seed
        ptr, ptr, ptr, ptr, ptr, ptr,
    ]
    lib.snap_parse_open.restype = i64
    lib.snap_parse_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(ptr)]
    lib.snap_parse_take.restype = None
    lib.snap_parse_take.argtypes = [ptr, ptr, ptr]
    lib.snap_parse_drop.restype = None
    lib.snap_parse_drop.argtypes = [ptr]
    lib.chd_build.restype = i64
    lib.chd_build.argtypes = [
        i64, ptr, ptr,                                  # edges
        i64, i64, ctypes.c_uint32,                      # M, NB, seed
        ptr, ptr,                                       # out_d, out_slot_of
    ]
    lib.cuckoo_try.restype = ctypes.c_int
    lib.cuckoo_try.argtypes = [
        i64, ptr,                                       # keys
        i64, ctypes.c_uint64,                           # num_bins, seed
        ptr,                                            # out slots
    ]
    lib.ref_theta_init.restype = ctypes.c_int
    lib.ref_theta_init.argtypes = [
        ctypes.c_double, ctypes.c_double, ctypes.c_uint64,  # eta0, eta1, seed
        i64, ptr,                                       # count, out
    ]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            _lib = _bind(ctypes.CDLL(str(build())))
        except (RuntimeError, OSError, subprocess.SubprocessError) as e:
            build_error = f"{type(e).__name__}: {e}"
        return _lib


def available() -> bool:
    """True when the library is built and loaded (builds it at the first
    call)."""
    return _load() is not None


def _require(what: str) -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native {what} unavailable: the C++ build of "
                           f"{SOURCE.name} failed ({build_error})")
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def sample_batches(
    offsets: np.ndarray, cols: np.ndarray, num_nodes: int,
    heldout_sorted: np.ndarray, strategy: str, mini_batch: int,
    n_f: float, e_f: float, n_batches: int, e_cap: int, b_cap: int,
    seed: int,
):
    """Fill a stack of padded minibatches in one native call.

    Returns (edges_u, edges_v, edge_mask, nodes, node_mask, weights),
    shapes [S, e_cap] / [S, b_cap] / [S], as
    ``sampling.MiniBatchSampler.sample_many`` stacks them."""
    lib = _require("sample_batches")
    offsets = np.ascontiguousarray(offsets, np.int64)
    cols = np.ascontiguousarray(cols, np.int32)
    heldout_sorted = np.ascontiguousarray(heldout_sorted, np.uint64)
    s = n_batches
    eu = np.empty((s, e_cap), np.int32)
    ev = np.empty((s, e_cap), np.int32)
    em = np.empty((s, e_cap), np.uint8)
    nd = np.empty((s, b_cap), np.int32)
    nm = np.empty((s, b_cap), np.uint8)
    w = np.empty(s, np.float32)
    rc = lib.sample_batches(
        _ptr(offsets), _ptr(cols), num_nodes,
        _ptr(heldout_sorted), len(heldout_sorted),
        STRATEGY_CODES[strategy], mini_batch, float(n_f), float(e_f),
        s, e_cap, b_cap, seed & 0xFFFFFFFFFFFFFFFF,
        _ptr(eu), _ptr(ev), _ptr(em), _ptr(nd), _ptr(nm), _ptr(w),
    )
    if rc != 0:
        reasons = {-1: "unknown strategy", -2: "edge capacity exceeded",
                   -3: "node capacity exceeded",
                   -4: "sampling retry budget exhausted (graph cannot "
                       "supply the requested minibatch)"}
        raise RuntimeError("native sample_batches failed: "
                           f"{reasons.get(rc, f'rc={rc}')}")
    return eu, ev, em.astype(bool), nd, nm.astype(bool), w


def snap_parse(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a SNAP edge list natively; returns canonicalized (u, v)
    int64 arrays (self loops dropped, duplicates kept: renumbering and
    dedup happen in ``data.renumber_dedup_shuffle``). One pass: the C
    side parses the file into a buffer it owns (``snap_parse_open``),
    ``snap_parse_take`` copies the pairs out and frees it."""
    lib = _require("parser")
    reasons = {-1: "cannot read file",
               -3: "malformed line (expected two ints)"}
    handle = ctypes.c_void_p()
    count = lib.snap_parse_open(path.encode(), ctypes.byref(handle))
    if count < 0:
        raise IOError(f"snap_parse({path}) failed: "
                      f"{reasons.get(count, f'rc={count}')}")
    try:
        u = np.empty(count, np.int64)
        v = np.empty(count, np.int64)
    except BaseException:
        lib.snap_parse_drop(handle)
        raise
    lib.snap_parse_take(handle, _ptr(u), _ptr(v))
    return u, v


def chd_build(u: np.ndarray, v: np.ndarray, m_slots: int,
              n_buckets: int, seed: int):
    """Native CHD construction for one seed (the greedy and the hashes of
    ``ops/edgeset._chd_attempt_numpy``: identical tables). Returns
    (displacements [NB] i32, slot_of [E] i64), or None when this seed
    fails and the caller tries the next."""
    lib = _require("chd_build")
    u = np.ascontiguousarray(u, np.int32)
    v = np.ascontiguousarray(v, np.int32)
    d = np.zeros(n_buckets, np.int32)
    slot_of = np.empty(len(u), np.int64)
    rc = lib.chd_build(len(u), _ptr(u), _ptr(v), m_slots, n_buckets,
                       np.uint32(seed), _ptr(d), _ptr(slot_of))
    if rc == -5:
        return None
    if rc != 0:
        raise IOError(f"chd_build failed: rc={rc}")
    return d, slot_of


def cuckoo_try(keys: np.ndarray, num_bins: int, seed: int):
    """One native cuckoo placement attempt. Returns the filled slots
    [2, num_bins, 4] uint64 (empty = all ones), or None when the walk
    fails at this table size and the caller grows the table."""
    lib = _require("cuckoo_try")
    keys = np.ascontiguousarray(keys, np.uint64)
    slots = np.empty((2, num_bins, 4), np.uint64)
    rc = lib.cuckoo_try(len(keys), _ptr(keys), num_bins,
                        np.uint64(seed), _ptr(slots))
    if rc == -5:
        return None
    if rc != 0:
        raise IOError(f"cuckoo_try failed: rc={rc}")
    return slots


def ref_theta_init(eta0: float, eta1: float, seed: int,
                   count: int) -> np.ndarray:
    """The reference's exact theta-init bit stream (learner.cc:149-153):
    std::mt19937 seeded with the seed cut to 32 bits driving libstdc++'s
    std::gamma_distribution<float>(eta0, eta1), ``count`` draws in the
    interleaved (k,0),(k,1) layout. Raises without the native library: a
    run that asks for the reference's stream must not get another one."""
    lib = _require("ref_theta_init")
    out = np.empty(count, np.float32)
    rc = lib.ref_theta_init(float(eta0), float(eta1),
                            seed & 0xFFFFFFFFFFFFFFFF, count, _ptr(out))
    if rc != 0:
        raise IOError(f"ref_theta_init failed: rc={rc}")
    return out
