"""The reference RNG's chunk draws on the card (counterpart of
``mcmc_ammsb_tpu/rng/refblock.py``).

The JAX package decodes blocks of raw xorshift128+ words with pointer
doubling, because a TPU cannot run a rejection loop per lane. The card
splits each stream instead (``csrc/ref_rng_kernel.cu``): the state
transition of xorshift128+ is linear over GF(2)^128, so the state d
words ahead is M^d times the state (``jump``), and the threads of a
group own consecutive segments of one stream's words. ``randn_lanes``
decodes, at every word position at once, the ziggurat round that would
start there, and chains the rounds with a scan of 3-state maps;
``neighbors_lanes`` takes a warp of candidates at a time, a candidate
being taken iff it is not the node and not an earlier candidate of its
step. Both give the bits of the faithful loops of ``rng/reference.py``.
``gamma_lanes`` (the init only, one stream per thread over millions of
streams) keeps the per-stream loop.

The jump tables are built here, in numpy and torch, once per layout and
device (``jump_tables``): for each jump distance (those a thread's start
is made of, and the step from one round to the next), the 128 x 128 bit
matrix as 32 tables of the 16 XORs of four of its columns, so that the
kernel applies a jump with 32 lookups.

Each wrapper launches the kernel on CUDA tensors and runs the plain
version (``rng/reference.py``'s ``*_lanes``) on CPU tensors; a launch
that fails raises. ``--no-ref-rng-block`` calls the plain version on any
device. Every function returns new seeds: the ones passed in are not
changed. Each wrapper counts its launches (``.launches``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from mcmc_ammsb_tpu_torch import kernels
from mcmc_ammsb_tpu_torch.rng import reference as ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: (threads per stream, words per thread and round) of the kernel's two
#: layouts: a warp per stream, or a 256-thread block per stream
WARP_LAYOUT = (32, 16)
BLOCK_LAYOUT = (256, 32)
#: streams up to which a long draw takes a block each (two per SM of an
#: H100), and the draws per stream from which it does
BLOCK_MAX_LANES = 264
BLOCK_MIN_DRAWS = 2048
#: steps of one randn_lanes launch (its shared memory holds the steps): a
#: longer chunk takes several launches, each from the seeds the last left
MAX_LAUNCH_STEPS = 4096


# ---------------------------------------------------------------------------
# Exact jump-ahead of xorshift128+
# ---------------------------------------------------------------------------

_BIT = np.arange(64, dtype=np.uint64)


def _pack(seeds: torch.Tensor) -> np.ndarray:
    """[L, 4] seed words -> [L, 2] uint64 (state.x, state.y)."""
    w = seeds.cpu().numpy().astype(np.uint64)
    return np.stack([(w[:, 0] << np.uint64(32)) | w[:, 1],
                     (w[:, 2] << np.uint64(32)) | w[:, 3]], -1)


def _unpack(states: np.ndarray, device) -> torch.Tensor:
    """The inverse of ``_pack``."""
    lo = np.uint64(0xFFFFFFFF)
    words = np.stack([states[:, 0] >> np.uint64(32), states[:, 0] & lo,
                      states[:, 1] >> np.uint64(32), states[:, 1] & lo], -1)
    return torch.from_numpy(words.astype(np.int64)).to(device)


def _apply(cols: np.ndarray, states: np.ndarray) -> np.ndarray:
    """The bit matrix whose column c is ``cols[c]`` (the image of state
    bit c: bits 0-63 are state.x's, 64-127 state.y's) applied to
    ``states`` [n, 2] over GF(2)."""
    bits = ((states[:, :, None] >> _BIT) & np.uint64(1)).reshape(-1, 128)
    return np.bitwise_xor.reduce(
        np.where(bits[:, :, None] == 1, cols[None], np.uint64(0)), axis=1)


_IDENTITY = np.zeros((128, 2), np.uint64)
_IDENTITY[np.arange(128), np.arange(128) // 64] = np.uint64(1) << (
    np.arange(128, dtype=np.uint64) % np.uint64(64))


@functools.cache
def _pow2_columns(b: int) -> np.ndarray:
    """The columns of M^(2^b), M the xorshift128+ step."""
    if b == 0:
        basis = _unpack(_IDENTITY, "cpu")
        return _pack(ref._xorshift128p(basis)[2])
    half = _pow2_columns(b - 1)
    return _apply(half, half)


@functools.lru_cache(maxsize=64)
def _jump_columns(d: int) -> np.ndarray:
    """The columns of M^d."""
    if d < 0:
        raise ValueError(f"cannot jump back {d} words")
    cols = _IDENTITY
    for b in range(d.bit_length()):
        if d >> b & 1:
            cols = _apply(_pow2_columns(b), cols)
    return cols


def jump(seeds: torch.Tensor, d: int) -> torch.Tensor:
    """``seeds`` [L, 4] advanced by ``d`` words, as ``d`` calls of
    ``reference.rand_u64`` would leave them: M^d s, with M^d from the
    squares of the step's matrix."""
    return _unpack(_apply(_jump_columns(int(d)), _pack(seeds)),
                   seeds.device)


def jump_distances(layout):
    """The jumps of a (threads, words) layout's tables, in the kernel's
    order: words * 2^b for the bits b of a thread's index, then threads *
    words - words (from the end of a thread's segment to its segment of
    the next round)."""
    threads, words = layout
    dists = [words << b for b in range(threads.bit_length() - 1)]
    return dists + [threads * words - words]


@functools.lru_cache(maxsize=8)
def jump_tables(layout, device) -> torch.Tensor:
    """The kernel's jump tables of a (threads, words) layout, one per
    ``jump_distances``: int64 [D, 32, 16, 2] on ``device``. Thread t's
    start is the product of the jumps of the bits of t."""
    basis = _unpack(_IDENTITY, "cpu")        # column c: state bit c alone
    cols = np.stack([_pack(jump(basis, d)) for d in jump_distances(layout)])
    return torch.from_numpy(_nibble_tables(cols)).to(device)


def _nibble_tables(cols: np.ndarray) -> np.ndarray:
    """[D, 128, 2] uint64 matrix columns -> [D, 32, 16, 2] int64 tables:
    entry (n, v) the XOR of the columns 4n + i for the bits i of v."""
    cols = cols.reshape(len(cols), 32, 1, 4, 2)
    pick = (np.arange(16)[:, None] >> np.arange(4)) & 1        # [16, 4]
    sel = np.where(pick[None, None, :, :, None] == 1, cols, np.uint64(0))
    return np.bitwise_xor.reduce(sel, axis=3).view(np.int64)


def randn_layout(s_len: int, lanes: int, k: int):
    """The layout of a ``randn_lanes`` launch: a block per stream when
    few streams each draw many values (the phi noise: 64 streams of up
    to 51,200 draws), else a warp per stream (the theta noise: 256
    streams of 400)."""
    if lanes <= BLOCK_MAX_LANES and s_len * k >= BLOCK_MIN_DRAWS:
        return BLOCK_LAYOUT
    return WARP_LAYOUT


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------

@functools.cache
def _lib():
    lib = kernels.load("ref_rng_kernel")
    lib.randn_lanes_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P, _P,
                                       _P, _P, _I, _P]
    lib.neighbors_lanes_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I,
                                           _I, _P, _P]
    lib.gamma_lanes_launch.argtypes = [_P, _P, _P, _P, _I, ctypes.c_longlong,
                                       _F, _F, _F, _I, _F, _P, _P, _P, _P]
    for f in (lib.randn_lanes_launch, lib.neighbors_lanes_launch,
              lib.gamma_lanes_launch):
        f.restype = _I
    return lib


def _operands(seeds: torch.Tensor, mask: torch.Tensor):
    """The new seeds (written by the kernel, every stream's) and the
    checked operands."""
    dev = seeds.device
    if seeds.dim() != 2 or seeds.shape[1] != 4:
        raise ValueError(f"seeds must be [L, 4], got {tuple(seeds.shape)}")
    if mask.dim() != 2 or mask.shape[1] != seeds.shape[0]:
        raise ValueError(f"mask {tuple(mask.shape)} does not match "
                         f"{seeds.shape[0]} lanes")
    kernels.pointer(seeds, torch.int64, dev)
    kernels.pointer(mask, torch.bool, dev)
    return torch.empty_like(seeds), torch.cuda.current_stream(dev).cuda_stream


def _tables(device):
    y, k, w = ref.ziggurat_tables(device)
    return y.data_ptr(), k.data_ptr(), w.data_ptr()


def randn_lanes(seeds: torch.Tensor, k: int, mask: torch.Tensor):
    """``k`` sequential N(0,1) per drawing lane at each step of ``mask``
    [S, L]: (f32 [S, L, k], zeros where masked off; seeds')."""
    if not seeds.is_cuda:
        return ref.randn_lanes(seeds, k, mask)
    new, stream = _operands(seeds, mask)
    s_len, lanes = mask.shape
    if s_len * k >= 2 ** 31:
        raise ValueError(f"{s_len} x {k} draws per stream exceed 2^31")
    layout = randn_layout(s_len, lanes, k)
    out = torch.empty(s_len, lanes, k, dtype=torch.float32,
                      device=seeds.device)
    for s0 in range(0, s_len, MAX_LAUNCH_STEPS):
        part = mask[s0:s0 + MAX_LAUNCH_STEPS]
        err = _lib().randn_lanes_launch(
            (new if s0 else seeds).data_ptr(), new.data_ptr(),
            part.data_ptr(), out[s0:].data_ptr(),
            part.shape[0], lanes, k, *_tables(seeds.device),
            jump_tables(layout, seeds.device).data_ptr(), layout[0], stream)
        kernels.check_launch(err, "randn_lanes")
        randn_lanes.launches += 1
    return out, new


def neighbors_lanes(seeds: torch.Tensor, nodes: torch.Tensor,
                    mask: torch.Tensor, num_nodes: int, num: int):
    """The reference neighbor sampler at each step of ``nodes`` and
    ``mask`` [S, L]: (int64 [S, L, num], the sentinel ``num_nodes`` where
    masked off; seeds')."""
    if not seeds.is_cuda:
        return ref.neighbors_lanes(seeds, nodes, mask, num_nodes, num)
    if num >= num_nodes:
        raise ValueError(f"cannot draw {num} distinct neighbors != node "
                         f"from a {num_nodes}-node graph")
    if num > 32:
        raise ValueError(f"the neighbor kernel takes num <= 32, got {num}")
    new, stream = _operands(seeds, mask)
    kernels.pointer(nodes, torch.int32, seeds.device)
    s_len, lanes = mask.shape
    out = torch.empty(s_len, lanes, num, dtype=torch.int64,
                      device=seeds.device)
    err = _lib().neighbors_lanes_launch(
        seeds.data_ptr(), new.data_ptr(), nodes.data_ptr(), mask.data_ptr(),
        out.data_ptr(), s_len, lanes, num_nodes, num,
        jump_tables(WARP_LAYOUT, seeds.device).data_ptr(), stream)
    kernels.check_launch(err, "neighbors_lanes")
    neighbors_lanes.launches += 1
    return out, new


def gamma_lanes(seeds: torch.Tensor, a: float, b: float,
                mask: torch.Tensor):
    """One Gamma(a, b) draw per drawing lane at each step of ``mask``
    [S, L]: (f32 [S, L], zeros where masked off; seeds')."""
    if not seeds.is_cuda:
        return ref.gamma_lanes(seeds, a, b, mask)
    new, stream = _operands(seeds, mask)
    aa = float(a) + (1.0 if a < 1.0 else 0.0)     # one boost when a < 1
    s_len, lanes = mask.shape
    out = torch.empty(s_len, lanes, dtype=torch.float32, device=seeds.device)
    err = _lib().gamma_lanes_launch(
        seeds.data_ptr(), new.data_ptr(), mask.data_ptr(), out.data_ptr(),
        s_len, lanes,
        float(np.float32(aa - 1.0 / 3.0)),
        float(np.float32((1.0 / 3.0) / np.sqrt(aa - 1.0 / 3.0))),
        float(np.float32(b)), int(a < 1.0),
        float(np.float32(1.0 / a)) if a < 1.0 else 1.0,
        *_tables(seeds.device), stream)
    kernels.check_launch(err, "gamma_lanes")
    gamma_lanes.launches += 1
    return out, new


#: Launches of each entry in this process (reset by callers that check a
#: run went through it).
randn_lanes.launches = 0
neighbors_lanes.launches = 0
gamma_lanes.launches = 0
