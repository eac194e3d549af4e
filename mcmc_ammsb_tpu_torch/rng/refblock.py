"""The reference RNG's chunk draws on the card (counterpart of
``mcmc_ammsb_tpu/rng/refblock.py``).

The JAX package decodes blocks of raw xorshift128+ words with pointer
doubling, because a TPU cannot run a rejection loop per lane. A GPU
thread can, as the original code did (phi.cc:114-121, sample.cc:13-78):
``csrc/ref_rng_kernel.cu`` gives each stream one thread that runs the
reference's sequential algorithm, and draws a whole chunk of S steps in
one launch. Its contract is the JAX decoder's: the same bits as the
faithful loops of ``rng/reference.py``.

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


@functools.cache
def _lib():
    lib = kernels.load("ref_rng_kernel")
    lib.randn_lanes_launch.argtypes = [_P, _P, _P, _I, _I, _I, _P, _P, _P,
                                       _P]
    lib.neighbors_lanes_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I,
                                           _P]
    lib.gamma_lanes_launch.argtypes = [_P, _P, _P, _I, ctypes.c_longlong,
                                       _F, _F, _F, _I, _F, _P, _P, _P, _P]
    for f in (lib.randn_lanes_launch, lib.neighbors_lanes_launch,
              lib.gamma_lanes_launch):
        f.restype = _I
    return lib


def _operands(seeds: torch.Tensor, mask: torch.Tensor):
    """The new seeds (a copy the kernel advances in place) and the
    checked mask [S, L]."""
    dev = seeds.device
    if seeds.dim() != 2 or seeds.shape[1] != 4:
        raise ValueError(f"seeds must be [L, 4], got {tuple(seeds.shape)}")
    if mask.dim() != 2 or mask.shape[1] != seeds.shape[0]:
        raise ValueError(f"mask {tuple(mask.shape)} does not match "
                         f"{seeds.shape[0]} lanes")
    new = seeds.clone()
    kernels.pointer(new, torch.int64, dev)
    kernels.pointer(mask, torch.bool, dev)
    return new, torch.cuda.current_stream(dev).cuda_stream


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
    out = torch.empty(s_len, lanes, k, dtype=torch.float32,
                      device=seeds.device)
    err = _lib().randn_lanes_launch(new.data_ptr(), mask.data_ptr(),
                                    out.data_ptr(), s_len, lanes, k,
                                    *_tables(seeds.device), stream)
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
    err = _lib().neighbors_lanes_launch(new.data_ptr(), nodes.data_ptr(),
                                        mask.data_ptr(), out.data_ptr(),
                                        s_len, lanes, num_nodes, num, stream)
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
        new.data_ptr(), mask.data_ptr(), out.data_ptr(), s_len, lanes,
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
