"""The ('data', 'model') mesh over the ranks of a torch.distributed world
(counterpart of ``mcmc_ammsb_tpu/parallel/mesh.py``).

JAX drives every device from one process through ``shard_map``; PyTorch
runs one process per GPU. A mesh of D x M is a world of D*M ranks laid
out on a 2-D ``DeviceMesh`` with dims ("data", "model"): rank
r = d*M + m, so a model group is made of consecutive ranks and stays on
one host's NVLink, as ``multihost.global_mesh`` keeps it on ICI.

Each rank runs on ``cuda:LOCAL_RANK`` with NCCL, or with ``device='cpu'``
on the CPU with gloo: the backend follows the device, never a failure
(``multihost.initialize``).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "data"
MODEL_AXIS = "model"


def rank_device(device) -> torch.device:
    """The device of this rank: ``cuda:LOCAL_RANK`` (or the global rank
    modulo the host's card count) for a CUDA run, else the CPU. Raises
    for a CUDA run on a machine without a card: no quiet fallback."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r}: no CUDA device is "
                           "available (pass device='cpu' to run on the CPU)")
    if dev.index is not None:
        return dev
    if "LOCAL_RANK" in os.environ:
        local = int(os.environ["LOCAL_RANK"])
    else:
        rank = dist.get_rank() if dist.is_initialized() else 0
        local = rank % torch.cuda.device_count()
    return torch.device("cuda", local)


def backend_for(device) -> str:
    """The collective backend of a device kind: NCCL on a card, gloo on
    the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


class Mesh:
    """This rank's view of a (D, M) mesh: ``shape`` {axis: size} as JAX's
    ``Mesh.shape``, its coordinates ``d_idx`` / ``m_idx``, its ``device``
    and the groups of its ``data`` row (the D ranks of its model index)
    and its ``model`` row (the M ranks of its data index). A rank outside
    a subset mesh has ``member`` False and no coordinates."""

    def __init__(self, n_data: int, n_model: int, device):
        self.shape = {DATA_AXIS: n_data, MODEL_AXIS: n_model}
        self.device = torch.device(device)
        need = n_data * n_model
        ranks = torch.arange(need).reshape(n_data, n_model)
        # every rank of the world builds the groups (new_group is
        # collective), members or not
        self.device_mesh = DeviceMesh(self.device.type, ranks,
                                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
        self.rank = dist.get_rank()
        self.member = self.rank < need
        self.d_idx = self.rank // n_model if self.member else None
        self.m_idx = self.rank % n_model if self.member else None
        if self.member:
            self.data_group = self.device_mesh.get_group(DATA_AXIS)
            self.model_group = self.device_mesh.get_group(MODEL_AXIS)
        else:
            self.data_group = self.model_group = None

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape[DATA_AXIS]}, "
                f"model={self.shape[MODEL_AXIS]}, rank={self.rank}, "
                f"device={self.device})")


def make_mesh(n_data: Optional[int] = None, n_model: Optional[int] = None,
              allow_subset: bool = False, device="cuda") -> Mesh:
    """Build a ('data', 'model') mesh over the ranks of the default
    process group (``multihost.initialize`` starts it).

    Default split: model axis as large as possible up to 4 (pi rows
    sharded for capacity), rest data-parallel. An explicit shape must
    cover every rank unless ``allow_subset`` is set: silently leaving
    cards idle would be a provisioning bug, so it raises by default, with
    the JAX package's wording."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a torch.distributed process "
                           "group: call parallel.multihost.initialize first")
    n = dist.get_world_size()
    if n_data is None or n_model is None:
        n_model = min(4, n)
        while n % n_model:
            n_model //= 2
        n_data = n // n_model
    need = n_data * n_model
    if need > n:
        raise ValueError(f"mesh {n_data}x{n_model} needs {need} devices, "
                         f"only {n} available")
    if need < n and not allow_subset:
        raise ValueError(
            f"mesh {n_data}x{n_model} uses {need} of {n} devices; pass "
            "allow_subset=True to deliberately leave chips idle")
    return Mesh(n_data, n_model, rank_device(device))
