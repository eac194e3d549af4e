"""Multi-chain engine spread over GPUs: a group of whole chains per rank
(counterpart of ``mcmc_ammsb_tpu/parallel/chains_sharded.py``).

C = G x C_local flat-layout chains (``chains_flat.py``) on a 1-D
('chains',) mesh of G ranks: rank g owns chains [g*C_local,
(g+1)*C_local), its pi block [C_local*N, K] on its own card, so every
step's gathers, scatters and reductions are local and the training loop
makes no collective at all; each window of a rank is ONE launch of the
window kernel's chain mode (``ops/window.window_chain_apply_cuda``, one
cluster per chain). The evaluations gather the chains' perplexities (and
beta for R-hat) across ranks.

Chain c's init is the global ``init_seed + c`` law of the single-GPU
engine, so the SET of chains does not depend on G. Group g's streams are
the port's ``rng.Streams`` law with g added to every seed: the seed
pairs' second word + g and ``sample_seed + g`` (``chains.chain_config``'s
fold, of which the streams read only the seeds), so group 0's streams
are the single-GPU engine's and G = 1 runs ``FlatChainLearner`` with C
chains, bit for bit.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from mcmc_ammsb_tpu_torch import rng
from mcmc_ammsb_tpu_torch.chains import chain_config, rhat
from mcmc_ammsb_tpu_torch.chains_flat import FlatChainLearner, init_chain_state
from mcmc_ammsb_tpu_torch.config import Config, PhiImpl, RngBackend
from mcmc_ammsb_tpu_torch.parallel.mesh import rank_device

CHAIN_AXIS = "chains"


class ChainMesh:
    """This rank's view of a 1-D ('chains',) mesh over ranks [0, G):
    ``shape`` {'chains': G}, its group index ``g_idx``, its ``device``
    and the mesh's ``group``. A rank past G has ``member`` False."""

    def __init__(self, n_groups: int, device):
        self.shape = {CHAIN_AXIS: n_groups}
        self.device = torch.device(device)
        self.rank = dist.get_rank()
        self.member = self.rank < n_groups
        self.g_idx = self.rank if self.member else None
        # new_group is collective over the world: every rank makes it
        self.group = (dist.group.WORLD
                      if n_groups == dist.get_world_size()
                      else dist.new_group(list(range(n_groups))))


def make_chain_mesh(n_groups: int, device="cuda") -> ChainMesh:
    """1-D ('chains',) mesh over the first n_groups ranks of the default
    process group."""
    if not dist.is_initialized():
        raise RuntimeError("make_chain_mesh needs a torch.distributed "
                           "process group: call parallel.multihost."
                           "initialize first")
    n = dist.get_world_size()
    if n_groups > n:
        raise ValueError(f"chain mesh needs {n_groups} devices, "
                         f"only {n} available")
    return ChainMesh(n_groups, rank_device(device))


class ShardedChainLearner(FlatChainLearner):
    """C chains over a G-rank chain mesh, C/G whole chains per rank, with
    ``FlatChainLearner``'s surface; perplexities are the [C] vector of
    all chains (gathered), ``state`` is this rank's C_local chains.
    Every rank of the mesh makes the same calls in the same order."""

    def __init__(self, cfg: Config, graph, split, num_chains: int,
                 mesh: ChainMesh):
        if not mesh.member:
            raise ValueError(f"rank {mesh.rank} is outside the "
                             f"{mesh.shape[CHAIN_AXIS]}-rank chain mesh")
        if cfg.rng_backend != RngBackend.NATIVE:
            raise ValueError("chain engines support the native RNG "
                             "backend only")
        if cfg.phi_impl != PhiImpl.JNP:
            raise ValueError("chain engines support phi_impl=jnp only")
        if cfg.window > 1 and not cfg.shared_neighbors:
            raise ValueError("window > 1 on the chain engines requires "
                             "shared_neighbors (the window kernel "
                             "operates on the shared-draw layout)")
        n_groups = mesh.shape[CHAIN_AXIS]
        if num_chains % n_groups:
            raise ValueError(
                f"num_chains={num_chains} must be divisible by the "
                f"chain mesh size {n_groups} (whole chains per device)")
        self.mesh = mesh
        self.total_chains = num_chains
        self.chains_per_group = num_chains // n_groups
        super().__init__(cfg, graph, split, self.chains_per_group,
                         mesh.device)
        self.streams = rng.make_streams(chain_config(self.cfg, mesh.g_idx),
                                        self.device)

    def _init_state(self, heldout_size: int):
        # chain g*C_local + i draws from init_seed + g*C_local + i
        first = self.mesh.g_idx * self.chains_per_group
        cfg = self.cfg.replace(init_seed=self.cfg.init_seed + first)
        t0 = time.perf_counter()
        state = init_chain_state(cfg, self.num_chains, heldout_size,
                                 self.device)
        self._sync()
        self.init_seconds = time.perf_counter() - t0
        return state

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every group's ``x`` concatenated on dim 0 in group order."""
        out = x.new_empty((self.mesh.shape[CHAIN_AXIS] * x.shape[0],
                           *x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(),
                                    group=self.mesh.group)
        return out

    def _evaluate(self, state):
        state, neg = super()._evaluate(state)
        return state, self._gather(neg)                  # [C]

    def beta_rhat(self, draws: int = 10) -> np.ndarray:
        """Gelman-Rubin PSRF [K] over beta across ALL C chains: ``draws``
        more chunks of steps_per_call steps, the chains' beta gathered
        after each."""
        assert draws >= 2, draws
        kept = []
        for _ in range(draws):
            self.run(max(1, self.cfg.steps_per_call))
            kept.append(self._gather(self.state.beta).cpu().numpy())
        return rhat(np.stack(kept, axis=1))              # [C, T, K]

    # -- checkpoints ---------------------------------------------------------

    def shard_layout(self) -> dict:
        """Every chain-indexed field is split over the chain mesh in
        group order (``ShardedLearner.shard_layout``)."""
        at = (self.mesh.group, self.mesh.g_idx)
        return {f: at for f in ("pi", "phi_sum", "theta", "beta",
                                "ppx_per_edge")}

    def dtensor_layout(self) -> dict:
        """The split fields as DTensors for the directory checkpoint,
        sharded on dim 0 over a 1-D DeviceMesh of the chain group."""
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import Shard

        if getattr(self, "_device_mesh", None) is None:
            self._device_mesh = DeviceMesh.from_group(self.mesh.group,
                                                      self.device.type)
        at = (self._device_mesh, [Shard(0)])
        return {f: at for f in self.shard_layout()}

    def stream_generators(self) -> dict:
        return dict(zip(self.streams._fields, self.streams))
