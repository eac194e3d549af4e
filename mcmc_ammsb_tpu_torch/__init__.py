"""PyTorch + CUDA port of ``mcmc_ammsb_tpu`` for NVIDIA Hopper (H100).

The a-MMSB SG-MCMC sampler's main path — device minibatch sampling,
shared neighbor draws, the T-step window engine with its hand-written
CUDA kernel (``csrc/window_kernel.cu``), held-out perplexity — driven by
``python -m mcmc_ammsb_tpu_torch.cli``. The JAX package stays the
reference; this package imports torch and numpy and never JAX.
"""

from mcmc_ammsb_tpu_torch.config import Config, SampleStrategy
from mcmc_ammsb_tpu_torch.data import (Graph, generate_sets,
                                       load_snap_edges, synthetic_edges)
from mcmc_ammsb_tpu_torch.learner import Learner, TrainState, init_state

__version__ = "0.1.0"

__all__ = [
    "Config",
    "SampleStrategy",
    "Graph",
    "Learner",
    "TrainState",
    "init_state",
    "generate_sets",
    "load_snap_edges",
    "synthetic_edges",
]
