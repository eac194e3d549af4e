"""Multi-GPU execution on torch.distributed (counterpart of
``mcmc_ammsb_tpu/parallel``): the ('data', 'model') mesh of ranks
(``mesh``), process start-up and byte-range ingest (``multihost``), the
row-sharded learner (``sharded``), chains over several GPUs
(``chains_sharded``), the model-row-sharded graph and partitioned ingest
(``partitioned``), and the CPU dry run of the mesh shapes (``dryrun``).

pi's rows are sharded over the 'model' axis and the minibatch over the
'data' axis; gradients and row fetches are NCCL collectives on cards,
gloo collectives on the CPU.
"""

from mcmc_ammsb_tpu_torch.parallel.chains_sharded import (ShardedChainLearner,
                                                          make_chain_mesh)
from mcmc_ammsb_tpu_torch.parallel.mesh import make_mesh
from mcmc_ammsb_tpu_torch.parallel.sharded import ShardedLearner
