"""Model families (counterpart of ``mcmc_ammsb_tpu/models``):
``ammsb.AMMSB``, the a-MMSB's model-family facade, and ``mmsb``, the full
MMSB with its learners. Import the submodule you need: the package
imports neither, so that ``learner`` can be imported by both."""
