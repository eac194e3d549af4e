"""Model families beyond the a-MMSB (counterpart of
``mcmc_ammsb_tpu/models``)."""
