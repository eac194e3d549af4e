"""Operators of the port (counterparts of mcmc_ammsb_tpu/ops)."""
