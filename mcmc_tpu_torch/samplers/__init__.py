"""Sampler entry points (PyTorch port of ``mcmc_tpu.samplers``; HMC and
NUTS so far)."""

from mcmc_tpu_torch.samplers.hmc import hmc
from mcmc_tpu_torch.samplers.nuts import (NUTSState, build_nuts_kernel,
                                          make_subtree_builder, nuts)

__all__ = ["hmc", "nuts", "NUTSState", "build_nuts_kernel",
           "make_subtree_builder"]
