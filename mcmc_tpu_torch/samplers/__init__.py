"""Sampler entry points (PyTorch port of ``mcmc_tpu.samplers``: HMC, NUTS,
ChEES, GHMC, MCLMC and MAMS so far)."""

from mcmc_tpu_torch.samplers.chees import chees
from mcmc_tpu_torch.samplers.ghmc import ghmc
from mcmc_tpu_torch.samplers.hmc import hmc
from mcmc_tpu_torch.samplers.mclmc import mams, mclmc
from mcmc_tpu_torch.samplers.nuts import (NUTSState, build_nuts_kernel,
                                          make_subtree_builder, nuts)

__all__ = ["hmc", "nuts", "chees", "ghmc", "mclmc", "mams", "NUTSState",
           "build_nuts_kernel", "make_subtree_builder"]
