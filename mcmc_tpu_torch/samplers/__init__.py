"""Sampler entry points (PyTorch port of ``mcmc_tpu.samplers``: HMC, NUTS,
ChEES, GHMC, MCLMC, MAMS, RWMH, MALA, RM-HMC and DE so far)."""

from mcmc_tpu_torch.samplers.chees import chees
from mcmc_tpu_torch.samplers.de import de
from mcmc_tpu_torch.samplers.ghmc import ghmc
from mcmc_tpu_torch.samplers.hmc import hmc
from mcmc_tpu_torch.samplers.mala import mala
from mcmc_tpu_torch.samplers.mclmc import mams, mclmc
from mcmc_tpu_torch.samplers.nuts import (NUTSState, build_nuts_kernel,
                                          make_subtree_builder, nuts)
from mcmc_tpu_torch.samplers.rmhmc import rmhmc
from mcmc_tpu_torch.samplers.rwmh import rwmh

__all__ = ["hmc", "nuts", "chees", "ghmc", "mclmc", "mams", "rwmh", "mala",
           "rmhmc", "de", "NUTSState", "build_nuts_kernel",
           "make_subtree_builder"]
