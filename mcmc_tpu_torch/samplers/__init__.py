"""Sampler entry points (PyTorch port of ``mcmc_tpu.samplers``: HMC, NUTS,
ChEES, GHMC, MCLMC, MAMS, RWMH, MALA, RM-HMC, DE, AEES, PT, SMC, the stretch
ensemble and DE-MC(Z) so far)."""

from mcmc_tpu_torch.samplers.aees import AEESState, aees
from mcmc_tpu_torch.samplers.chees import chees
from mcmc_tpu_torch.samplers.de import de
from mcmc_tpu_torch.samplers.demcz import DEMCZState, demcz
from mcmc_tpu_torch.samplers.ghmc import ghmc
from mcmc_tpu_torch.samplers.hmc import hmc
from mcmc_tpu_torch.samplers.mala import mala
from mcmc_tpu_torch.samplers.mclmc import mams, mclmc
from mcmc_tpu_torch.samplers.nuts import (NUTSState, build_nuts_kernel,
                                          make_subtree_builder, nuts)
from mcmc_tpu_torch.samplers.pt import PTState, pt
from mcmc_tpu_torch.samplers.rmhmc import rmhmc
from mcmc_tpu_torch.samplers.rwmh import rwmh
from mcmc_tpu_torch.samplers.smc import SMCState, smc
from mcmc_tpu_torch.samplers.stretch import StretchState, stretch

__all__ = ["hmc", "nuts", "chees", "ghmc", "mclmc", "mams", "rwmh", "mala",
           "rmhmc", "de", "aees", "pt", "smc", "stretch", "demcz",
           "NUTSState", "AEESState", "PTState", "SMCState", "StretchState",
           "DEMCZState", "build_nuts_kernel", "make_subtree_builder"]
