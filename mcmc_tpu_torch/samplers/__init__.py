"""Sampler entry points (PyTorch port of ``mcmc_tpu.samplers``: every
sampler of the JAX package — HMC, NUTS, ChEES, GHMC, MCLMC, MAMS, RWMH,
MALA, RM-HMC, DE, AEES, PT, SMC, the stretch ensemble, DE-MC(Z), slice,
elliptical slice, Barker, mMALA, SGLD/pSGLD, SGHMC and block Gibbs)."""

from mcmc_tpu_torch.samplers.aees import AEESState, aees
from mcmc_tpu_torch.samplers.barker import barker
from mcmc_tpu_torch.samplers.chees import chees
from mcmc_tpu_torch.samplers.de import de
from mcmc_tpu_torch.samplers.demcz import DEMCZState, demcz
from mcmc_tpu_torch.samplers.ellipse import elliptical_slice
from mcmc_tpu_torch.samplers.gibbs import gibbs
from mcmc_tpu_torch.samplers.ghmc import ghmc
from mcmc_tpu_torch.samplers.hmc import hmc
from mcmc_tpu_torch.samplers.mala import mala
from mcmc_tpu_torch.samplers.mclmc import mams, mclmc
from mcmc_tpu_torch.samplers.mmala import mmala
from mcmc_tpu_torch.samplers.nuts import (NUTSState, build_nuts_kernel,
                                          make_subtree_builder, nuts)
from mcmc_tpu_torch.samplers.pt import PTState, pt
from mcmc_tpu_torch.samplers.rmhmc import rmhmc
from mcmc_tpu_torch.samplers.rwmh import rwmh
from mcmc_tpu_torch.samplers.sgld import sghmc, sgld
from mcmc_tpu_torch.samplers.slice import slice_sampler
from mcmc_tpu_torch.samplers.smc import SMCState, smc
from mcmc_tpu_torch.samplers.stretch import StretchState, stretch

__all__ = ["hmc", "nuts", "chees", "ghmc", "mclmc", "mams", "rwmh", "mala",
           "rmhmc", "de", "aees", "pt", "smc", "stretch", "demcz",
           "slice_sampler", "elliptical_slice", "barker", "mmala", "sgld",
           "sghmc", "gibbs",
           "NUTSState", "AEESState", "PTState", "SMCState", "StretchState",
           "DEMCZState", "build_nuts_kernel", "make_subtree_builder"]
