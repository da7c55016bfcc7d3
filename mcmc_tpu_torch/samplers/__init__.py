"""Sampler entry points (PyTorch port of ``mcmc_tpu.samplers``; HMC so
far)."""

from mcmc_tpu_torch.samplers.hmc import hmc

__all__ = ["hmc"]
