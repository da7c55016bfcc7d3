"""Fused kernels (PyTorch port of ``mcmc_tpu.ops``): the fused GLM HMC
trajectory and its sampler entry point. The CUDA library is built and
loaded on the first launch on a CUDA tensor, never at import."""

from mcmc_tpu_torch.ops.fused_logreg import (  # noqa: F401
    FusedHMCState, make_fused_trajectory, make_fused_hmc_step, studentt_link)
from mcmc_tpu_torch.ops.fused_sampler import fused_glm_hmc, run_fused_step  # noqa: F401

__all__ = ["FusedHMCState", "make_fused_trajectory", "make_fused_hmc_step",
           "studentt_link", "fused_glm_hmc", "run_fused_step"]
