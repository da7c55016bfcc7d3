"""Fused kernels (PyTorch port of ``mcmc_tpu.ops``): the fused GLM and
Gaussian HMC trajectories and their sampler entry points. The CUDA library
is built and loaded on the first launch on a CUDA tensor, never at import."""

from mcmc_tpu_torch.ops import fused_logreg  # noqa: F401
from mcmc_tpu_torch.ops.fused_logreg import (  # noqa: F401
    FusedHMCState, make_fused_trajectory, make_fused_hmc_step,
    make_fused_trajectory_rt, make_fused_gaussian_trajectory,
    make_fused_gaussian_hmc_step, studentt_link)
from mcmc_tpu_torch.ops.fused_sampler import (  # noqa: F401
    fused_glm_hmc, fused_gaussian_hmc, run_fused_step)

__all__ = ["fused_logreg", "FusedHMCState", "make_fused_trajectory",
           "make_fused_hmc_step", "make_fused_trajectory_rt",
           "make_fused_gaussian_trajectory", "make_fused_gaussian_hmc_step",
           "studentt_link", "fused_glm_hmc", "fused_gaussian_hmc",
           "run_fused_step"]
