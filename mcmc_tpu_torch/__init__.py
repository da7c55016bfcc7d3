"""mcmc_tpu_torch — the PyTorch port of ``mcmc_tpu`` for NVIDIA GPUs.

The port mirrors ``mcmc_tpu``'s module layout and public names. Inside it
follows PyTorch's idiom: plain functions on chain-batched tensors (the chain
batch on the leading axis where the JAX package vmaps), an explicit
``device``, an explicit ``torch.Generator`` (or integer seed) where the JAX
package takes a key, and Python loops where it scans.

One API difference: user log-kernels are batched,
``log_kernel(theta: (n_chains, d)) -> (n_chains,)``; gradients come from
``torch.autograd.grad`` of the sum.

Ported so far: the fused-HMC logistic-regression path (``fused_glm_hmc``,
``ops.make_fused_hmc_step``, whose trajectory is one hand-written CUDA
kernel on the card), the generic ``hmc`` it is checked against, and the
R-hat/ESS diagnostics. The CUDA kernel is built at its first launch, so this
package imports without CUDA, nvcc or Triton.
"""

from mcmc_tpu_torch.settings import (
    AlgoSettings,
    RWMHSettings,
    MALASettings,
    HMCSettings,
    GHMCSettings,
    NUTSSettings,
    ChEESSettings,
    RMHMCSettings,
    DESettings,
    DEMCZSettings,
    AEESSettings,
    PTSettings,
    SMCSettings,
    StretchSettings,
    SGLDSettings,
    SGHMCSettings,
    EllipticalSettings,
    SliceSettings,
    GibbsSettings,
    MCLMCSettings,
    MAMSSettings,
    EvidenceSettings,
    BarkerSettings,
    MMALASettings,
)
from mcmc_tpu_torch.results import SamplerResult
from mcmc_tpu_torch.samplers.hmc import hmc
from mcmc_tpu_torch.ops.fused_sampler import fused_glm_hmc
from mcmc_tpu_torch import diagnostics, models

__all__ = [
    "AlgoSettings", "RWMHSettings", "MALASettings", "HMCSettings",
    "GHMCSettings", "NUTSSettings", "ChEESSettings", "RMHMCSettings",
    "DESettings", "DEMCZSettings", "AEESSettings", "PTSettings",
    "SMCSettings", "StretchSettings", "SGLDSettings", "SGHMCSettings",
    "EllipticalSettings", "SliceSettings", "GibbsSettings", "MCLMCSettings",
    "MAMSSettings", "EvidenceSettings", "BarkerSettings", "MMALASettings",
    "SamplerResult", "hmc", "fused_glm_hmc", "diagnostics", "models",
]
