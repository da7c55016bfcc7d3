"""mcmc_tpu_torch — the PyTorch port of ``mcmc_tpu`` for NVIDIA GPUs.

The port mirrors ``mcmc_tpu``'s module layout and public names. Inside it
follows PyTorch's idiom: plain functions on chain-batched tensors (the chain
batch on the leading axis where the JAX package vmaps), an explicit
``device``, an explicit ``torch.Generator`` (or integer seed) where the JAX
package takes a key, and Python loops where it scans.

One API difference: user log-kernels are batched,
``log_kernel(theta: (n_chains, d)) -> (n_chains,)``; gradients come from
``torch.autograd.grad`` of the sum.

Ported so far: the fused-HMC paths (``fused_glm_hmc`` on GLM posteriors,
``fused_gaussian_hmc`` on multivariate Gaussians, and the ``ops.make_fused_*``
factories, whose trajectories are hand-written CUDA kernels on the card), the
generic ``hmc`` they are checked against, adapted ``nuts`` (plain PyTorch, a
batched lockstep tree), the bench's other quality samplers ``chees``,
``ghmc``, ``mclmc`` and ``mams`` (plain PyTorch, lockstep across the chain
batch, with the windowed adaptation they share), the reference library's
``rwmh`` (with delayed rejection, DRAM), ``mala``, ``rmhmc`` (with the
``softabs_metric``), the population sampler ``de`` and the equi-energy
sampler ``aees`` (with that, all seven of the reference library's
samplers), the tempering and ensemble samplers beside them (``pt``,
``smc``, ``stretch``, ``demcz``), the self-tuning and latent-Gaussian
samplers ``slice_sampler`` and ``elliptical_slice``, the gradient samplers
``barker`` and ``mmala``, the minibatch samplers ``sgld`` (with pSGLD) and
``sghmc``, and block ``gibbs``: with these, every sampler of the JAX
package. Also the ``stats`` densities, every target of ``models``, the
diagnostics, and ``entry.entry()``, one batched HMC transition on the
flagship posterior. And the one-call workflow: ``fit`` and ``sample``
(``umbrella``), pytree models (``ravel_model``, ``unravel_draws``,
``bounds_like``), the Laplace and Pathfinder starts (``map_laplace``,
``pathfinder``), the posterior predictive (``generated_quantities``,
``posterior_predictive``), model comparison (``pointwise_log_lik``,
``waic``, ``psis_loo``, ``compare``) and simulation-based calibration
(``sbc``). And the rest of the inference layer: power-posterior evidence
(``thermo_evidence``), nested sampling (``nested_sampling``), ADVI
(``advi``) and SVGD (``svgd``), the ``observability`` timers and profiler
capture, and durability: ``checkpoint_dir=`` on every sampler entry point
and on ``fit`` (``checkpoint``'s chunked runner, ``runtime``'s native draw
sink, built with ``g++`` at first use).

Two more API differences: SGLD's and SGHMC's likelihood is batched,
``log_lik(theta: (n_chains, d), batch) -> (n_chains,)`` with every leaf of
``batch`` shaped ``(n_chains, B, ...)``; a Gibbs block's exact conditional
is ``fn(gen, full: (n_chains, d)) -> (n_chains, d_b)``, drawing from the
run's ``torch.Generator``. Nested sampling's ``prior_transform`` and
``log_lik`` are batched, ``(B, d) -> (B, d)`` and ``(B, d) -> (B,)``; a
checkpointed run draws from one generator whose state the checkpoint
holds, where the JAX package splits per-chain keys, and its draw sink never
falls back quietly to Python (``DrawSink(..., native=False)`` asks for
that writer). In the workflow, a pytree log-kernel gets leaves
with a leading chain axis, ``log_lik_fn`` and a predictive function are
batched over draws (``(B, d) -> (B, ...)``), ``map_laplace``'s
``optimizer=`` is a PyTorch optimizer factory, and callbacks that draw
take a ``torch.Generator`` where the JAX package passes a key.
The CUDA kernels are built at their first launch, so this package imports
without CUDA, nvcc or Triton.

Entry points run on the card: with no ``device=`` and no tensor argument
they allocate on ``torch.device("cuda")`` and raise where there is none.
Pass ``device="cpu"`` (or CPU tensors) to run on the CPU.
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
from mcmc_tpu_torch.samplers.nuts import nuts
from mcmc_tpu_torch.samplers.chees import chees
from mcmc_tpu_torch.samplers.ghmc import ghmc
from mcmc_tpu_torch.samplers.mclmc import mams, mclmc
from mcmc_tpu_torch.samplers.rwmh import rwmh
from mcmc_tpu_torch.samplers.mala import mala
from mcmc_tpu_torch.samplers.rmhmc import rmhmc
from mcmc_tpu_torch.samplers.de import de
from mcmc_tpu_torch.samplers.pt import pt
from mcmc_tpu_torch.samplers.aees import aees
from mcmc_tpu_torch.samplers.smc import smc
from mcmc_tpu_torch.samplers.stretch import stretch
from mcmc_tpu_torch.samplers.demcz import demcz
from mcmc_tpu_torch.samplers.slice import slice_sampler
from mcmc_tpu_torch.samplers.ellipse import elliptical_slice
from mcmc_tpu_torch.samplers.barker import barker
from mcmc_tpu_torch.samplers.mmala import mmala
from mcmc_tpu_torch.samplers.sgld import sghmc, sgld
from mcmc_tpu_torch.samplers.gibbs import gibbs
from mcmc_tpu_torch.metrics import softabs_metric
from mcmc_tpu_torch.ops.fused_sampler import fused_glm_hmc, fused_gaussian_hmc
from mcmc_tpu_torch.laplace import map_laplace, LaplaceResult
from mcmc_tpu_torch.pathfinder import pathfinder, PathfinderResult
from mcmc_tpu_torch.model_compare import (
    pointwise_log_lik,
    waic,
    psis_loo,
    compare,
)
from mcmc_tpu_torch.pytree import ravel_model, unravel_draws, bounds_like
from mcmc_tpu_torch.predictive import (generated_quantities,
                                       posterior_predictive)
from mcmc_tpu_torch.sbc import sbc
from mcmc_tpu_torch.evidence import thermo_evidence, EvidenceResult
from mcmc_tpu_torch.nested import nested_sampling, NestedResult
from mcmc_tpu_torch.advi import advi, ADVIResult
from mcmc_tpu_torch.svgd import svgd, SVGDResult
from mcmc_tpu_torch.umbrella import sample, fit
from mcmc_tpu_torch import (bounds, checkpoint, diagnostics, models,
                            observability, runtime, stats)

__all__ = [
    "AlgoSettings", "RWMHSettings", "MALASettings", "HMCSettings",
    "GHMCSettings", "NUTSSettings", "ChEESSettings", "RMHMCSettings",
    "DESettings", "DEMCZSettings", "AEESSettings", "PTSettings",
    "SMCSettings", "StretchSettings", "SGLDSettings", "SGHMCSettings",
    "EllipticalSettings", "SliceSettings", "GibbsSettings", "MCLMCSettings",
    "MAMSSettings", "EvidenceSettings", "BarkerSettings", "MMALASettings",
    "SamplerResult", "hmc", "nuts", "chees", "ghmc", "mclmc", "mams",
    "rwmh", "mala", "rmhmc", "de", "pt", "aees", "smc", "stretch", "demcz",
    "slice_sampler", "elliptical_slice", "barker", "mmala", "sgld", "sghmc",
    "gibbs",
    "softabs_metric",
    "fused_glm_hmc", "fused_gaussian_hmc",
    "sample", "fit", "map_laplace", "LaplaceResult",
    "pathfinder", "PathfinderResult",
    "pointwise_log_lik", "waic", "psis_loo", "compare",
    "ravel_model", "unravel_draws", "bounds_like",
    "generated_quantities", "posterior_predictive", "sbc",
    "thermo_evidence", "EvidenceResult", "nested_sampling", "NestedResult",
    "advi", "ADVIResult", "svgd", "SVGDResult",
    "bounds", "checkpoint", "diagnostics", "models", "observability",
    "runtime", "stats",
]
