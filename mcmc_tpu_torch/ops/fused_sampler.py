"""Sampler-surface entry points for the fused HMC steps (PyTorch port of
``mcmc_tpu.ops.fused_sampler``).

:mod:`mcmc_tpu_torch.ops.fused_logreg` provides batched HMC transitions
whose whole leapfrog trajectory runs in one kernel. These wrappers put them
behind the standard entry-point contract — burn-in + keep loop,
``SamplerResult`` with draws ``(n_keep, n_chains, dim)`` and acceptance.

The fused steps are fixed-step/fixed-trajectory (reference src/hmc.cpp
semantics: constant ``step_size``/``n_leap_steps``); there is no warmup
adaptation here. They run on the card unless the caller passes
``device="cpu"`` or CPU tensors.
"""

from __future__ import annotations

import torch

from mcmc_tpu_torch.results import SamplerResult
from mcmc_tpu_torch.settings import AlgoSettings
from mcmc_tpu_torch.samplers._resolve import resolve_device, resolve_key
from mcmc_tpu_torch.ops.fused_logreg import (
    make_fused_hmc_step, make_fused_gaussian_hmc_step)

__all__ = ["fused_glm_hmc", "fused_gaussian_hmc", "run_fused_step"]


def run_fused_step(step, positions, n_burnin, n_keep, gen,
                   steps_per_draw: int = 1) -> SamplerResult:
    """Loop a fused batched HMC ``step`` (``step(gen, state)``, the
    ``make_fused_*_hmc_step`` contract) over ``n_burnin`` discarded +
    ``n_keep`` kept draws; ``steps_per_draw=k`` thins by k transitions per
    stored row (acceptance is that of each row's last transition). Returns
    draws trimmed to the model dim (padding columns dropped)."""
    dim = step.dim
    state = step.init(positions)
    spd = int(steps_per_draw)
    n_chains = state.position.shape[0]
    dev = state.position.device
    draws = torch.empty((int(n_keep), n_chains, dim), dtype=torch.float32,
                        device=dev)
    accepted = torch.empty((int(n_keep), n_chains), dtype=torch.bool,
                           device=dev)
    with torch.no_grad():
        for _ in range(int(n_burnin) * spd):
            state, _info = step(gen, state)
        for i in range(int(n_keep)):
            for _j in range(spd):
                state, info = step(gen, state)
            draws[i] = state.position[:, :dim]
            accepted[i] = info["accepted"]
    return SamplerResult(
        draws=draws,
        n_accept_draws=accepted.sum(dim=0),
        diagnostics={"accept_rate_per_chain":
                     accepted.to(torch.float32).mean(dim=0)},
    )


def fused_glm_hmc(X, y, *, link="logistic", prior_scale=10.0, step_size=0.05,
                  n_leap=8, n_chains=2048, n_burnin_draws=500,
                  n_keep_draws=1000, init_scale=0.05, key=None,
                  block_chains=256, steps_per_draw=1,
                  device=None) -> SamplerResult:
    """Fused-trajectory HMC on a GLM posterior ``y | X beta ~ family(link)``
    with a ``N(0, prior_scale^2)`` prior — logistic / poisson / linear /
    probit built in, :func:`mcmc_tpu_torch.ops.fused_logreg.studentt_link`
    built in as well; any other elementwise torch callable ``link(eta, y)
    -> (mu_eff, ll_terms)`` runs in the same kernel, traced into it and
    compiled once per link and width at first use (the module docstring of
    :mod:`mcmc_tpu_torch.ops.fused_logreg`). ``key`` is a
    ``torch.Generator`` or an integer seed (``None``: seed 0); it draws the
    initial positions ``init_scale * N(0, 1)`` and then every transition.
    ``device`` defaults to ``X``'s when it is a tensor, else the card; on a
    CUDA device every trajectory is one launch of the fused kernel."""
    device = resolve_device(device, X)
    gen = resolve_key(key, AlgoSettings(), device)
    step = make_fused_hmc_step(X, y, prior_scale=prior_scale,
                               step_size=step_size, n_leap=n_leap,
                               block_chains=block_chains, link=link,
                               device=device)
    pos0 = init_scale * torch.randn((n_chains, step.dim), generator=gen,
                                    dtype=torch.float32, device=device)
    return run_fused_step(step, pos0, n_burnin_draws, n_keep_draws, gen,
                          steps_per_draw)


def fused_gaussian_hmc(precision, mean=None, *, step_size=0.5, n_leap=32,
                       n_chains=2048, n_burnin_draws=500, n_keep_draws=1000,
                       init_scale=0.05, key=None, block_chains=256,
                       steps_per_draw=1, step_jitter=0.2,
                       device=None) -> SamplerResult:
    """Fused-trajectory HMC on a multivariate Gaussian ``N(mean, P^{-1})``
    given the precision ``P`` (dense or diagonal), all f32: the engine for
    the ill-conditioned stress target, where long jittered-step trajectories
    carry the slow directions (``step_jitter`` breaks the fixed-angle
    resonances an exactly quadratic target otherwise hits, see
    :func:`mcmc_tpu_torch.ops.fused_logreg.make_fused_gaussian_hmc_step`).
    ``key`` and ``device`` as in :func:`fused_glm_hmc` (``device`` defaults
    to ``precision``'s when it is a tensor, else the card)."""
    device = resolve_device(device, precision)
    gen = resolve_key(key, AlgoSettings(), device)
    step = make_fused_gaussian_hmc_step(precision, mean, step_size=step_size,
                                        n_leap=n_leap,
                                        block_chains=block_chains,
                                        step_jitter=step_jitter,
                                        device=device)
    pos0 = init_scale * torch.randn((n_chains, step.dim), generator=gen,
                                    dtype=torch.float32, device=device)
    return run_fused_step(step, pos0, n_burnin_draws, n_keep_draws, gen,
                          steps_per_draw)
