"""Simulation-based calibration (Talts, Betancourt, Simpson, Vehtari &
Gelman 2018, arXiv:1804.06788; PyTorch port of ``mcmc_tpu.sbc``).

For a generative model ``theta ~ prior``, ``data ~ simulator(theta)``, the
rank of the true ``theta`` among L (near-independent) posterior draws is
exactly uniform on {0, ..., L} when the sampler targets the correct
posterior — any bias, wrong scale, or unconverged adaptation shows up as a
non-uniform rank histogram.

- Ranks need near-independent draws (Talts §5.1): pass ``thin`` so
  ``n_rank_draws`` survive; the harness checks that enough draws arrive.
- Uniformity is scored per dimension with a chi-squared statistic over
  ``n_bins`` equiprobable rank bins and its survival p-value
  (``torch.special.gammaincc``, in float32 as the JAX package computes
  it).

The posterior runs are a host loop: each simulation is an entire MCMC run
whose data changes. Simulation ``i`` draws from three generators derived
from the seed and ``i`` (:func:`~mcmc_tpu_torch.samplers._resolve.
stream_generator`): prior, simulation and fit streams that never replay one
another.

API difference from the JAX package: every callback takes a
``torch.Generator`` where the JAX package passes a key.
"""

from __future__ import annotations

import numpy as np
import torch

from mcmc_tpu_torch.samplers._resolve import (key_seed, resolve_device,
                                              stream_generator)

__all__ = ["sbc"]

# the three streams of one simulation
_PRIOR, _SIMULATE, _FIT = 0, 1, 2


def _uniformity(ranks, L, n_bins, n_sims):
    """Chi-squared of each dimension's rank histogram over ``n_bins``
    equiprobable bins against uniformity, and its survival p-value with
    ``n_bins - 1`` degrees of freedom."""
    bin_width = (L + 1) // int(n_bins)
    binned = ranks // bin_width                   # values in 0..n_bins-1
    counts = np.stack([np.bincount(binned[:, j], minlength=int(n_bins))
                       for j in range(ranks.shape[1])])   # (d, n_bins)
    expected = n_sims / int(n_bins)
    chi2 = ((counts - expected) ** 2 / expected).sum(axis=1)
    dof = int(n_bins) - 1
    p_value = torch.special.gammaincc(
        torch.tensor(dof / 2.0),
        torch.as_tensor(chi2 / 2.0, dtype=torch.float32)).numpy()
    return chi2, p_value


def sbc(key, prior_sampler, simulator, posterior_sampler, *,
        n_sims=100, n_rank_draws=31, thin=1, n_bins=8, device=None):
    """Run simulation-based calibration of a posterior sampler.

    Args:
        key: an integer seed or a ``torch.Generator`` (one seed is drawn
            from it); each simulation derives its independent (prior,
            simulate, fit) generators from it.
        prior_sampler: ``f(gen) -> theta`` — one draw from the prior,
            shape ``(d,)`` (or scalar).
        simulator: ``f(gen, theta) -> data`` — one synthetic dataset.
        posterior_sampler: ``f(gen, data) -> draws`` — the sampler under
            test, returning kept draws with a leading draw axis (chain
            axes, if any, are flattened); **constrained** space, the same
            parameterization as ``prior_sampler``.
        n_sims: number of independent calibration simulations.
        n_rank_draws: L — posterior draws ranked against the truth per
            simulation (after thinning). Ranks are uniform on {0..L}.
        thin: keep every ``thin``-th posterior draw before ranking.
        n_bins: equiprobable rank bins for the chi-squared uniformity
            statistic; must divide L + 1.
        device: where the generators live (default: the generator's
            device, else the card).

    Returns dict with ``ranks`` (``(n_sims, d)`` int array), ``chi2`` and
    ``p_value`` (``(d,)``, chi-squared against uniformity with
    ``n_bins - 1`` dof), plus the protocol constants.
    """
    L = int(n_rank_draws)
    if (L + 1) % int(n_bins) != 0:
        raise ValueError(
            f"n_bins={n_bins} must divide n_rank_draws + 1 = {L + 1} "
            f"(equiprobable bins need equal rank mass)")
    if device is None and isinstance(key, torch.Generator):
        device = key.device
    device = resolve_device(device)
    seed = key_seed(key)
    ranks = []
    for i in range(int(n_sims)):
        gens = [stream_generator(seed, i, s, device=device)
                for s in (_PRIOR, _SIMULATE, _FIT)]
        theta = torch.atleast_1d(torch.as_tensor(prior_sampler(gens[0])))
        data = simulator(gens[1], theta)
        draws = torch.as_tensor(posterior_sampler(gens[2], data))
        draws = draws[:: int(thin)]   # thin the draw axis (autocorrelation)
        draws = draws.reshape(-1, theta.shape[-1])  # then pool chains
        if draws.shape[0] < L:
            raise ValueError(
                f"posterior_sampler returned {draws.shape[0]} draws after "
                f"thin={thin}, need n_rank_draws={L}")
        draws = draws[:L]
        ranks.append((draws < theta[None, :].to(draws.device))
                     .sum(dim=0).cpu().numpy())
    ranks = np.stack(ranks)                       # (n_sims, d)
    chi2, p_value = _uniformity(ranks, L, n_bins, int(n_sims))
    return {"ranks": ranks, "chi2": chi2, "p_value": p_value,
            "n_rank_draws": L, "n_bins": int(n_bins), "n_sims": int(n_sims)}
