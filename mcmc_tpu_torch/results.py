"""Result container returned by every sampler entry point (PyTorch port of
``mcmc_tpu.results``).

The reference returns draws through an out-parameter matrix and writes
``n_accept_draws`` back into the caller's settings struct
(reference src/rwmh.cpp:165-167); here both travel in one result object.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import torch

__all__ = ["SamplerResult"]


@dataclass
class SamplerResult:
    """Output of one sampling run.

    Attributes:
        draws: kept draws in *constrained* space, a tensor. Shape
            ``(n_keep, n_vals)`` for a single chain, ``(n_keep, n_chains,
            n_vals)`` for a chain batch.
        n_accept_draws: post-burn-in acceptance count (per chain when
            chains > 1), the reference's write-back field.
        diagnostics: sampler-specific extras (step sizes, energy errors,
            per-chain acceptance, ...).
    """

    draws: Any
    n_accept_draws: Any
    diagnostics: Dict[str, Any] = field(default_factory=dict)

    @property
    def accept_rate(self):
        """``n_accept_draws / n_keep_draws`` (reference convention,
        README.md:274, src/rwmh.cpp:140-142). With ``thin=k`` the keep
        phase makes ``n_keep*k`` transitions and ``n_accept_draws`` counts
        accepts over all of them, so the rate divides by the transition
        count (samplers record ``diagnostics["thin"]``) and stays a
        probability."""
        n_keep = self.draws.shape[0] * int(self.diagnostics.get("thin", 1))
        return torch.as_tensor(self.n_accept_draws).to(torch.float32) / n_keep

    @property
    def mean(self):
        """Posterior mean over draws (and chains, if present)."""
        d = torch.as_tensor(self.draws)
        return d.mean(dim=tuple(range(d.ndim - 1)))

    @property
    def var(self):
        d = torch.as_tensor(self.draws)
        return d.var(dim=tuple(range(d.ndim - 1)), unbiased=False)

    def summary(self):
        """Posterior summary with convergence diagnostics
        (:func:`mcmc_tpu_torch.diagnostics.summary`): mean, sd, MCSE, split
        R-hat, Geyer ESS, rank-normalized R-hat, bulk/tail ESS."""
        from mcmc_tpu_torch import diagnostics
        return diagnostics.summary(self.draws)

    def to_arviz(self, var_name: str = "x"):
        """Convert to an ``arviz.InferenceData`` (requires the optional
        ``arviz`` package; raises ImportError with guidance otherwise).
        Draws are exposed as (chain, draw, dim) under ``var_name``;
        per-draw diagnostics with matching shapes go to ``sample_stats``."""
        try:
            import arviz as az
        except ImportError as e:
            raise ImportError(
                "SamplerResult.to_arviz() needs the optional 'arviz' "
                "package (pip install arviz)") from e
        import numpy as np
        as_np = lambda v: v.detach().cpu().numpy() if torch.is_tensor(v) \
            else np.asarray(v)
        d = as_np(self.draws)
        if d.ndim == 2:
            d = d[:, None, :]
        posterior = {var_name: np.moveaxis(d, 0, 1)}   # (chain, draw, dim)
        stats = {}
        n_keep, n_chains = d.shape[0], d.shape[1]
        for k, v in self.diagnostics.items():
            v = as_np(v)
            if v.shape[:2] == (n_keep, n_chains):
                stats[k] = np.moveaxis(v, 0, 1)
        return az.from_dict(posterior=posterior,
                            sample_stats=stats or None)
