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
