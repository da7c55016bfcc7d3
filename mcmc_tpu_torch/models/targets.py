"""Target log-kernels (PyTorch port of the flagship target of
``mcmc_tpu.models.targets``).

Log-kernels here are batched: ``log_kernel(theta: (n_chains, d)) ->
(n_chains,)``; a single ``(d,)`` vector gives a scalar.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mcmc_tpu_torch.samplers._resolve import resolve_device

__all__ = ["make_logistic_regression_data", "logistic_regression_model",
           "ill_conditioned_gaussian"]


def make_logistic_regression_data(seed: int, n_data: int, dim: int,
                                  dtype=torch.float32, device=None):
    """Synthetic logistic-regression data for the 100-d flagship benchmark,
    made with numpy from ``seed`` so that both packages can be handed the
    same data: ``X ~ N(0, 1/dim)``, ``beta_true ~ N(0, 1)``,
    ``y ~ Bernoulli(sigmoid(X beta_true))``. Returns ``(X, y, beta_true)``
    as tensors on ``device`` (default: the card). (The JAX package draws the same
    distributions from a JAX key, so its numbers differ.)"""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n_data, dim)) / np.sqrt(dim)
    beta_true = rng.standard_normal(dim)
    logits = X @ beta_true
    y = (rng.uniform(size=n_data) < 1.0 / (1.0 + np.exp(-logits)))
    to = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return to(X), to(y), to(beta_true)


def logistic_regression_model(X, y, prior_scale=10.0):
    """Bayesian logistic regression: Bernoulli likelihood with a
    ``N(0, prior_scale^2)`` prior. The hot op is the ``(n_chains, dim) x
    (dim, n_data)`` matmul of the chain batch."""
    X = torch.as_tensor(X)
    y = torch.as_tensor(y, dtype=X.dtype, device=X.device)

    def log_kernel(beta):
        logits = beta @ X.T
        ll = (y * logits - torch.nn.functional.softplus(logits)).sum(dim=-1)
        lp = -0.5 * (beta ** 2).sum(dim=-1) / prior_scale ** 2
        return ll + lp

    return log_kernel


def ill_conditioned_gaussian(dim: int, condition_number: float = 1e4,
                             dtype=torch.float32, device=None):
    """Zero-mean Gaussian with log-spaced marginal variances spanning the
    given condition number, the suite's stress target. The batched
    log-kernel carries them as ``.variances`` (on ``device``, default: the
    card)."""
    variances = torch.logspace(0.0, math.log10(condition_number), dim,
                               dtype=dtype, device=resolve_device(device))

    def log_kernel(x):
        return -0.5 * (x * x / variances).sum(dim=-1)

    log_kernel.variances = variances
    return log_kernel
