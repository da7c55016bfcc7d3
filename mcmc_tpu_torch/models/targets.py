"""Target log-kernels (PyTorch port of the flagship target, the
ill-conditioned Gaussian and the NUTS test targets of
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
           "ill_conditioned_gaussian", "gaussian_mean_scale_model",
           "banana_model", "eight_schools_model"]

LOG_2PI = math.log(2.0 * math.pi)

# Rubin (1981): the eight schools' estimated effects and standard errors
EIGHT_SCHOOLS_Y = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
EIGHT_SCHOOLS_SIGMA = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0,
                                18.0])


def _data(a, dtype, device):
    """``a`` as a tensor: a tensor keeps its device unless ``device`` is
    given; anything else goes to ``device`` (default: the card)."""
    return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                           dtype=dtype, device=resolve_device(device, a))


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


def gaussian_mean_scale_model(x_data, dtype=torch.float32, device=None):
    """(mu, sigma) likelihood of reference examples/eigen/hmc_normal.cpp:
    46-62 over ``x_data`` — no prior, sigma sampled directly (non-positive
    sigma yields NaN, which samplers reject)."""
    x = _data(x_data, dtype, device)
    n = x.shape[0]

    def log_kernel(params):
        mu, sigma = params[..., 0], params[..., 1]
        return -n * (0.5 * LOG_2PI + torch.log(sigma)) \
            - ((x - mu[..., None]) ** 2).sum(dim=-1) / (2.0 * sigma ** 2)

    return log_kernel


def banana_model(b: float = 0.1, sigma: float = 10.0):
    """2-d banana (twisted Gaussian): x1 ~ N(0, sigma^2),
    x2 | x1 ~ N(b * (x1^2 - sigma^2), 1)."""

    def log_kernel(x):
        x1, x2 = x[..., 0], x[..., 1]
        return -0.5 * x1 ** 2 / sigma ** 2 \
            - 0.5 * (x2 - b * (x1 ** 2 - sigma ** 2)) ** 2

    return log_kernel


def eight_schools_model(y=None, sigma=None, non_centered=True,
                        tau_prior="lognormal", dtype=torch.float32,
                        device=None):
    """The eight-schools hierarchical model (Rubin 1981). Parameters are
    ``[mu, log_tau, theta_tilde_1..8]`` (non-centered) or ``[mu, log_tau,
    theta_1..8]`` (centered); 10-dimensional. ``y`` and ``sigma`` default
    to the published data (:data:`EIGHT_SCHOOLS_Y`,
    :data:`EIGHT_SCHOOLS_SIGMA`). ``tau_prior="half_cauchy"`` uses the
    Stan-manual priors (mu ~ N(0, 5), tau ~ HalfCauchy(0, 5)); the default
    is the log-normal tau of the JAX package's default."""
    y = _data(EIGHT_SCHOOLS_Y if y is None else y, dtype, device)
    sigma = _data(EIGHT_SCHOOLS_SIGMA if sigma is None else sigma, dtype,
                  y.device)

    def log_kernel(params):
        mu, log_tau = params[..., 0], params[..., 1]
        tau = torch.exp(log_tau)
        if tau_prior == "half_cauchy":
            # log p(tau) + log|dtau/dlog_tau| = -log(1 + (tau/5)^2) + log_tau
            lp = -0.5 * (mu / 5.0) ** 2 - torch.log1p((tau / 5.0) ** 2) \
                + log_tau
        else:
            lp = -0.5 * (mu / 5.0) ** 2 - 0.5 * (log_tau / 5.0) ** 2
        if non_centered:
            theta_t = params[..., 2:]
            theta = mu[..., None] + tau[..., None] * theta_t
            lp = lp - 0.5 * (theta_t ** 2).sum(dim=-1)
        else:
            theta = params[..., 2:]
            lp = lp - 0.5 * ((theta - mu[..., None]) ** 2).sum(dim=-1) \
                / tau ** 2 - 8.0 * log_tau
        return lp - 0.5 * ((y - theta) ** 2 / sigma ** 2).sum(dim=-1)

    log_kernel.dim = 10
    return log_kernel
