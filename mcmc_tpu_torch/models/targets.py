"""Target log-kernels (PyTorch port of ``mcmc_tpu.models.targets``: the
flagship target, the ill-conditioned Gaussian, the NUTS test targets, the
reference examples' Gaussian-mean, mixture, Fisher-metric and funnel
targets, the Poisson, Student-t and horseshoe regressions, and the latent-GP
pieces: the RBF Gram matrix, the Poisson latent GP and GP regression's exact
posterior).

Log-kernels here are batched: ``log_kernel(theta: (n_chains, d)) ->
(n_chains,)``; a single ``(d,)`` vector gives a scalar.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mcmc_tpu_torch.samplers._resolve import resolve_device

__all__ = ["make_logistic_regression_data", "logistic_regression_model",
           "ill_conditioned_gaussian", "gaussian_mean_model",
           "gaussian_mean_scale_model", "normal_fisher_metric",
           "banana_model", "gaussian_mixture_model", "neals_funnel",
           "eight_schools_model", "poisson_regression_model",
           "student_t_regression_model", "horseshoe_regression_model",
           "rbf_kernel", "latent_gp_poisson_model",
           "gp_regression_exact_posterior"]

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


def gaussian_mean_model(x_data, sigma=1.0, mu_0=1.0, sigma_0=2.0,
                        dtype=torch.float32, device=None):
    """Gaussian-mean posterior of reference examples/eigen/
    rwmh_normal_mean.cpp: likelihood N(mu, sigma^2) over ``x_data`` plus a
    N(mu_0, sigma_0^2) prior on the single parameter mu."""
    x = _data(x_data, dtype, device)
    n = x.shape[0]

    def log_kernel(params):
        mu = params[..., 0]
        ll = -n * (0.5 * LOG_2PI + math.log(sigma)) \
            - ((x - mu[..., None]) ** 2).sum(dim=-1) / (2.0 * sigma ** 2)
        lp = -0.5 * LOG_2PI - math.log(sigma_0) \
            - (mu - mu_0) ** 2 / (2.0 * sigma_0 ** 2)
        return ll + lp

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


def normal_fisher_metric(n_data: int):
    """Fisher metric for the (mu, sigma) normal model, the RM-HMC example's
    ``tensor_fn`` (reference examples/eigen/rmhmc_normal.cpp:78-111):
    ``G = diag(n/sigma^2, 2n/sigma^2)`` for each row of ``params``, so the
    batched ``metric_fn`` maps ``(c, 2) -> (c, 2, 2)``. It is built without
    in-place writes, so ``torch.func.jvp`` differentiates it (the sampler's
    derivative cube)."""

    def metric_fn(params):
        # a reciprocal and products, not a Python number over a tensor:
        # under torch.func.jvp that division takes a slow Python path
        inv_sq = torch.reciprocal(params[..., 1] ** 2)
        return torch.diag_embed(torch.stack(
            [n_data * inv_sq, (2.0 * n_data) * inv_sq], dim=-1))

    return metric_fn


def banana_model(b: float = 0.1, sigma: float = 10.0):
    """2-d banana (twisted Gaussian): x1 ~ N(0, sigma^2),
    x2 | x1 ~ N(b * (x1^2 - sigma^2), 1)."""

    def log_kernel(x):
        x1, x2 = x[..., 0], x[..., 1]
        return -0.5 * x1 ** 2 / sigma ** 2 \
            - 0.5 * (x2 - b * (x1 ** 2 - sigma ** 2)) ** 2

    return log_kernel


def gaussian_mixture_model(mu, sig_sq, weights, dtype=torch.float32,
                           device=None):
    """Isotropic Gaussian mixture (reference examples/eigen/
    aees_mixture.cpp:37-58). ``mu`` has shape (n_mix, n_vals), ``sig_sq`` and
    ``weights`` (n_mix,); computed with logsumexp instead of the reference's
    probability-space sum, identical up to rounding wherever the reference
    is finite."""
    mu = _data(mu, dtype, device)
    sig_sq = _data(sig_sq, dtype, mu.device)
    weights = _data(weights, dtype, mu.device)
    n_vals = mu.shape[1]
    # the terms that do not depend on x, once (the same values per call)
    log_w = torch.log(weights)
    log_norm = 0.5 * n_vals * torch.log(2.0 * math.pi * sig_sq)

    def log_kernel(x):
        dist_sq = ((x[..., None, :] - mu) ** 2).sum(dim=-1)
        log_comp = log_w - 0.5 * dist_sq / sig_sq - log_norm
        return torch.logsumexp(log_comp, dim=-1)

    return log_kernel


def neals_funnel(dim: int = 10, scale: float = 3.0):
    """Neal's funnel: v ~ N(0, scale^2), x_i | v ~ N(0, e^v). The classic
    pathological geometry for step-size/mass adaptation testing."""

    def log_kernel(params):
        v, x = params[..., 0], params[..., 1:]
        lp_v = -0.5 * v ** 2 / scale ** 2
        lp_x = -0.5 * (x ** 2).sum(dim=-1) * torch.exp(-v) \
            - 0.5 * (dim - 1) * v
        return lp_v + lp_x

    log_kernel.dim = dim
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


def poisson_regression_model(X, y, prior_scale=5.0, dtype=torch.float32,
                             device=None):
    """Poisson GLM with log link: ``y_i ~ Poisson(exp(x_i . beta))`` and a
    ``N(0, prior_scale^2)`` prior (the normalising ``log y!`` dropped)."""
    X = _data(X, dtype, device)
    y = _data(y, dtype, X.device)

    def log_kernel(beta):
        eta = beta @ X.T
        ll = (y * eta - torch.exp(eta)).sum(dim=-1)
        return ll - 0.5 * (beta ** 2).sum(dim=-1) / prior_scale ** 2

    return log_kernel


def student_t_regression_model(X, y, df=4.0, scale=1.0, prior_scale=10.0,
                               dtype=torch.float32, device=None):
    """Robust linear regression with Student-t errors (``df`` degrees of
    freedom, residual ``scale``) and a ``N(0, prior_scale^2)`` prior."""
    X = _data(X, dtype, device)
    y = _data(y, dtype, X.device)

    def log_kernel(beta):
        resid = (y - beta @ X.T) / scale
        ll = -0.5 * (df + 1.0) * torch.log1p(resid ** 2 / df).sum(dim=-1)
        return ll - 0.5 * (beta ** 2).sum(dim=-1) / prior_scale ** 2

    return log_kernel


def horseshoe_regression_model(X, y, sigma=1.0, tau_scale=1.0,
                               dtype=torch.float32, device=None):
    """Sparse linear regression with the horseshoe prior (Carvalho, Polson,
    Scott 2010), non-centered: parameters ``[beta_tilde_1..p,
    log_lambda_1..p, log_tau]`` (2p + 1 dims) with ``beta_j = beta_tilde_j
    * lambda_j * tau``, ``lambda_j ~ C+(0, 1)``, ``tau ~ C+(0,
    tau_scale)``; the half-Cauchy priors carry their log-transform
    Jacobians."""
    X = _data(X, dtype, device)
    y = _data(y, dtype, X.device)
    p = X.shape[1]

    def log_kernel(params):
        beta_t = params[..., :p]
        log_lam = params[..., p:2 * p]
        log_tau = params[..., 2 * p]
        lam = torch.exp(log_lam)
        tau = torch.exp(log_tau)
        beta = beta_t * lam * tau[..., None]
        ll = -0.5 * ((y - beta @ X.T) ** 2).sum(dim=-1) / sigma ** 2
        lp = -0.5 * (beta_t ** 2).sum(dim=-1)
        lp = lp + (-torch.log1p(lam ** 2) + log_lam).sum(dim=-1)
        lp = lp - torch.log1p((tau / tau_scale) ** 2) + log_tau
        return ll + lp

    log_kernel.dim = 2 * p + 1
    return log_kernel


def rbf_kernel(xs, length_scale=1.0, amplitude=1.0, jitter=1e-4,
               dtype=torch.float32, device=None):
    """Squared-exponential (RBF) Gram matrix over inputs ``xs`` of shape
    ``(n,)`` or ``(n, p)``, with ``jitter * amplitude**2`` on the diagonal:
    the prior covariance of the latent-GP models. The default jitter is
    sized for float32: a smooth kernel's Gram matrix over tens of points
    has eigenvalues below f32 resolution (1e-6 measured indefinite at
    n = 64, length_scale 0.5)."""
    xs = _data(xs, dtype, device)
    if xs.ndim == 1:
        xs = xs[:, None]
    d2 = ((xs[:, None, :] - xs[None, :, :]) ** 2).sum(dim=-1)
    n = xs.shape[0]
    return amplitude ** 2 * (torch.exp(-0.5 * d2 / length_scale ** 2)
                             + jitter * torch.eye(n, dtype=xs.dtype,
                                                  device=xs.device))


def latent_gp_poisson_model(xs, counts, length_scale=1.0, amplitude=1.0,
                            jitter=1e-4, dtype=torch.float32, device=None):
    """Latent GP with Poisson counts: ``f ~ GP(0, RBF)``, ``counts_i ~
    Poisson(exp(f_i))``. Returns ``(log_lik, prior_cov)`` shaped for
    :func:`mcmc_tpu_torch.elliptical_slice`, which handles the GP prior
    through the ellipse; ``log_lik`` is batched."""
    K = rbf_kernel(xs, length_scale, amplitude, jitter, dtype, device)
    counts = _data(counts, dtype, K.device)

    def log_lik(f):
        return (counts * f - torch.exp(f)).sum(dim=-1)

    return log_lik, K


def gp_regression_exact_posterior(K, y, noise_var):
    """Closed-form latent posterior of GP regression with Gaussian noise:
    ``mean = K (K + noise_var I)^-1 y``, ``cov = K - K (K + noise_var
    I)^-1 K``, the anchor of the latent-GP samplers. ``K`` and ``y`` as
    tensors (``y`` may be array-like: it goes to ``K``'s device)."""
    K = torch.as_tensor(K)
    y = torch.as_tensor(np.asarray(y) if not torch.is_tensor(y) else y,
                        dtype=K.dtype, device=K.device)
    n = K.shape[0]
    A = K + noise_var * torch.eye(n, dtype=K.dtype, device=K.device)
    sol = torch.linalg.solve(A, K)
    return K @ torch.linalg.solve(A, y), K - K @ sol
