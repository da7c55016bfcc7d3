"""Probability-density helpers (PyTorch port of ``mcmc_tpu.stats``).

Vectorized analogs of the reference's ``stats_mcmc`` namespace
(reference include/stats/dnorm.hpp:90-206, dmvnorm.hpp:28-54). The MVN
log-pdf is used by MALA's proposal-asymmetry correction
(reference include/mcmc/mala.ipp:30-70).

The factorisations here never check their result on the host: on the card
``torch.linalg.cholesky`` and ``solve`` would read their ``info`` back, one
host synchronisation per call. Where the JAX package's factorisation fails
it carries NaN on, and so does :func:`cholesky_or_nan`.
"""

from __future__ import annotations

import math

import torch

__all__ = ["dnorm", "dmvnorm", "LOG_2PI", "gumbel_topk",
           "gumbel_topk_from_uniforms", "cholesky_or_nan"]

LOG_2PI = math.log(2.0 * math.pi)


def cholesky_or_nan(m):
    """Lower Cholesky factor of each matrix of ``m`` (``(..., k, k)``),
    NaN where the factorisation fails, as ``jnp.linalg.cholesky`` returns
    it; no host synchronisation."""
    chol, info = torch.linalg.cholesky_ex(m)
    return torch.where((info == 0)[..., None, None], chol, torch.nan)


def dnorm(x, mu=0.0, sigma=1.0, log=False):
    """Normal density (reference dnorm.hpp:90-206), element-wise.

    The reference's inf/NaN ladder reduces to IEEE arithmetic here: a
    zero-width sigma yields +inf at x == mu and 0 elsewhere, and non-finite
    inputs propagate NaN."""
    x = torch.as_tensor(x)
    z = (x - mu) / sigma
    log_pdf = -0.5 * LOG_2PI - torch.log(torch.as_tensor(sigma, dtype=x.dtype,
                                                         device=x.device)) \
        - 0.5 * z * z
    return log_pdf if log else torch.exp(log_pdf)


def dmvnorm(x, mu, sigma, log=False, batched=False):
    """Multivariate-normal (log-)density (reference dmvnorm.hpp:28-54) of
    each row of ``x`` (``(..., k)``).

    ``sigma`` may be a scalar (isotropic), a ``(k,)`` diagonal, or a
    ``(k, k)`` covariance matrix (``(..., k, k)`` broadcasts over the rows),
    as in the JAX package. With ``batched=True`` its leading axis runs over
    the rows of ``x`` instead: ``(n,)`` one scalar per row, ``(n, k)`` one
    diagonal per row, ``(n, k, k)`` one matrix per row. The matrix path
    uses a Cholesky solve; a matrix that is not positive definite gives
    NaN."""
    x = torch.as_tensor(x)
    k = x.shape[-1]
    cent = x - torch.as_tensor(mu, dtype=x.dtype, device=x.device)
    sigma = torch.as_tensor(sigma, dtype=x.dtype, device=x.device)
    kind = sigma.ndim - (1 if batched else 0)

    if kind < 2:
        var = sigma[..., None] if kind == 0 else sigma
        var = var.expand(cent.shape)
        quad = (cent * cent / var).sum(dim=-1)
        logdet = torch.log(var).sum(dim=-1)
    else:
        chol = cholesky_or_nan(sigma)
        w = torch.linalg.solve_triangular(chol, cent[..., None],
                                          upper=False)[..., 0]
        quad = (w * w).sum(dim=-1)
        logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2,
                                                dim2=-1)).sum(dim=-1)

    ret = -0.5 * k * LOG_2PI - 0.5 * (logdet + quad)
    if not log:
        ret = torch.exp(ret)
        ret = torch.where(torch.isinf(ret), torch.finfo(x.dtype).max, ret)
    return ret


def gumbel_topk(gen, log_weights, n):
    """Indices of ``n`` draws WITHOUT replacement proportional to
    ``exp(log_weights)`` via the Gumbel top-k trick (no reference analog),
    with the uniforms drawn from the ``torch.Generator`` ``gen``."""
    u = torch.rand(log_weights.shape, generator=gen, dtype=log_weights.dtype,
                   device=log_weights.device)
    return gumbel_topk_from_uniforms(u, log_weights, n)


def gumbel_topk_from_uniforms(u, log_weights, n):
    """:func:`gumbel_topk` given its uniforms ``u`` in [0, 1), one per
    weight (mapped to [1e-12, 1) as the JAX package's ``minval`` does)."""
    u = 1e-12 + (1.0 - 1e-12) * u
    g = -torch.log(-torch.log(u))
    return torch.argsort(log_weights + g, descending=True)[: int(n)]
