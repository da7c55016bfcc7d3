"""Predictive model comparison: WAIC and PSIS-LOO cross-validation
(PyTorch port of ``mcmc_tpu.model_compare``).

Every computation is batched over observations and posterior draws: the
Pareto smoothing of all observations is one batched sort and one batched
generalized-Pareto fit, with no loop over observations, so the functions
run on the card at any ``(S, n_obs)`` scale, on the device of their input.

Algorithms:

- **WAIC** (Watanabe 2010; Gelman, Hwang & Vehtari 2014): pointwise
  ``elpd_i = lpd_i - p_waic_i`` with ``lpd_i = log mean_s exp ll_si`` and
  ``p_waic_i = Var_s[ll_si]``.
- **PSIS-LOO** (Vehtari, Gelman & Gabry 2017): leave-one-out importance
  ratios ``r_si = 1 / p(y_i | theta_s)`` stabilized by fitting a
  generalized Pareto distribution to the ``M = min(0.2 S, 3 sqrt(S))``
  largest ratios per observation and replacing them with the fitted
  quantiles, truncated at the raw maximum. The GPD fit is the Zhang &
  Stephens (2009) empirical-Bayes profile estimator with the weak
  ``(k + 0.5·10)/(n + 10)`` prior regularization of Vehtari et al. The
  per-observation shape ``pareto_k`` is the reliability diagnostic (k > 0.7
  = unreliable).

Shapes: ``log_lik`` is ``(n_draws, n_chains, n_obs)`` (the layout
:func:`pointwise_log_lik` produces from a ``SamplerResult``) or a flattened
``(S, n_obs)``. API differences from the JAX package: ``log_lik_fn`` is
batched over draws, ``log_lik_fn(params: (B, d)) -> (B, n_obs)``; a
tensor stays on its device, and anything else goes to ``device=``
(default: the card), as in the samplers.
"""

from __future__ import annotations

import math

import torch

from mcmc_tpu_torch.samplers._resolve import resolve_device

__all__ = ["pointwise_log_lik", "waic", "psis_loo", "compare", "gpd_fit"]


def pointwise_log_lik(draws, log_lik_fn, device=None):
    """Evaluate a batched pointwise log-likelihood ``log_lik_fn(theta: (B,
    d)) -> (B, n_obs)`` over every kept draw.

    ``draws`` is ``(n_draws, d)`` or ``(n_draws, n_chains, d)`` (the
    ``SamplerResult.draws`` layouts); returns ``(n_draws, n_obs)`` or
    ``(n_draws, n_chains, n_obs)`` respectively, ready for :func:`waic` /
    :func:`psis_loo`. One call of ``log_lik_fn`` on all draws.
    """
    draws = torch.as_tensor(draws, device=resolve_device(device, draws))
    if draws.ndim == 2:
        return log_lik_fn(draws)
    if draws.ndim == 3:
        n, c, d = draws.shape
        return log_lik_fn(draws.reshape(n * c, d)).reshape(n, c, -1)
    raise ValueError(f"draws must be 2-D or 3-D, got shape "
                     f"{tuple(draws.shape)}")


def _flatten_ll(log_lik, device):
    ll = torch.as_tensor(log_lik, device=resolve_device(device, log_lik))
    if ll.ndim == 3:
        ll = ll.reshape(ll.shape[0] * ll.shape[1], ll.shape[2])
    if ll.ndim != 2:
        raise ValueError(
            f"log_lik must be (S, n_obs) or (n_draws, n_chains, n_obs), "
            f"got shape {tuple(ll.shape)}")
    return ll


def _summarize(elpd_i, p_i, extra=None):
    n = elpd_i.shape[0]
    out = {
        "elpd": elpd_i.sum(),
        "p_eff": p_i.sum(),
        "se": torch.sqrt(n * elpd_i.var(unbiased=False)),
        "pointwise": elpd_i,
        "n_obs": n,
    }
    if extra:
        out.update(extra)
    return out


def waic(log_lik, device=None):
    """Widely applicable information criterion.

    Returns a dict with ``elpd`` (expected log pointwise predictive
    density, higher is better), ``p_eff`` (effective parameter count),
    ``se`` (standard error of ``elpd``), and ``pointwise`` (per-obs elpd,
    feeds :func:`compare`).
    """
    ll = _flatten_ll(log_lik, device)
    S = ll.shape[0]
    lpd = torch.logsumexp(ll, dim=0) - math.log(S)
    p_waic = ll.var(dim=0, unbiased=True)
    return _summarize(lpd - p_waic, p_waic)


# -- generalized Pareto fit (Zhang & Stephens 2009, profile posterior mean,
#    with the Vehtari-et-al. prior regularization of k) --------------------

_PRIOR_BS = 3.0
_PRIOR_K = 10.0


def gpd_fit(x):
    """Fit GPD(k, sigma) to exceedances ``x`` (``(..., n)``, all > 0,
    ASCENDING along the last axis), each row on its own.

    Returns ``(k, sigma)`` of shape ``(...)`` in the Vehtari-et-al. sign
    convention (k > 0 = heavy tail).
    """
    x = torch.as_tensor(x)
    n = x.shape[-1]
    m_est = 30 + int(math.isqrt(n))
    jj = torch.arange(1, m_est + 1, dtype=x.dtype, device=x.device)
    xstar = x[..., int(n / 4 + 0.5) - 1]  # first-quartile order statistic
    # tied draws can make the lower tail exactly 0 (discrete likelihoods,
    # f32 rounding); a zero quartile would put inf into the b grid and NaN
    # the fit, so fall back to the smallest POSITIVE exceedance
    pos_min = torch.where(x > 0, x, x[..., -1:]).amin(dim=-1)
    xstar = torch.where(xstar > 0, xstar, pos_min)
    b = 1.0 / x[..., -1:] + (1.0 - torch.sqrt(m_est / (jj - 0.5))) \
        / (_PRIOR_BS * xstar[..., None])                        # (..., m_est)
    # profile log-likelihood of theta=b: k(b) = mean log1p(-b x)
    k_b = torch.log1p(-b[..., :, None] * x[..., None, :]).mean(dim=-1)
    profile = n * (torch.log(-b / k_b) - k_b - 1.0)
    w = torch.softmax(profile, dim=-1)    # posterior weights over the grid
    b_post = (b * w).sum(dim=-1)
    k_post = torch.log1p(-b_post[..., None] * x).mean(dim=-1)
    # sigma comes from the UNregularized k: the prior pull toward 0.5 can
    # flip k's sign relative to b, which would make sigma negative and the
    # fitted quantiles invalid
    sigma = -k_post / b_post
    k_reg = (n * k_post + _PRIOR_K * 0.5) / (n + _PRIOR_K)
    return k_reg, sigma


def _gpd_quantiles(p, k, sigma):
    """Inverse CDF of GPD(k, sigma) at ``p`` (``(M,)``) for each row of
    ``k``, ``sigma`` (``(...)``): ``(..., M)``, sigma/k * ((1-p)^-k - 1);
    the k -> 0 limit -sigma*log1p(-p) is taken through expm1."""
    k, sigma = k[..., None], sigma[..., None]
    small = k.abs() < 1e-12
    k_safe = torch.where(small, torch.ones_like(k), k)
    general = sigma / k_safe * torch.expm1(-k_safe * torch.log1p(-p))
    limit = -sigma * torch.log1p(-p)
    return torch.where(small, limit, general)


def _psis_smooth(lw, M):
    """Smooth the log importance ratios ``lw`` (``(..., S)``) of every row
    at once: one batched sort, one batched GPD fit.

    Returns (normalized smoothed log-weights ``(..., S)``, pareto_k
    ``(...)``). Each row's top-M ratios are replaced by the fitted GPD's
    expected order statistics (quantiles at (j+0.5)/M), truncated at the
    raw maximum, as in Vehtari, Gelman & Gabry 2017 §3.2.
    """
    S = lw.shape[-1]
    lw = lw - lw.amax(dim=-1, keepdim=True)  # ratios in (0, 1]; max = 1
    lw_sorted, order = torch.sort(lw, dim=-1, stable=True)
    cutoff_lw = lw_sorted[..., S - M - 1]
    tail_lw = lw_sorted[..., S - M:]
    cut = torch.exp(cutoff_lw)
    x = torch.exp(tail_lw) - cut[..., None]  # exceedances, ascending
    # Two degenerate tails, with OPPOSITE reliability semantics:
    #  - flat: no spread above the cutoff (tied weights) — the importance
    #    distribution is well behaved; report k = 0, nothing to smooth.
    #  - concentrated: the (S-M-1)th ratio underflows vs the max, i.e.
    #    essentially ALL importance mass sits in <= M draws — maximally
    #    unreliable; report k = +inf so every "k > 0.7" check fires.
    flat = x[..., -1] <= 0
    concentrated = cutoff_lw <= math.log(torch.finfo(lw.dtype).tiny)
    fit_ok = ~flat & ~concentrated
    ramp = torch.arange(1, M + 1, dtype=lw.dtype, device=lw.device)
    x_safe = torch.where(fit_ok[..., None], x, ramp)
    k, sigma = gpd_fit(x_safe)
    p = (torch.arange(M, dtype=lw.dtype, device=lw.device) + 0.5) / M
    smoothed = torch.log(cut[..., None] + _gpd_quantiles(p, k, sigma))
    smoothed = torch.clamp_max(smoothed, 0.0)  # truncate at the raw max
    ok = fit_ok & torch.isfinite(k) & torch.isfinite(sigma) & (sigma > 0)
    new_tail = torch.where(ok[..., None], smoothed, tail_lw)
    out = lw.scatter(-1, order[..., S - M:], new_tail)
    out = out - torch.logsumexp(out, dim=-1, keepdim=True)  # self-normalize
    k_out = torch.where(flat, torch.zeros_like(k),
                        torch.where(ok, k, torch.full_like(k, math.inf)))
    return out, k_out


def _psis_smooth_one(lw, M):
    """Smooth one set of log importance ratios ``lw (S,)`` (the pooled
    weights Pathfinder resamples): :func:`_psis_smooth` on one row."""
    out, k = _psis_smooth(lw[None], M)
    return out[0], k[0]


def psis_loo(log_lik, device=None):
    """Pareto-smoothed importance-sampling leave-one-out cross-validation.

    Returns a dict with ``elpd``, ``p_eff``, ``se``, ``pointwise``, and
    ``pareto_k`` (per-observation GPD shape; k > 0.7 flags observations
    whose LOO estimate is unreliable — refit without them or use K-fold).
    Degenerate tails report conservative shapes: exactly-tied tail weights
    give ``pareto_k = 0`` (benign), while a tail so concentrated the fit
    is impossible gives ``pareto_k = inf`` (always flagged).
    """
    ll = _flatten_ll(log_lik, device)
    S, n_obs = ll.shape
    M = int(min(0.2 * S, 3.0 * math.sqrt(S)))
    if M < 5:
        raise ValueError(
            f"PSIS needs a tail of >= 5 draws to fit; got M={M} from "
            f"S={S} total draws — run the sampler for more draws")
    llt = ll.T                                   # (n_obs, S)
    lw, khat = _psis_smooth(-llt, M)
    elpd_i = torch.logsumexp(llt + lw, dim=-1)   # lw normalized per obs
    lpd_i = torch.logsumexp(llt, dim=-1) - math.log(S)
    return _summarize(elpd_i, lpd_i - elpd_i, extra={"pareto_k": khat})


def compare(results):
    """Rank models by elpd.

    ``results`` maps model name -> the dict returned by :func:`waic` or
    :func:`psis_loo` (or any dict with a ``pointwise`` per-observation elpd
    vector over the SAME observations). Returns a list of dicts, best
    first, each with ``name``, ``rank``, ``elpd``, ``se``, ``elpd_diff``
    (vs the best model) and ``se_diff`` (paired SE of the difference —
    Vehtari et al. 2017 §5.2). A |elpd_diff| > 2*se_diff is conventionally
    decisive.
    """
    if len(results) < 2:
        raise ValueError("compare needs at least two models")
    pw = {}
    n_ref = None
    for name, r in results.items():
        p = torch.as_tensor(r["pointwise"])
        if n_ref is None:
            n_ref = p.shape[0]
        elif p.shape[0] != n_ref:
            raise ValueError(
                f"model {name!r} has {p.shape[0]} pointwise terms, "
                f"others have {n_ref}; models must score the same data")
        pw[name] = p
    order = sorted(pw, key=lambda k: -float(pw[k].sum()))
    best = pw[order[0]]
    out = []
    for rank, name in enumerate(order):
        d = best - pw[name]
        n = d.shape[0]
        out.append({
            "name": name,
            "rank": rank,
            "elpd": float(pw[name].sum()),
            "se": float(torch.sqrt(n * pw[name].var(unbiased=False))),
            "elpd_diff": float(d.sum()),
            "se_diff": float(torch.sqrt(n * d.var(unbiased=False))),
        })
    return out
