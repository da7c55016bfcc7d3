"""Convergence diagnostics (PyTorch port of the split R-hat and ESS family
of ``mcmc_tpu.diagnostics``).

All functions take ``draws`` of shape ``(n_draws, n_chains, n_vals)`` (a
single chain may pass ``(n_draws, n_vals)``) as a tensor on any device, or
anything ``torch.as_tensor`` accepts, and return per-dimension tensors on
the same device.
"""

from __future__ import annotations

import math

import torch

__all__ = ["split_rhat", "ess", "rank_normalized_rhat", "bulk_ess",
           "tail_ess"]


def _ensure_3d(draws):
    draws = torch.as_tensor(draws)
    if draws.ndim == 2:
        draws = draws[:, None, :]
    return draws


def split_rhat(draws):
    """Split-chain potential scale reduction factor (Gelman-Rubin).

    Each chain is split in half, giving m = 2 * n_chains sequences; returns
    the per-dimension R-hat vector."""
    draws = _ensure_3d(draws)
    n = draws.shape[0] // 2
    halves = torch.cat([draws[:n], draws[n:2 * n]], dim=1)   # (n, 2m, dim)
    chain_means = halves.mean(dim=0)                         # (2m, dim)
    chain_vars = halves.var(dim=0, unbiased=True)
    w = chain_vars.mean(dim=0)
    b = n * chain_means.var(dim=0, unbiased=True)
    var_plus = (n - 1) / n * w + b / n
    return torch.sqrt(var_plus / w)


def _next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m *= 2
    return m


def _autocov_fft(x):
    """Autocovariance along axis 0 via FFT, biased (divided by n)."""
    n = x.shape[0]
    m = _next_pow2(2 * n)
    xc = x - x.mean(dim=0, keepdim=True)
    f = torch.fft.rfft(xc, n=m, dim=0)
    acov = torch.fft.irfft(f * torch.conj(f), n=m, dim=0)[:n]
    return acov / n


def ess(draws, chain_chunk=None):
    """Effective sample size with Geyer's initial monotone sequence
    estimator, combined across chains (Stan-style: mean autocovariance
    across chains over the pooled variance). Returns the per-dimension ESS.

    ``chain_chunk=k`` computes the per-chain autocovariance FFT in chain
    blocks of ``k``, bounding the FFT workspace to O(k * n * dim) for large
    chain batches on the device; ``k`` must divide ``n_chains``."""
    draws = _ensure_3d(draws)
    n, m, dim = draws.shape

    if chain_chunk is not None and m > int(chain_chunk):
        c = int(chain_chunk)
        if m % c != 0:
            raise ValueError(f"chain_chunk={c} must divide n_chains={m}")
        acov_sum = sum(_autocov_fft(draws[:, i:i + c]).sum(dim=1)
                       for i in range(0, m, c))
        mean_acov = acov_sum / m                                  # (n, dim)
    else:
        mean_acov = _autocov_fft(draws).mean(dim=1)               # (n, dim)
    chain_means = draws.mean(dim=0)                               # (m, dim)
    var_plus = mean_acov[0] * n / (n - 1)
    if m > 1:
        var_plus = var_plus + chain_means.var(dim=0, unbiased=True)

    # rho_t = 1 - (W - mean_acov_t) / var_plus
    rho = 1.0 - (mean_acov[0] - mean_acov) / var_plus             # (n, dim)

    # Geyer: Stan's pairing P_k = rho_{2k} + rho_{2k+1} starting at rho_0;
    # keep while positive, enforce a monotone non-increasing envelope,
    # tau = -1 + 2 * sum(P_kept).
    n_pairs = n // 2
    pair_sums = rho[0:2 * n_pairs:2] + rho[1:2 * n_pairs:2]
    keep = torch.cumprod((pair_sums > 0).to(torch.int32), dim=0).bool()
    capped = torch.cummin(torch.where(keep, pair_sums, 0.0), dim=0).values
    tau = -1.0 + 2.0 * torch.where(keep, capped, 0.0).sum(dim=0)
    tau = torch.clamp_min(tau, 1.0 / math.log10(float(n * m)))
    return n * m / tau


def _rank_normalize(draws):
    """Fractional-rank normal-score transform (Vehtari et al. 2021 eq. 14):
    pooled ranks over (draws, chains) per dimension mapped through the
    normal quantile function with the (r - 3/8)/(S + 1/4) offset."""
    n, m, dim = draws.shape
    flat = draws.reshape(n * m, dim)
    # double stable argsort gives 0-based ranks, ties broken by order
    ranks = torch.argsort(torch.argsort(flat, dim=0, stable=True), dim=0,
                          stable=True).to(draws.dtype)
    z = torch.special.ndtri((ranks + 1.0 - 0.375) / (n * m + 0.25))
    return z.reshape(n, m, dim)


def _split_chains(draws):
    """Split each chain in half: (n, m, d) -> (n//2, 2m, d), so within-chain
    nonstationarity surfaces as between-sequence variance (Vehtari et al.
    2021 §3.1)."""
    n = draws.shape[0] // 2
    return torch.cat([draws[:n], draws[n:2 * n]], dim=1)


def _pooled_quantiles(draws, qs, midpoint=False):
    """Quantiles over (draws, chains) per dimension by one sort
    (``torch.quantile`` caps its input size), with ``jnp.quantile``'s
    arithmetic: the position ``q * (S - 1)`` and the interpolation weights
    in the draws' dtype; ``midpoint=True`` averages the two neighbours, as
    ``jnp.median`` does."""
    n, m, dim = draws.shape
    size = n * m
    srt = torch.sort(draws.reshape(size, dim), dim=0).values
    out = []
    for q in qs:
        pos = torch.tensor(q, dtype=draws.dtype) * (size - 1)
        lo = int(torch.floor(pos))
        hi = min(int(torch.ceil(pos)), size - 1)
        if midpoint:
            out.append((srt[lo] + srt[hi]) * 0.5)
        else:
            hw = pos - lo
            out.append(srt[lo] * (1.0 - hw).item() + srt[hi] * hw.item())
    return out


def rank_normalized_rhat(draws):
    """Rank-normalized split R-hat (Vehtari, Gelman, Simpson, Carpenter,
    Burkner 2021): the max of split R-hat on rank-normalized draws (bulk)
    and on rank-normalized folded draws |x - median| (tails). Use <= 1.01
    as the pass criterion."""
    draws = _ensure_3d(draws)
    z = _rank_normalize(draws)
    (median,) = _pooled_quantiles(draws, [0.5], midpoint=True)
    zf = _rank_normalize(torch.abs(draws - median))
    return torch.maximum(split_rhat(z), split_rhat(zf))


def bulk_ess(draws, chain_chunk=None):
    """Bulk effective sample size: Geyer ESS of rank-normalized *split*
    chains (Vehtari et al. 2021; matches Stan/arviz ess_bulk)."""
    draws = _ensure_3d(draws)
    return ess(_rank_normalize(_split_chains(draws)), chain_chunk=chain_chunk)


def tail_ess(draws, chain_chunk=None):
    """Tail effective sample size: the min of the split-chain ESS of the 5%
    and 95% quantile exceedance indicators (Vehtari et al. 2021 §4.3;
    matches Stan/arviz ess_tail)."""
    draws = _ensure_3d(draws)
    q05, q95 = _pooled_quantiles(draws, [0.05, 0.95])
    split = _split_chains(draws)
    e05 = ess((split <= q05).to(draws.dtype), chain_chunk=chain_chunk)
    e95 = ess((split <= q95).to(draws.dtype), chain_chunk=chain_chunk)
    return torch.minimum(e05, e95)
