"""Step-size and mass adaptation (PyTorch port of ``mcmc_tpu.adaptation``).

The reference's only adaptation is NUTS's dual averaging (src/nuts.cpp:
294-302); this module provides the same Nesterov dual-averaging recursion as
a state machine, plus the Stan-style windowed mass estimation. Every state
tensor carries the chain batch on its leading axis, one adaptation per
chain, as the JAX package's vmapped kernels keep it. Where the JAX package
pools an estimate with ``lax.pmean`` over a named chain axis, ``pooled=True``
here takes the mean over the chain axis.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["DualAveraging", "da_init", "da_update", "TARGET_ACCEPT",
           "window_schedule", "WindowedVariance", "wv_init", "wv_update",
           "windowed_mass_update"]

TARGET_ACCEPT = {"rwmh": 0.234, "mala": 0.574, "hmc": 0.8, "barker": 0.574,
                 "ghmc": 0.95}


class DualAveraging(NamedTuple):
    log_eps: torch.Tensor      # current (tuned) log step size
    log_eps_bar: torch.Tensor  # averaged iterate, used after adaptation ends
    h: torch.Tensor
    t: torch.Tensor            # adaptation step counter
    mu: torch.Tensor           # shrink target log(10 * eps_0)


def da_init(eps0):
    eps0 = torch.as_tensor(eps0)
    return DualAveraging(
        log_eps=torch.log(eps0),
        log_eps_bar=torch.log(eps0),
        h=torch.zeros_like(eps0),
        t=torch.zeros_like(eps0),
        mu=torch.log(10.0 * eps0),
    )


def da_update(state: DualAveraging, accept_stat, target,
              gamma=0.05, t0=10.0, kappa=0.75) -> DualAveraging:
    """One dual-averaging step (same recursion as reference src/nuts.cpp:
    294-302, with the step counter inside the state)."""
    t = state.t + 1.0
    h = state.h + (1.0 / (t + t0)) * (target - accept_stat - state.h)
    log_eps = state.mu - h * torch.sqrt(t) / gamma
    w = t ** (-kappa)
    log_eps_bar = (1.0 - w) * state.log_eps_bar + w * log_eps
    return DualAveraging(log_eps=log_eps, log_eps_bar=log_eps_bar,
                         h=h, t=t, mu=state.mu)


def window_schedule(n_adapt: int, device=None):
    """Stan-style warmup schedule: an initial fast interval, doubling slow
    windows in which posterior variance is accumulated, and a terminal fast
    interval. Returns (collect_mask, window_end_mask) as length-n_adapt
    boolean tensors."""
    collect = np.zeros(max(n_adapt, 1), bool)
    window_end = np.zeros(max(n_adapt, 1), bool)
    init_fast = min(75, int(0.15 * n_adapt))
    term_fast = min(50, int(0.1 * n_adapt))
    b, e = init_fast, n_adapt - term_fast
    if e - b >= 20:
        collect[b:e] = True
        w = 25
        pos = b
        while pos < e:
            end = pos + w
            if end * 2 - pos > e:  # last window absorbs the remainder
                end = e
            window_end[min(end, e) - 1] = True
            pos = end
            w *= 2
    return (torch.as_tensor(collect, device=device),
            torch.as_tensor(window_end, device=device))


def windowed_mass_update(count, mean, m2, inv_mass, chol, x,
                         collecting, window_end, mode, pooled=False):
    """One draw of windowed Welford mass estimation per chain (diag or
    dense). Folds ``x`` ``(n_chains, d)`` where ``collecting``
    ``(n_chains,)``; at ``window_end`` adopts the regularized (co)variance —
    Stan-style ``n/(n+5)`` shrinkage toward ``1e-3 (I)`` — as the new
    inverse mass (+ its Cholesky in dense mode) and resets the accumulator.
    ``pooled=True`` averages the chains' ``m2 / (n - 1)`` over the chain
    axis before the shrinkage, as the JAX package's ``lax.pmean`` over the
    named chain axis does, so that every chain adopts one estimate.
    Returns ``(count, mean, m2, inv_mass, chol)``."""
    dtype = x.dtype
    cnt1 = count + 1
    delta = x - mean
    mean1 = mean + delta / cnt1.to(dtype)[:, None]
    if mode == "dense":
        m21 = m2 + delta[:, :, None] * (x - mean1)[:, None, :]
        col = collecting[:, None, None]
        wend = window_end[:, None, None]
    else:
        m21 = m2 + delta * (x - mean1)
        col = collecting[:, None]
        wend = window_end[:, None]
    count = torch.where(collecting, cnt1, count)
    mean = torch.where(collecting[:, None], mean1, mean)
    m2 = torch.where(col, m21, m2)

    n = torch.clamp_min(count, 2).to(dtype)
    shrink = 1e-3 * (5.0 / (n + 5.0))
    if mode == "dense":
        n3 = n[:, None, None]
        var = m2 / (n3 - 1.0)
        if pooled:
            var = var.mean(dim=0, keepdim=True)
        eye = torch.eye(x.shape[1], dtype=dtype, device=x.device)
        var = (n3 / (n3 + 5.0)) * 0.5 * (var + var.transpose(1, 2)) \
            + shrink[:, None, None] * eye
        # cholesky_ex: a failed factorisation must not raise mid-run (the
        # JAX package gets NaNs there, which the where discards off-window)
        chol = torch.where(wend, torch.linalg.cholesky_ex(var)[0], chol)
    else:
        n2 = n[:, None]
        var = m2 / (n2 - 1.0)
        if pooled:
            var = var.mean(dim=0, keepdim=True)
        var = (n2 / (n2 + 5.0)) * var + shrink[:, None]
    inv_mass = torch.where(wend, var, inv_mass)
    count = torch.where(window_end, torch.zeros_like(count), count)
    mean = torch.where(window_end[:, None], torch.zeros_like(mean), mean)
    m2 = torch.where(wend, torch.zeros_like(m2), m2)
    return count, mean, m2, inv_mass, chol


class WindowedVariance(NamedTuple):
    """Welford accumulator + the currently adopted diagonal variance, per
    chain: ``count`` ``(c,)`` int32, ``mean``, ``m2`` and ``var`` ``(c, d)``.

    ``var`` is the regularized posterior-variance estimate adopted at the
    last window end: the diagonal preconditioner or mass."""
    count: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor
    var: torch.Tensor


def wv_init(dim, dtype, n_chains=1, device=None):
    """An empty accumulator for ``n_chains`` chains, variance one."""
    kw = {"dtype": dtype, "device": device}
    return WindowedVariance(
        count=torch.zeros((n_chains,), dtype=torch.int32, device=device),
        mean=torch.zeros((n_chains, dim), **kw),
        m2=torch.zeros((n_chains, dim), **kw),
        var=torch.ones((n_chains, dim), **kw),
    )


def wv_update(wv: WindowedVariance, x, collecting, window_end,
              pooled=False) -> WindowedVariance:
    """Fold one draw ``x`` ``(c, d)`` where ``collecting`` ``(c,)``; at a
    window end adopt the regularized variance (shrunk toward 1e-3,
    Stan-style) and reset the accumulator: the diagonal mode of
    :func:`windowed_mass_update`. ``pooled`` averages the estimate over the
    chains."""
    count, mean, m2, var, _ = windowed_mass_update(
        wv.count, wv.mean, wv.m2, wv.var, None, x, collecting, window_end,
        "diag", pooled=pooled)
    return WindowedVariance(count=count, mean=mean, m2=m2, var=var)


def make_precond_cfg(n_adapt, pooled=False, device=None):
    """Schedule bundle for windowed preconditioner adaptation: the warmup
    length, the collect / window-end masks of :func:`window_schedule` on
    ``device`` (indexed by each chain's draw counter), and ``pooled``."""
    collect, window_end = window_schedule(n_adapt, device)
    return {"n_adapt": n_adapt, "collect": collect, "window_end": window_end,
            "pooled": bool(pooled)}


def _window_masks(draw_ind, cfg):
    """``(collecting, window_end)`` per chain at draw counters ``draw_ind``
    ``(c,)``: the schedule's entries while warming up, false after."""
    idx = torch.clamp_max(draw_ind, cfg["collect"].shape[0] - 1).long()
    in_warmup = draw_ind < cfg["n_adapt"]
    return (in_warmup & cfg["collect"][idx],
            in_warmup & cfg["window_end"][idx])


def _restart_da(da, wend):
    """Dual averaging restarted from the current step size where ``wend``."""
    reset = da_init(torch.exp(da.log_eps))
    return DualAveraging(*[torch.where(wend, r, old)
                           for r, old in zip(reset, da)])


def windowed_precond_step(wv: WindowedVariance, da, new_position, draw_ind,
                          cfg, reset_da: bool):
    """One per-draw update of the windowed variance (and, at window ends,
    a dual-averaging restart from the current scale, Stan-style: the new
    covariance changes the acceptance landscape). ``draw_ind`` is each
    chain's draw counter ``(c,)``; ``cfg`` comes from
    :func:`make_precond_cfg`. Returns ``(wv, da)``."""
    collecting, wend = _window_masks(draw_ind, cfg)
    wv = wv_update(wv, new_position, collecting, wend, cfg["pooled"])
    if reset_da:
        da = _restart_da(da, wend)
    return wv, da


def windowed_dense_step(wv: WindowedVariance, da, cov, chol, m2, x,
                        draw_ind, cfg, reset_da: bool):
    """Dense analog of :func:`windowed_precond_step`: fold ``x`` into the
    dense Welford accumulator ``m2`` ``(c, d, d)`` while the schedule says
    collect, adopt the regularized covariance ``cov`` and its Cholesky
    factor ``chol`` at window ends, and (``reset_da=True``) restart dual
    averaging there. ``wv.m2`` / ``wv.var`` hold the *diagonal*
    accumulator and pass through untouched. Returns
    ``(wv, da, cov, chol, m2)``."""
    collecting, wend = _window_masks(draw_ind, cfg)
    wc, wm, m2, cov, chol = windowed_mass_update(
        wv.count, wv.mean, m2, cov, chol, x, collecting, wend, "dense",
        pooled=cfg["pooled"])
    wv = WindowedVariance(count=wc, mean=wm, m2=wv.m2, var=wv.var)
    if reset_da:
        da = _restart_da(da, wend)
    return wv, da, cov, chol, m2
