"""Nested sampling — evidence and posterior from a prior-transform model
(PyTorch port of ``mcmc_tpu.nested``).

No reference analog — MCMCLib has no evidence machinery at all; this
completes the evidence family (SMC's particle estimate, power-posterior
TI/stepping-stone in evidence.py, the Laplace shortcut) with the estimator
of record for multimodal and phase-transition problems: Skilling (2006)
nested sampling, in the batched random-walk variant of MultiNest/dynesty
('rwalk').

The algorithm compresses the prior through nested likelihood shells: with
``N`` live points drawn from the prior, repeatedly kill the worst-likelihood
points and replace them with new prior draws constrained to exceed the kill
threshold. The enclosed prior mass after the ``j``-th sequential kill
shrinks by ``E[log t] = -1/(N-j)``, giving the quadrature
``Z = sum_j L_j * (X_{j-1} - X_j)`` over dead points.

The classic algorithm kills one point at a time; this implementation
batches it:

- **batch kills**: each round removes the ``kill_frac * N`` worst points at
  once with the exact sequential shrinkage ``-sum_i 1/(N-i)`` (a cumsum)
  and replaces them all in parallel — every replacement targets the hard
  constraint ``L > L*`` at the batch maximum, above which both survivors
  and replacements are uniform, so the invariant is preserved. The order
  is a stable sort: ties are common under hard-constraint likelihoods;
- **constrained replacement** is ``walks`` fixed Metropolis steps in the
  unit-cube prior coordinates (``u``-space), started at random survivors,
  with proposals shaped by the live-point covariance (Cholesky, jittered)
  and a global scale Robbins-Monro-tuned to ~50% in-region acceptance — one
  ``(B, d)`` batch per walk step;
- the rounds are a Python loop writing dead points into preallocated
  buffers; its end test is the one host synchronisation a round.

The model interface is the standard NS pair (as in MultiNest/dynesty),
batched here (an API difference from the JAX package, which vmaps
single-point functions): ``prior_transform(u: (B, d)) -> (B, d)`` maps
unit-cube points to the prior, and ``log_lik(theta: (B, d)) -> (B,)``.
Termination when the live set's maximum possible remaining contribution
``X * max L`` drops below ``stop_frac`` of the accumulated evidence. The
information ``H = int post ln(post/prior)`` gives the classic
``sqrt(H/N)`` error bar.

Returned draws carry log-weights ``log w_j = log L_j + log dX_j - log Z``;
``NestedResult.posterior_draws`` resamples them to an equal-weight set
(Gumbel top-k, without replacement).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from mcmc_tpu_torch.samplers._resolve import resolve_device
from mcmc_tpu_torch.stats import cholesky_or_nan, gumbel_topk

__all__ = ["nested_sampling", "NestedResult"]


@dataclasses.dataclass
class NestedResult:
    """Nested-sampling output.

    Attributes:
        log_z: log evidence estimate.
        log_z_err: classic ``sqrt(H / n_live)`` uncertainty.
        h: information (nats) — prior-to-posterior compression.
        samples: ``(n_dead + n_live, n_vals)`` all visited points in
            parameter (theta) space, dead first.
        log_w: normalized log importance weights of ``samples``.
        log_l: log-likelihood of each sample.
        n_like_evals: total constrained log-likelihood evaluations.
        n_rounds: batch rounds executed.
        accept_rate: final in-region Metropolis acceptance of the
            replacement walker (healthy ~0.2-0.6).
        converged: True if the termination criterion was met before the
            round cap.
        host_syncs: host synchronisations of the round loop (its end
            tests), one a round.
    """

    log_z: Any
    log_z_err: Any
    h: Any
    samples: Any
    log_w: Any
    log_l: Any
    n_like_evals: int
    n_rounds: int
    accept_rate: Any
    converged: bool
    host_syncs: int = 0

    def posterior_draws(self, key, n_draws: int):
        """Equal-weight posterior draws: Gumbel top-k resampling of
        ``samples`` by ``log_w`` without replacement. ``key`` is a seed or
        a ``torch.Generator`` on the samples' device."""
        gen = key
        if not isinstance(key, torch.Generator):
            gen = torch.Generator(device=self.log_w.device)
            gen.manual_seed(int(key))
        return self.samples[gumbel_topk(gen, self.log_w, int(n_draws))]


class _NSState(NamedTuple):
    live_u: torch.Tensor     # (N, d) live points, unit cube
    live_L: torch.Tensor     # (N,) their log-likelihoods
    logX: torch.Tensor       # () log enclosed prior mass
    logZ: torch.Tensor       # () accumulated log evidence
    h: torch.Tensor          # () accumulated information
    scale: torch.Tensor      # () walk scale
    acc: torch.Tensor        # () last round's in-region acceptance
    rounds: int              # rounds done (a host integer)
    dead_u: torch.Tensor     # (max_rounds * B, d)
    dead_L: torch.Tensor     # (max_rounds * B,)
    dead_logw: torch.Tensor  # (max_rounds * B,)


def _information(log_wL, L, logZ, h):
    """Skilling's streaming update of ``(log Z, H)`` by a batch of
    unnormalised log weights ``log_wL`` of points with log-likelihoods
    ``L``. A point with L = -inf carries zero weight; it is masked so that
    softmax's 0 * (-inf) cannot NaN-poison H; on the first round
    (log Z = -inf) the carried term is 0, not NaN."""
    lse = torch.logsumexp(log_wL, dim=0)
    logZ_new = torch.logaddexp(logZ, lse)
    dZ_frac = torch.exp(lse - logZ_new)
    wl = torch.softmax(log_wL, dim=0)
    mean_lnL = torch.where(wl > 0, wl * L, torch.zeros_like(L)).sum()
    carried = torch.where(torch.isfinite(logZ),
                          torch.exp(logZ - logZ_new) * (h + logZ),
                          torch.zeros_like(h))
    return logZ_new, (carried + dZ_frac * mean_lnL) - logZ_new


def _make_round(ll_batch, N, B, d, stop_frac, dtype, device):
    """One batch round ``(state, pick, zs) -> (state, done)``: ``pick``
    ``(B,)`` indexes the survivors the walks start from, ``zs`` ``(walks,
    B, d)`` holds the walks' standard normals; ``done`` is the end test,
    a 0-d bool tensor on the device."""
    # exact sequential shrinkage for a batch of B kills from N live points:
    # log t_j = -1/(N - j), j = 0..B-1 (cumulative within the round)
    dlogt = -1.0 / (N - torch.arange(B, dtype=dtype, device=device))
    cum_dlogt = torch.cumsum(dlogt, dim=0)
    round_shrink = cum_dlogt[-1]
    before = torch.cat([torch.zeros((1,), dtype=dtype, device=device),
                        cum_dlogt[:-1]])
    log1m_t = torch.log(-torch.expm1(dlogt))
    log_stop = float(np.log(np.float32(stop_frac)))
    eye = 1e-10 * torch.eye(d, dtype=dtype, device=device)
    neg_inf = torch.tensor(-math.inf, dtype=dtype, device=device)

    def replace_batch(u, L, live_u, L_star, scale, zs):
        """B constrained random walks of ``len(zs)`` Metropolis steps in
        u-space: uniform above L_star (out-of-cube or L <= L_star rejects).
        Proposal = live-point covariance Cholesky * scale. The start
        points' likelihoods are already known (they are survivors)."""
        mu = live_u.mean(dim=0)
        cent = live_u - mu
        cov = cent.T @ cent / (live_u.shape[0] - 1) + eye
        chol = cholesky_or_nan(cov)
        accs = []
        for z in zs:
            prop = u + scale * (z @ chol.T)
            inbox = ((prop > 0.0) & (prop < 1.0)).all(dim=1)
            Lp = torch.where(inbox, ll_batch(torch.clamp(prop, 1e-7,
                                                         1 - 1e-7)), neg_inf)
            acc = inbox & (Lp > L_star)
            u = torch.where(acc[:, None], prop, u)
            L = torch.where(acc, Lp, L)
            accs.append(acc.to(dtype).mean())
        return u, L, torch.stack(accs).mean()

    def round_(st: _NSState, pick, zs):
        order = torch.argsort(st.live_L, stable=True)
        killed, survivors = order[:B], order[B:]
        L_killed = st.live_L[killed]                      # ascending
        L_star = L_killed[-1]

        # dead-point weights: trapezoid dX at the exact sequential X grid
        # log(X_before - X_after) = logX_before + log1p(-exp(dlogt))
        log_dX = (st.logX + before) + log1m_t
        log_wL = L_killed + log_dX                        # unnorm. log(w*L)
        logZ, h = _information(log_wL, L_killed, st.logZ, st.h)

        # record the killed batch
        r = st.rounds
        rows = slice(r * B, (r + 1) * B)
        st.dead_u[rows] = st.live_u[killed]
        st.dead_L[rows] = L_killed
        st.dead_logw[rows] = log_wL

        # parallel constrained replacement from random survivors
        start = survivors[pick]
        u_new, L_new, acc = replace_batch(
            st.live_u[start], st.live_L[start], st.live_u[survivors],
            L_star, st.scale, zs)
        live_u = st.live_u.index_put((killed,), u_new)
        live_L = st.live_L.index_put((killed,), L_new)

        # Robbins-Monro on the in-region acceptance toward 0.5
        scale = torch.clamp(st.scale * torch.exp(0.5 * (acc - 0.5)),
                            1e-4, 10.0)
        logX = st.logX + round_shrink
        done = logX + live_L.max() < log_stop + logZ
        return st._replace(live_u=live_u, live_L=live_L, logX=logX,
                           logZ=logZ, h=h, scale=scale, acc=acc,
                           rounds=r + 1), done

    return round_


def _run(ll_batch, live_u0, B, walks, max_rounds, stop_frac, draw):
    """The round loop from the live set ``live_u0`` ``(N, d)``;
    ``draw(rounds) -> (pick, zs)`` supplies each round's random numbers.
    Returns the final state, whether it converged and the host syncs."""
    N, d = live_u0.shape
    dt, dev = live_u0.dtype, live_u0.device
    T = int(max_rounds)
    neg_inf = lambda *shape: torch.full(shape, -math.inf, dtype=dt,
                                        device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    st = _NSState(
        live_u=live_u0, live_L=ll_batch(live_u0), logX=zero, logZ=neg_inf(),
        h=zero, scale=torch.tensor(0.3, dtype=dt, device=dev), acc=zero,
        rounds=0, dead_u=torch.zeros((T * B, d), dtype=dt, device=dev),
        dead_L=neg_inf(T * B), dead_logw=neg_inf(T * B))
    round_ = _make_round(ll_batch, N, B, d, stop_frac, dt, dev)
    done, syncs = False, 0
    while not done and st.rounds < T:
        pick, zs = draw(st.rounds)
        st, done_t = round_(st, pick, zs)
        done = bool(done_t)                 # the round's one host sync
        syncs += 1
    return st, done, syncs


def _finalize(st: _NSState, pt, N, B, walks, converged, syncs):
    """The final live points' contribution and the result."""
    dt = st.live_L.dtype
    # final live-point contribution: each carries X/N of remaining mass
    log_w_live = st.live_L + st.logX - float(np.log(np.float32(N)))
    logZ, h = _information(log_w_live, st.live_L, st.logZ, st.h)
    n_dead = st.rounds * B
    u_all = torch.cat([st.dead_u[:n_dead], st.live_u], dim=0)
    log_l = torch.cat([st.dead_L[:n_dead], st.live_L], dim=0)
    log_w = torch.cat([st.dead_logw[:n_dead], log_w_live], dim=0) - logZ
    samples = pt(torch.clamp(u_all, 1e-7, 1 - 1e-7))
    return NestedResult(
        log_z=logZ,
        log_z_err=torch.sqrt(torch.clamp_min(h, 0.0) / torch.tensor(
            float(N), dtype=dt, device=h.device)),
        h=h, samples=samples, log_w=log_w, log_l=log_l,
        n_like_evals=int(N + st.rounds * B * walks),
        n_rounds=st.rounds, accept_rate=st.acc, converged=bool(converged),
        host_syncs=syncs)


def nested_sampling(prior_transform: Callable, log_lik: Callable, n_vals: int,
                    *, n_live=1024, kill_frac=0.125, walks=24,
                    max_rounds=2000, stop_frac=1e-3, key=None,
                    dtype=torch.float32, device=None) -> NestedResult:
    """Run batched nested sampling (module docstring).

    ``prior_transform(u)`` maps a ``(B, n_vals)`` batch of unit-cube points
    to the prior (e.g. ``lambda u: lb + (ub - lb) * u`` for a uniform
    prior, or ``mu + sd * torch.special.ndtri(u)`` for a Gaussian);
    ``log_lik(theta)`` is the batched log-likelihood ``(B, n_vals) ->
    (B,)``. ``n_live`` controls resolution (error ~ ``sqrt(H/n_live)``);
    ``kill_frac`` the batch parallelism per round; ``walks`` the
    constrained-replacement Metropolis steps (raise it if ``accept_rate``
    collapses or evidence is biased high); ``stop_frac`` the
    remaining-evidence termination threshold. ``key`` is a seed or a
    ``torch.Generator`` (``None``: seed 0); ``device`` defaults to the
    card.
    """
    N = int(n_live)
    B = max(int(round(N * float(kill_frac))), 1)
    if B >= N:
        raise ValueError(f"kill_frac {kill_frac} leaves no survivors "
                         f"(n_live={N}, batch={B})")
    d = int(n_vals)
    walks = int(walks)
    dev = resolve_device(device)
    if isinstance(key, torch.Generator):
        gen = key
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0 if key is None else int(key))
    ll_batch = lambda u: log_lik(prior_transform(u))
    kw = {"generator": gen, "device": dev}
    live_u0 = torch.clamp(torch.rand((N, d), dtype=dtype, **kw), 1e-7,
                          1.0 - 1e-7)

    def draw(_r):
        return (torch.randint(0, N - B, (B,), **kw),
                torch.randn((walks, B, d), dtype=dtype, **kw))

    st, done, syncs = _run(ll_batch, live_u0, B, walks, max_rounds,
                           stop_frac, draw)
    return _finalize(st, prior_transform, N, B, walks, done, syncs)
