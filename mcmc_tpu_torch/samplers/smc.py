"""Adaptive tempered Sequential Monte Carlo (PyTorch port of
``mcmc_tpu.samplers.smc``).

No reference analog — MCMCLib's population machinery stops at DE-MCMC
(reference src/de.cpp:30-273) and AEES (reference src/aees.cpp:30-305).
Tempered SMC anneals a particle cloud from a tractable initial distribution
to the posterior through bridging densities, with importance reweighting,
resampling and MCMC mutation at each stage (Del Moral, Doucet & Jasra 2006;
adaptive tempering after Jasra et al. 2011), and estimates the **log
normalizing constant**.

Anneal path, on the unconstrained space: with ``q0 = N(mu0, diag(s0^2))``
and ``L(z)`` the box log-kernel,

    log pi_lambda(z) = (1 - lambda) * log q0(z) + lambda * L(z),

lambda: 0 -> 1. Stage t does, in order:

1. **Adaptive temperature step**: ``lambda_{t+1}`` by a fixed number of
   bisection steps so the incremental-weight ESS fraction equals
   ``ess_target`` (1.0 if reachable);
2. **Evidence update**: ``log Z += logsumexp(log w) - log N``;
3. **Resampling**: systematic by default (stratified, multinomial) — the
   normalized-weight ``cumsum`` against a uniform grid with
   ``torch.searchsorted``;
4. **Mutation**: ``n_mcmc_steps`` Metropolis moves per particle targeting
   ``pi_{lambda_{t+1}}``, batched over the cloud: a random walk with the
   population covariance's Cholesky factor scaled by ``2.38/sqrt(d)``
   (``inner="rwmh"``, default), or HMC whitened by the population's
   per-dimension standard deviations (``inner="hmc"``).

The JAX package runs the whole sampler as one ``lax.while_loop``; here the
stages are a Python loop, and a stage's only host synchronisation is the
loop's test ``lam < 1`` (the stage count is a host integer). Bisection,
resampling, the population factorisation and the mutation stay on the
device.

For bounded problems everything runs on the unconstrained space (the
annealed kernel includes the log-Jacobian) and the final cloud is
back-transformed; ``log_z`` then estimates the constrained-space integral of
``exp(log_kernel)``.

A stage is a draw of its random numbers from the run's one
``torch.Generator`` (``stage.draw``: the resampling uniforms and the
mutation's normals and accept uniforms) followed by a function of those
draws (``stage.transition``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from mcmc_tpu_torch import integrators, stats
from mcmc_tpu_torch.results import SamplerResult
from mcmc_tpu_torch.settings import SMCSettings
from mcmc_tpu_torch.parallel import mesh as mesh_mod
from mcmc_tpu_torch.samplers import common
from mcmc_tpu_torch.samplers._resolve import resolve_settings, resolve_key

__all__ = ["smc", "SMCState", "resample_indices", "next_lambda",
           "build_smc_stage"]

_BISECT_ITERS = 30


class SMCState(NamedTuple):
    X: torch.Tensor         # (N, d) particle positions (unconstrained)
    lk: torch.Tensor        # (N,) box log-kernel values L(z)
    lq: torch.Tensor        # (N,) initial-density log q0(z) values
    lam: torch.Tensor       # () current inverse temperature in [0, 1]
    stage: int              # completed stage count (host)
    log_z: torch.Tensor     # () running evidence estimate
    n_acc: torch.Tensor     # (N,) int32 accepted mutation moves per particle
    lambdas: torch.Tensor   # (max_stages,) lambda after each stage
    ess_frac: torch.Tensor  # (max_stages,) realized incremental ESS fraction
    acc_rate: torch.Tensor  # (max_stages,) mean mutation acceptance per stage


def _ess_fraction(logw):
    """ESS((w_i)) / N = exp(2 lse(logw) - lse(2 logw)) / N, in log space."""
    n = logw.shape[-1]
    return torch.exp(2.0 * torch.logsumexp(logw, -1)
                     - torch.logsumexp(2.0 * logw, -1)) / n


def next_lambda(lam, delta, ess_target):
    """Largest ``lambda' in (lam, 1]`` with incremental ESS fraction >=
    ``ess_target``, by ``_BISECT_ITERS`` monotone bisection steps on
    ``logw = (lambda' - lam) * delta``; 1.0 outright when ``ess(1.0) >=
    ess_target``; at least ``lam + 1e-5`` (forward progress). ``lam`` is a
    0-d tensor; no host synchronisation."""
    f = lambda l: _ess_fraction((l - lam) * delta)
    lo, hi = lam, torch.ones_like(lam)
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        ok = f(mid) >= ess_target
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    one = torch.ones_like(lam)
    lam_new = torch.where(f(one) >= ess_target, one, lo)
    return torch.clamp_max(torch.maximum(lam_new, lam + 1e-5), 1.0)


def resample_indices(u, logw, kind="systematic"):
    """Ancestor indices ``(n,)`` for log-weights ``logw`` ``(n,)`` from the
    uniforms ``u``: one ``()`` for ``systematic`` (against the ``(i + u)/n``
    grid), ``(n,)`` for ``stratified`` (``(i + u_i)/n``) and ``multinomial``
    (``n`` lookups). A ``cumsum`` of the normalized weights and
    ``torch.searchsorted``, clipped to ``[0, n)``."""
    n = logw.shape[0]
    w = torch.exp(logw - torch.logsumexp(logw, 0))
    c = torch.cumsum(w, 0)
    c = c / c[-1]   # guard fp drift so u < c[-1] always resolves in-range
    ar = torch.arange(n, dtype=logw.dtype, device=logw.device)
    if kind in ("systematic", "stratified"):
        grid = (u + ar) / n
    elif kind == "multinomial":
        grid = u
    else:
        raise ValueError(f"unknown resample kind {kind!r}")
    return torch.clamp(torch.searchsorted(c, grid, right=True), 0, n - 1)


def build_smc_stage(box, s: SMCSettings, mu0, s0, axis=None):
    """One stage ``stage(gen, state) -> state`` of the annealed cloud;
    ``stage.draw(gen, state) -> (u_res, noise, u_mut)`` (``noise``
    ``(n_mcmc, N, d)``: the walk's normals or HMC's momenta; ``u_mut``
    ``(n_mcmc, N)``) and ``stage.transition(state, u_res, noise, u_mut)``
    are its two halves; ``stage.lq_fn`` and ``stage.lk_safe`` give the
    initial density and the guarded box kernel of a batch; ``stage.counts``
    tallies stages and host synchronisations (the loop's one a stage, in
    :func:`smc`).

    With a chain ``axis`` (:class:`~mcmc_tpu_torch.parallel.mesh.
    MeshAxis`), the state's particle rows are this rank's block: a stage
    all-gathers the cloud once, computes the next temperature, the weights,
    log Z and the resampling indices globally (``u_res`` must then be the
    same on every rank), takes its block's resampled rows, preconditions
    the mutation by the whole resampled cloud's spread and pools the
    acceptance rate with one all-reduce."""
    dim = int(mu0.shape[0])
    dt, device = mu0.dtype, mu0.device
    N = int(s.n_particles)
    n_mcmc = int(s.n_mcmc_steps)
    ess_target = float(np.float32(s.ess_target))
    log_s0_sum = torch.log(s0).sum()
    log_2pi = torch.log(torch.tensor(2.0 * math.pi, dtype=dt, device=device))
    log_n = torch.log(torch.tensor(float(N), dtype=dt, device=device))
    rw_scale = float(np.float32(s.par_scale * 2.38)
                     / np.sqrt(np.float32(dim)))
    eps = float(np.float32(s.step_size))
    eye = torch.eye(dim, dtype=dt, device=device)
    counts = {"stages": 0, "syncs": 0}

    def lq_fn(z):
        r = (z - mu0) / s0
        return -0.5 * (r * r).sum(-1) - log_s0_sum - 0.5 * dim * log_2pi

    def lk_safe(z):
        v = box(z)
        return torch.where(torch.isfinite(v), v, -torch.inf)

    def mutation_sweep(X, lk, lq, lam, noise, u_mut, pop=None):
        """``n_mcmc`` Metropolis moves targeting pi_lam, preconditioned by
        the population's own spread (computed once per stage; ``pop``: the
        whole cloud when ``X`` is a block of it)."""
        pop = X if pop is None else pop
        mean = pop.mean(dim=0)
        Xc = pop - mean
        if s.inner == "rwmh":
            C = (Xc.T @ Xc) / N
            C = C + (1e-6 * torch.trace(C) / dim + 1e-12) * eye
            L = stats.cholesky_or_nan(C)
        else:
            sd = torch.sqrt((Xc * Xc).mean(dim=0) + 1e-12)
            grad_pi = integrators.grad_of(
                lambda z: (1.0 - lam) * lq_fn(z) + lam * box(z))

        def logp(lkv, lqv):
            return (1.0 - lam) * lqv + lam * lkv

        acc_n = torch.zeros((X.shape[0],), dtype=torch.int32, device=device)
        acc_means = []
        for i in range(n_mcmc):
            if s.inner == "rwmh":
                prop = X + rw_scale * (noise[i] @ L.T)
                p = p0 = None
            else:
                # whitened leapfrog: mass M = diag(1/sd^2), p ~ N(0, I) in
                # the whitened frame; dH uses the whitened kinetic energy
                p0 = noise[i]
                z, p, g = X, p0, grad_pi(X)
                for _ in range(int(s.n_leap_steps)):
                    p = p + 0.5 * eps * sd * g
                    z = z + eps * sd * p
                    g = grad_pi(z)
                    p = p + 0.5 * eps * sd * g
                prop = z
            lk_p, lq_p = lk_safe(prop), lq_fn(prop)
            d = logp(lk_p, lq_p) - logp(lk, lq)
            if p is not None:
                d = d - 0.5 * ((p * p).sum(-1) - (p0 * p0).sum(-1))
            acc = torch.log(u_mut[i]) < torch.clamp_max(d, 0.0)
            X = common.where_chains(acc, prop, X)
            lk = torch.where(acc, lk_p, lk)
            lq = torch.where(acc, lq_p, lq)
            acc_n = acc_n + acc.to(torch.int32)
            acc_means.append(acc.to(dt).mean() if axis is None
                             else acc.to(dt).sum())
        acc_means = torch.stack(acc_means)
        if axis is not None:
            acc_means = mesh_mod.all_reduce(acc_means, axis.group) / N
        return X, lk, lq, acc_n, acc_means.mean()

    def draw(gen, state: SMCState, shared_gen=None):
        """The stage's draws; sharded, ``u_res`` comes from ``shared_gen``
        (the same stream on every rank) and the rest, for this rank's
        block, from ``gen``."""
        m = state.X.shape[0]
        kw = {"dtype": dt, "device": device}
        u_res = torch.rand(() if s.resample == "systematic" else (N,),
                           generator=gen if shared_gen is None
                           else shared_gen, **kw)
        noise = torch.randn((n_mcmc, m, dim), generator=gen, **kw)
        return u_res, noise, torch.rand((n_mcmc, m), generator=gen, **kw)

    def transition(state: SMCState, u_res, noise, u_mut):
        pop = None
        X, lk, lq = state.X, state.lk, state.lq
        if axis is not None:
            # the whole cloud, once a stage: positions and both densities
            cloud = mesh_mod.all_gather(
                torch.cat([X, lk[:, None], lq[:, None]], dim=1),
                axis.group, axis.size)
            X, lk, lq = cloud[:, :dim], cloud[:, dim], cloud[:, dim + 1]
        delta = lk - lq
        lam_new = next_lambda(state.lam, delta, ess_target)
        logw = (lam_new - state.lam) * delta
        log_z = state.log_z + torch.logsumexp(logw, 0) - log_n

        idx = resample_indices(u_res, logw, s.resample)
        X, lk, lq = X[idx], lk[idx], lq[idx]
        if axis is not None:
            m = state.X.shape[0]
            rows = slice(axis.index * m, (axis.index + 1) * m)
            pop, X, lk, lq = X, X[rows], lk[rows], lq[rows]
        X, lk, lq, acc_n, acc_mean = mutation_sweep(X, lk, lq, lam_new,
                                                    noise, u_mut, pop)
        counts["stages"] += 1
        i = int(state.stage)
        lambdas = state.lambdas.clone()
        ess_frac = state.ess_frac.clone()
        acc_rate = state.acc_rate.clone()
        lambdas[i] = lam_new
        ess_frac[i] = _ess_fraction(logw)
        acc_rate[i] = acc_mean
        return SMCState(X=X, lk=lk, lq=lq, lam=lam_new, stage=i + 1,
                        log_z=log_z, n_acc=state.n_acc + acc_n,
                        lambdas=lambdas, ess_frac=ess_frac,
                        acc_rate=acc_rate)

    def stage(gen, state: SMCState):
        return transition(state, *draw(gen, state))

    def init(X0):
        """The stage-0 state of the cloud ``X0`` ``(N, d)``."""
        z = lambda: torch.zeros((int(s.max_stages),), dtype=dt, device=device)
        return SMCState(
            X=X0, lk=lk_safe(X0), lq=lq_fn(X0),
            lam=torch.zeros((), dtype=dt, device=device), stage=0,
            log_z=torch.zeros((), dtype=dt, device=device),
            n_acc=torch.zeros((X0.shape[0],), dtype=torch.int32,
                              device=device),
            lambdas=z(), ess_frac=z(), acc_rate=z())

    stage.draw, stage.transition, stage.init = draw, transition, init
    stage.lq_fn, stage.lk_safe, stage.counts = lq_fn, lk_safe, counts
    return stage


def smc(initial_vals, log_kernel, settings=None, *, key=None, mesh=None,
        dtype=None, device=None) -> SamplerResult:
    """Run adaptive tempered SMC (module docstring). ``log_kernel`` is
    batched over particles: ``(N, n_vals) -> (N,)``. Returns the final
    equally-weighted particle cloud as ``draws`` of shape ``(n_particles,
    n_vals)`` (constrained space) — one posterior population, not a chain
    trace.

    ``initial_vals`` (shape ``(n_vals,)``) centers the initial cloud
    ``q0 = N(initial_vals', diag(init_scale^2))`` (on the unconstrained
    space; scalar or per-dimension ``init_scale``).

    Diagnostics: ``log_z`` (log evidence estimate ``log ∫
    exp(log_kernel)``), ``n_stages``, ``completed`` (``lambda`` reached 1
    within ``max_stages``), and per stage ``lambdas``, ``ess_fraction`` and
    ``mutation_accept_rate`` (length ``n_stages``). ``n_accept_draws``
    counts accepted mutation moves per particle over the whole run.
    ``key`` is a ``torch.Generator`` or an integer seed; ``device`` defaults
    to that of ``initial_vals``, else the card. ``mesh`` shards the
    particles over the mesh's ranks: the weights, ESS, log Z and the
    resampling indices are global (drawn from a stream every rank shares),
    each rank mutates its block on its own generator
    (:func:`build_smc_stage`), and every rank returns the whole cloud."""
    algo, s = resolve_settings(settings, "smc_settings", SMCSettings)
    axis = mesh_mod.chain_axis_of(mesh)

    prob = common.setup_problem(initial_vals, log_kernel, algo, None, dtype,
                                device)
    if not prob.squeeze:
        raise ValueError(
            f"smc takes a single center point initial_vals of shape "
            f"(n_vals,); got a chain-batched array of shape "
            f"{tuple(np.shape(initial_vals))} — the population size is "
            f"SMCSettings.n_particles")
    dim, dt = prob.n_vals, prob.dtype
    N = int(s.n_particles)
    if not 0.0 < float(s.ess_target) < 1.0:
        raise ValueError(f"ess_target must be in (0, 1), got {s.ess_target}")
    if s.inner not in ("rwmh", "hmc"):
        raise ValueError(f"inner must be 'rwmh' or 'hmc', got {s.inner!r}")
    if s.resample not in ("systematic", "stratified", "multinomial"):
        raise ValueError(f"unknown resample kind {s.resample!r}")
    gen = resolve_key(key, algo, prob.device)

    mu0 = prob.first_draw[0]
    s0 = torch.as_tensor(np.asarray(s.init_scale), dtype=dt,
                         device=prob.device).expand(dim).contiguous()
    stage = build_smc_stage(prob.box_log_kernel, s, mu0, s0, axis)
    with torch.no_grad():
        X0 = mu0 + s0 * torch.randn((N, dim), generator=gen, dtype=dt,
                                    device=prob.device)
        if axis is None:
            step, X0 = stage, X0
        else:
            rows = mesh_mod._rows(N, axis)
            seed, rgen = mesh_mod.rank_generator(gen, rows.start)
            sgen = mesh_mod.shared_generator(seed, prob.device)
            step = lambda _g, st: stage.transition(
                st, *stage.draw(rgen, st, sgen))
            X0 = X0[rows]
        st = stage.init(X0)
        # one host synchronisation a stage: the loop's test
        while st.stage < int(s.max_stages) and bool(st.lam < 1.0):
            stage.counts["syncs"] += 1
            st = step(gen, st)
        stage.counts["syncs"] += st.stage < int(s.max_stages)
        if axis is not None:
            st = st._replace(**{k: mesh_mod.all_gather(
                getattr(st, k), axis.group, axis.size)
                for k in ("X", "lk", "lq", "n_acc")})

    draws = common.finalize_draws(st.X, prob)
    n = st.stage
    return SamplerResult(
        draws=draws, n_accept_draws=st.n_acc,
        diagnostics={
            "log_z": st.log_z,
            "n_stages": n,
            "completed": bool(st.lam >= 1.0),
            "lambdas": st.lambdas[:n],
            "ess_fraction": st.ess_frac[:n],
            "mutation_accept_rate": st.acc_rate[:n],
        })
