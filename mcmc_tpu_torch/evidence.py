"""Marginal-likelihood (model evidence) estimation (PyTorch port of
``mcmc_tpu.evidence``).

No reference analog — MCMCLib samples posteriors but cannot produce
``log Z = log ∫ prior(x) · lik(x) dx``, the quantity behind Bayes factors
and posterior model probabilities.

**Power-posterior path sampling** (:func:`thermo_evidence`): a ladder of K
rungs targets ``pi_beta(x) ∝ prior(x) · lik(x)^beta`` for an ascending
schedule ``beta_k = (k/(K-1))^c`` (Friel & Pettitt 2008 recommend c ≈ 5,
clustering rungs near the prior where E[log lik] moves fastest). From the
per-rung expectations of ``log lik`` it reports

* *thermodynamic integration* (TI): the trapezoid quadrature of
  ``dlog Z/dbeta = E_beta[log lik]`` over [0, 1], with the second-order
  variance correction of Friel, Hurn & Wyse (2014) —
  ``− Σ Δβ²/12 · (V_{k+1} − V_k)`` — that cancels the leading
  discretization bias;
* *stepping-stone* (SS, Xie et al. 2011): the telescoped ratio
  ``log Z = Σ_k log E_{beta_k}[lik^{Δβ_k}]``, each factor estimated by a
  log-mean-exp over rung k's draws — the recommended headline (TI's
  quadrature bias is one-signed; SS is not).

Like :mod:`mcmc_tpu_torch.samplers.pt`, the ``n_chains`` independent
ladders run as one ``(n_chains * K, d)`` batch of tempered HMC or RWMH
moves with per-row inverse temperatures; replica swaps are deterministic
even/odd permutations (the non-reversible DEO scheme — no host sync, no
kernel re-evaluation, because each replica carries its ``log lik`` and
``log prior`` values), and the cross-chain spread of the per-chain
estimates is the reported Monte-Carlo standard error. Per-rung step sizes
dual-average toward standard acceptance targets during burn-in, pooled as
a mean over the chain axis (the JAX package's ``lax.pmean``), because the
beta = 0 rung sees the prior's scale and the beta = 1 rung the
posterior's. The draw counter is a host integer, so adaptation stops
running once burn-in ends.

The Laplace shortcut is :attr:`mcmc_tpu_torch.laplace.LaplaceResult.
log_evidence`; adaptive-tempered SMC's ``diagnostics["log_z"]`` estimates
the same constant.

Requirements: ``log_prior`` must be a *normalized* log density (an improper
prior makes log Z meaningless) and the beta = 0 rung samples it by MCMC, so
it must be proper. For bounded problems the transform's log-Jacobian
belongs to the prior factor (untempered) — the rung-0 chain then samples
exactly the prior pushed to unconstrained space.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from mcmc_tpu_torch import adaptation, bounds as bounds_mod, integrators
from mcmc_tpu_torch.pytree import coerce_model
from mcmc_tpu_torch.settings import EvidenceSettings
from mcmc_tpu_torch.samplers import common
from mcmc_tpu_torch.samplers._resolve import resolve_settings, resolve_key

__all__ = ["thermo_evidence", "EvidenceResult", "power_schedule",
           "estimate_from_ll"]


def power_schedule(n_temps: int, power: float, dtype=torch.float32,
                   device=None):
    """Ascending inverse-temperature schedule ``beta_k = (k/(K-1))^power``,
    ``beta_0 = 0`` (prior) .. ``beta_{K-1} = 1`` (posterior)."""
    K = int(n_temps)
    if K < 2:
        raise ValueError(f"n_temps must be >= 2, got {K}")
    frac = torch.arange(K, dtype=dtype, device=device) / (K - 1)
    return frac ** torch.tensor(power, dtype=dtype, device=device)


@dataclasses.dataclass
class EvidenceResult:
    """Power-posterior evidence estimates.

    ``log_z`` (the headline) is the stepping-stone estimate averaged over
    the independent ladders; ``log_z_se`` its cross-chain standard error.
    ``log_z_ti`` is the variance-corrected thermodynamic-integration
    estimate on the same draws (agreement between the two is the standard
    internal consistency check). ``expected_log_lik``/``var_log_lik`` give
    the per-rung curve ``E_beta[log lik]``.
    """

    log_z: Any
    log_z_se: Any
    log_z_ti: Any
    log_z_ti_se: Any
    log_z_per_chain: Any      # (n_chains,) stepping-stone per ladder
    log_z_ti_per_chain: Any   # (n_chains,) corrected TI per ladder
    betas: Any                # (K,) schedule
    expected_log_lik: Any     # (K,) chain-pooled per-rung mean log lik
    var_log_lik: Any          # (K,) chain-pooled per-rung variance
    accept_rate: Any          # (K,) per-rung inner-move acceptance
    swap_accept_rate: Any     # (K-1,) adjacent-rung swap acceptance
    step_sizes: Any           # (K,) adapted per-rung step sizes / scales
    n_chains: int = 1


class _EvState(NamedTuple):
    X: torch.Tensor     # (c, K, d) replica positions, prior rung first
    ll: torch.Tensor    # (c, K) log-likelihood values
    lp: torch.Tensor    # (c, K) box log-prior values (incl. log-Jacobian)
    da: Any             # DualAveraging over (c, K) per-rung log step sizes
    draw_ind: int       # draw counter, the same for every ladder


def _build_kernel(box_prior, box_lik, s: EvidenceSettings, dim, dtype,
                  device, n_adapt):
    """Power-posterior replica-exchange transition over ``n_chains``
    ladders: returns ``(betas, make_state0, step)``.

    The target of rung k is ``lp(z) + beta_k·ll(z)`` with the prior factor
    untempered; every rung owns a dual-averaged step size. ``step.draw(gen,
    state) -> (noise, u, u_swap)`` (``u_swap`` ``None`` off a swap round)
    and ``step.transition(state, noise, u, u_swap)`` are its two halves:
    ``noise`` ``(c, K, d)`` holds HMC's initial momenta or RWMH's walk,
    ``u`` ``(c, K)`` the accept uniforms, ``u_swap`` ``(c, K-1)``."""
    betas = power_schedule(s.n_temps, s.schedule_power, dtype, device)
    K = int(betas.shape[0])
    inner = s.inner
    if inner not in ("hmc", "rwmh"):
        raise ValueError(f"inner must be 'hmc' or 'rwmh', got {inner!r}")
    target_acc = (s.target_accept if s.target_accept is not None
                  else (0.65 if inner == "hmc" else 0.234))
    swap_every = max(int(s.swap_every), 1)
    pair_mask = [(torch.arange(K - 1, device=device) % 2) == par
                 for par in (0, 1)]
    idx_K = torch.arange(K, device=device)
    grad_prior = integrators.grad_of(box_prior)
    grad_lik = integrators.grad_of(box_lik)
    zero = torch.zeros((), dtype=dtype, device=device)
    ident = lambda m: m

    def tempered_grad(z, beta_col):
        # separate autograd passes so the beta = 0 (prior) rung is driven by
        # the prior gradient alone: beta * grad_ll with a NaN/inf likelihood
        # gradient (hard-constraint likelihoods) must not poison the drift
        g_ll = grad_lik(z)
        g_ll = torch.where(torch.isfinite(g_ll), g_ll, zero)
        return grad_prior(z) + beta_col * g_ll

    def finite(v):
        return torch.where(torch.isfinite(v), v, -torch.inf)

    def eval_parts(z):
        return finite(box_prior(z)), finite(box_lik(z))

    def bll(ll, beta):
        """beta * ll with the beta = 0 rung exact: 0 * (-inf) would be NaN
        and would silently restrict the prior rung to {lik > 0}."""
        return torch.where(beta > 0, beta * ll, zero)

    def inner_hmc(x, ll, lp, beta, eps, p0, u):
        beta_col = beta[:, None]
        z, p = integrators.leapfrog(lambda zz: tempered_grad(zz, beta_col),
                                    ident, eps, int(s.n_leap_steps), x, p0)
        lp_new, ll_new = eval_parts(z)
        dH = (lp_new + bll(ll_new, beta)) - (lp + bll(ll, beta)) \
            - 0.5 * ((p * p).sum(-1) - (p0 * p0).sum(-1))
        return z, ll_new, lp_new, dH

    def inner_rwmh(x, ll, lp, beta, scale, noise, u):
        prop = x + scale[:, None] * noise
        lp_new, ll_new = eval_parts(prop)
        comp = (lp_new + bll(ll_new, beta)) - (lp + bll(ll, beta))
        return prop, ll_new, lp_new, comp

    inner_move = inner_hmc if inner == "hmc" else inner_rwmh
    counts = {"draws": 0, "swap_rounds": 0}

    def draw(gen, state: _EvState):
        X = state.X
        kw = {"generator": gen, "dtype": X.dtype, "device": X.device}
        noise = torch.randn(X.shape, **kw)
        u = torch.rand(X.shape[:2], **kw)
        u_swap = None
        if state.draw_ind % swap_every == swap_every - 1:
            u_swap = torch.rand((X.shape[0], K - 1), **kw)
        return noise, u, u_swap

    def transition(state: _EvState, noise, u, u_swap=None):
        draw_ind = int(state.draw_ind)
        c = state.X.shape[0]
        adapting = draw_ind < n_adapt
        log_eps = state.da.log_eps if adapting else state.da.log_eps_bar
        eps = torch.exp(log_eps)                                  # (c, K)
        beta = betas.expand(c, K).reshape(c * K)
        x_new, ll_new, lp_new, log_r = inner_move(
            state.X.reshape(c * K, dim), state.ll.reshape(c * K),
            state.lp.reshape(c * K), beta, eps.reshape(c * K),
            noise.reshape(c * K, dim), u.reshape(c * K))
        log_r = torch.where(torch.isnan(log_r), -torch.inf, log_r)
        log_r = torch.clamp_max(log_r, 0.0)
        acc = torch.log(u.reshape(c * K)) < log_r
        alpha = torch.exp(log_r).reshape(c, K)
        X = common.where_chains(acc, x_new, state.X.reshape(c * K, dim)) \
            .reshape(c, K, dim)
        ll = torch.where(acc, ll_new, state.ll.reshape(c * K)).reshape(c, K)
        lp = torch.where(acc, lp_new, state.lp.reshape(c * K)).reshape(c, K)
        acc = acc.reshape(c, K)
        counts["draws"] += 1

        # per-rung dual averaging toward target_acc, pooled across ladders
        da = state.da
        if adapting:
            da = adaptation.da_update(da, alpha.mean(dim=0), target_acc)

        info = {"accepted": acc[:, K - 1], "acc_all": acc.to(X.dtype)}
        # DEO swap round: deterministic even/odd alternation
        if draw_ind % swap_every != swap_every - 1:
            nothing = torch.zeros((c, K - 1), dtype=X.dtype, device=X.device)
            info["swap_accepted"] = info["swap_attempted"] = nothing
        else:
            counts["swap_rounds"] += 1
            active = pair_mask[(draw_ind // swap_every) % 2]       # (K-1,)
            # pi_{beta_k}(x_{k+1}) pi_{beta_{k+1}}(x_k) / (pi_{beta_k}(x_k)
            # pi_{beta_{k+1}}(x_{k+1})): the untempered prior factors cancel
            log_alpha = (betas[1:] - betas[:-1]) * (ll[:, :-1] - ll[:, 1:])
            # two adjacent -inf likelihoods give (-inf) - (-inf) = NaN: the
            # states are exchangeable, reject deterministically instead
            log_alpha = torch.where(torch.isnan(log_alpha), -torch.inf,
                                    log_alpha)
            acc_swap = active & (torch.log(u_swap)
                                 < torch.clamp_max(log_alpha, 0.0))
            no = torch.zeros_like(acc_swap[:, :1])
            with_next = torch.cat([acc_swap, no], dim=1)
            with_prev = torch.cat([no, acc_swap], dim=1)
            perm = torch.where(with_next, idx_K + 1,
                               torch.where(with_prev, idx_K - 1, idx_K))
            X = torch.gather(X, 1, perm[:, :, None].expand(c, K, dim))
            ll = torch.gather(ll, 1, perm)
            lp = torch.gather(lp, 1, perm)
            info["swap_accepted"] = acc_swap.to(X.dtype)
            info["swap_attempted"] = active.to(X.dtype).expand(c, K - 1)
        return _EvState(X=X, ll=ll, lp=lp, da=da,
                        draw_ind=draw_ind + 1), info

    def step(gen, state: _EvState):
        return transition(state, *draw(gen, state))

    def make_state0(first):
        """Every ladder's K replicas at its row of ``first`` ``(c, d)``."""
        c = first.shape[0]
        lp0, ll0 = eval_parts(first)
        eps0 = s.step_size if inner == "hmc" else s.par_scale
        return _EvState(
            X=first[:, None, :].expand(c, K, dim).clone(),
            ll=ll0[:, None].expand(c, K).clone(),
            lp=lp0[:, None].expand(c, K).clone(),
            da=adaptation.da_init(torch.full((c, K), eps0, dtype=dtype,
                                             device=device)),
            draw_ind=0)

    step.draw, step.transition, step.counts = draw, transition, counts
    return betas, make_state0, step


def _logmeanexp(a, dim):
    return torch.logsumexp(a, dim=dim) - math.log(a.shape[dim])


def _cond_mean_var(ll, dim):
    """Mean/variance over ``dim`` conditional on finite entries — the
    beta -> 0+ limit of the per-rung expectation when the likelihood has
    hard constraints (ll = -inf on prior mass). Empty slices report
    (-inf, 0)."""
    fin = torch.isfinite(ll)
    cnt = fin.sum(dim=dim)
    safe = torch.where(fin, ll, torch.zeros_like(ll))
    mean = torch.where(cnt > 0, safe.sum(dim=dim) / torch.clamp_min(cnt, 1),
                       -torch.inf)
    mean_safe = torch.where(torch.isfinite(mean), mean,
                            torch.zeros_like(mean)).unsqueeze(dim)
    dev2 = torch.where(fin, (safe - mean_safe) ** 2, torch.zeros_like(ll))
    var = torch.where(cnt > 1,
                      dev2.sum(dim=dim) / torch.clamp_min(cnt - 1, 1),
                      torch.zeros_like(mean))
    return mean, var


def estimate_from_ll(ll_draws, betas):
    """Estimators from a ``(n_keep, n_chains, K)`` log-likelihood trace.

    Returns ``(log_z_ss, log_z_ti, e_ll, v_ll)`` with the per-chain
    stepping-stone and variance-corrected-TI estimates ``(n_chains,)`` and
    the chain-pooled per-rung mean/variance curves ``(K,)``.

    Hard-constraint caveat: per-rung means/variances condition on finite
    ``ll`` (the beta -> 0+ limit), so the curves stay finite when the
    likelihood is -inf on part of the prior — but then the TI path has a
    discontinuity at beta = 0 (``Z(0+) = P(lik > 0) != 1``) that no
    quadrature can see, so ``log_z_ti`` estimates ``log Z - log P(lik >
    0)`` and is biased high by the prior's infeasible mass. The
    stepping-stone ``log_z`` handles the atom exactly (its rung-0
    log-mean-exp includes the zero-likelihood draws) and is the headline
    for constrained likelihoods."""
    dbeta = betas[1:] - betas[:-1]                       # (K-1,)

    # stepping stone: rung k's draws bridge beta_k -> beta_{k+1}
    ratios = _logmeanexp(dbeta * ll_draws[:, :, :-1], dim=0)   # (C, K-1)
    log_z_ss = ratios.sum(dim=-1)                               # (C,)

    e, v = _cond_mean_var(ll_draws, dim=0)                      # (C, K)
    trap = 0.5 * (dbeta * (e[:, 1:] + e[:, :-1])).sum(dim=-1)
    corr = (dbeta ** 2 / 12.0 * (v[:, 1:] - v[:, :-1])).sum(dim=-1)
    log_z_ti = trap - corr                                      # (C,)

    flat = ll_draws.reshape(-1, ll_draws.shape[-1])
    e_all, v_all = _cond_mean_var(flat, dim=0)
    return log_z_ss, log_z_ti, e_all, v_all


def thermo_evidence(initial_vals, log_prior, log_lik, settings=None, *,
                    n_chains=None, key=None, mesh=None, dtype=None,
                    device=None) -> EvidenceResult:
    """Estimate ``log Z = log ∫ prior(x)·exp(log_lik(x)) dx`` by
    power-posterior path sampling (module docstring).

    ``log_prior`` must be a normalized log density; ``log_lik`` the
    log-likelihood. Both are batched: ``(rows, d) -> (rows,)``, called on
    all ``n_chains * K`` replicas at once. The headline standard errors are
    cross-chain, so use at least ~8 chains for trustworthy error bars.
    Bounds come from ``settings``'s umbrella fields, exactly as in the
    samplers; the log-Jacobian attaches to the (untempered) prior factor.
    ``key`` is a ``torch.Generator`` or an integer seed; ``device``
    defaults to that of ``initial_vals``, else the card. ``mesh`` is not
    ported yet and raises.
    """
    algo, s = resolve_settings(settings, "evidence_settings", EvidenceSettings)
    common._no_mesh(mesh)
    initial_vals, (log_prior, log_lik), _unravel = coerce_model(
        initial_vals, log_prior, log_lik, device=device)

    # setup_problem wires bounds/transform for the prior factor (the box
    # log-prior includes the log-Jacobian); the likelihood factor is the
    # plain user function composed with inv_transform, no Jacobian
    prob = common.setup_problem(initial_vals, log_prior, algo, n_chains,
                                dtype, device)
    gen = resolve_key(key, algo, prob.device)
    dim, dt = prob.n_vals, prob.dtype
    box_prior = prob.box_log_kernel
    if prob.vals_bound:
        codes, lb, ub = prob.codes, prob.lower_bounds, prob.upper_bounds
        box_lik = lambda z: log_lik(bounds_mod.inv_transform(z, codes, lb, ub))
    else:
        box_lik = log_lik

    n_adapt = s.n_adapt_draws if s.n_adapt_draws is not None \
        else s.n_burnin_draws
    betas, make_state0, step = _build_kernel(
        box_prior, box_lik, s, dim, dt, prob.device, int(n_adapt))
    K = int(betas.shape[0])

    state0 = make_state0(prob.first_draw)
    final, ll_draws, infos = common.run_sampler_loop(
        gen, state0, step, s.n_burnin_draws, s.n_keep_draws,
        collect_fn=lambda st: st.ll)
    # ll_draws: (n_keep, n_chains, K)

    log_z_ss, log_z_ti, e_ll, v_ll = estimate_from_ll(ll_draws, betas)

    C = int(log_z_ss.shape[0])
    nan = torch.tensor(float("nan"), dtype=dt, device=prob.device)
    se_ss = log_z_ss.std() / math.sqrt(C) if C > 1 else nan
    se_ti = log_z_ti.std() / math.sqrt(C) if C > 1 else nan

    acc_rate = infos["acc_all"].mean(dim=(0, 1))                 # (K,)
    att = torch.clamp_min(infos["swap_attempted"].sum(dim=(0, 1)), 1.0)
    swap_rate = infos["swap_accepted"].sum(dim=(0, 1)) / att

    eps_final = torch.exp(final.da.log_eps_bar[0])               # pooled

    return EvidenceResult(
        log_z=log_z_ss.mean(), log_z_se=se_ss,
        log_z_ti=log_z_ti.mean(), log_z_ti_se=se_ti,
        log_z_per_chain=log_z_ss, log_z_ti_per_chain=log_z_ti,
        betas=betas, expected_log_lik=e_ll, var_log_lik=v_ll,
        accept_rate=acc_rate, swap_accept_rate=swap_rate,
        step_sizes=eps_final, n_chains=C,
    )
