"""Microcanonical Langevin Monte Carlo: unadjusted (MCLMC) and
Metropolis-adjusted (MAMS) (PyTorch port of ``mcmc_tpu.samplers.mclmc``).

No reference analog. Both move a *unit-speed* velocity on the sphere under
the isokinetic dynamics of ESH / microcanonical HMC (Robnik, De Luca,
Silverstein & Seljak 2022, arXiv:2212.08549), discretized by velocity
Verlet or McLachlan's minimal-norm splitting. MCLMC takes one integrator
step per draw with a partial velocity refresh and no accept/reject (an
O(step^2) bias held at ``desired_energy_var``); MAMS refreshes the velocity
fully, runs a Halton-jittered trajectory of shared length and accepts on
the accumulated energy error. Tuning pools over the chain batch: the step
size by dual averaging on a pooled statistic, ``L`` from the pooled
cross-chain variance (EWMA), optional diagonal preconditioning from the
same variance. See the JAX module's docstring for the construction.

Here the chain batch runs in lockstep, as in
:mod:`mcmc_tpu_torch.samplers.chees`: pooled reductions are means over the
chain axis; MCLMC's transition needs no host synchronisation; MAMS's
trajectory length comes from pooled quantities, and its leapfrog count's
smallest and largest values are read to the host once per draw (the draw's
one host synchronisation), a chain whose own count is reached keeping its
state. Each kernel draws its random numbers from the run's one
``torch.Generator`` (``step.draw``) and then runs a function of those draws
(``step.transition``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mcmc_tpu_torch import adaptation
from mcmc_tpu_torch.results import SamplerResult
from mcmc_tpu_torch.settings import MCLMCSettings, MAMSSettings
from mcmc_tpu_torch.samplers import common
from mcmc_tpu_torch.samplers._resolve import resolve_settings, resolve_key
from mcmc_tpu_torch.samplers.chees import _leap_count, _vdc_base2
from mcmc_tpu_torch.samplers.common import where_chains

__all__ = ["mclmc", "mams", "MCLMCState", "MAMSState",
           "isokinetic_velocity_verlet", "partial_velocity_refresh"]

_TINY = 1e-37
# the dual-averaging fixed point for the energy statistic exp(-varE/(2 s^2)):
# stat == target exactly when E[dE^2]/d == desired_energy_var
_ENERGY_STAT_TARGET = math.exp(-0.5)


def _col(eps):
    """A per-chain ``(c,)`` tensor as a ``(c, 1)`` column; floats as is."""
    return eps[:, None] if torch.is_tensor(eps) and eps.ndim == 1 else eps


def _norm(v):
    return torch.sqrt((v * v).sum(-1))


def _iso_momentum_update(u, g, eps):
    """Exact isokinetic velocity update of each chain for a frozen gradient
    ``g`` ``(c, d)`` over time ``eps`` (a float or ``(c,)``): the closed-form
    flow of du/dt = P(u) g / (d-1) on the unit sphere (ESH dynamics), in the
    numerically stable zeta = exp(-delta) form. Returns ``(u_new,
    kinetic_change)`` where ``kinetic_change`` ``(c,)`` is the (d-1) log r
    weight this update contributes to the microcanonical energy error."""
    dim = u.shape[-1]
    g_norm = _norm(g)
    e = g / torch.clamp_min(g_norm, _TINY)[:, None]
    ue = (u * e).sum(-1)
    delta = eps * g_norm / (dim - 1)
    zeta = torch.exp(-delta)
    uu = e * (1.0 - zeta)[:, None] * (1.0 + zeta + ue * (1.0 - zeta))[:, None] \
        + (2.0 * zeta)[:, None] * u
    u_new = uu / torch.clamp_min(_norm(uu), _TINY)[:, None]
    # log(cosh(delta) + ue*sinh(delta)), stable for large delta
    delta_r = delta - math.log(2.0) + torch.log(
        torch.clamp_min((1.0 + ue) + (1.0 - ue) * zeta * zeta, _TINY))
    return u_new, (dim - 1) * delta_r


def isokinetic_velocity_verlet(value_and_grad_fn, sqrt_diag):
    """One velocity-Verlet step of the isokinetic dynamics for every chain,
    preconditioned by a diagonal ``sqrt_diag`` ``(c, d)`` (positions move
    ``eps * sqrt_diag * u``; gradients enter scaled by ``sqrt_diag``).
    Returns ``step(eps, x, u, logp, g) -> (x', u', logp', g', dE)`` with
    ``dE`` ``(c,)`` the microcanonical energy change of the step. One
    gradient evaluation per step (the boundary gradient is carried)."""

    def step(eps, x, u, logp, g):
        u1, k1 = _iso_momentum_update(u, sqrt_diag * g, 0.5 * eps)
        x1 = x + _col(eps) * (sqrt_diag * u1)
        logp1, g1 = value_and_grad_fn(x1)
        u2, k2 = _iso_momentum_update(u1, sqrt_diag * g1, 0.5 * eps)
        d_energy = (k1 + k2) - (logp1 - logp)
        return x1, u2, logp1, g1, d_energy

    return step


# McLachlan & Atela's minimal-norm second-order coefficient
_MN_LAMBDA = 0.1931833275037836


def isokinetic_mclachlan(value_and_grad_fn, sqrt_diag):
    """One minimal-norm (McLachlan) second-order step of the isokinetic
    dynamics: u(lam*eps) x(eps/2) u((1-2lam)*eps) x(eps/2) u(lam*eps), two
    gradient evaluations per step (boundary gradient carried). Same
    signature as :func:`isokinetic_velocity_verlet`."""

    def step(eps, x, u, logp, g):
        u1, k1 = _iso_momentum_update(u, sqrt_diag * g, _MN_LAMBDA * eps)
        x1 = x + _col(0.5 * eps) * (sqrt_diag * u1)
        _, g1 = value_and_grad_fn(x1)
        u2, k2 = _iso_momentum_update(u1, sqrt_diag * g1,
                                      (1.0 - 2.0 * _MN_LAMBDA) * eps)
        x2 = x1 + _col(0.5 * eps) * (sqrt_diag * u2)
        logp2, g2 = value_and_grad_fn(x2)
        u3, k3 = _iso_momentum_update(u2, sqrt_diag * g2, _MN_LAMBDA * eps)
        d_energy = (k1 + k2 + k3) - (logp2 - logp)
        return x2, u3, logp2, g2, d_energy

    return step


_INTEGRATORS = {"velocity_verlet": isokinetic_velocity_verlet,
                "mclachlan": isokinetic_mclachlan}
# gradient evaluations per integrator step
_GRADS_PER_STEP = {"velocity_verlet": 1, "mclachlan": 2}


def _get_integrator(name):
    try:
        return _INTEGRATORS[name]
    except KeyError:
        raise ValueError(
            f"integrator must be one of {sorted(_INTEGRATORS)}, got "
            f"{name!r}") from None


def partial_velocity_refresh(z, u, eps, L):
    """Langevin partial refresh of each chain's velocity ``u`` ``(c, d)``:
    ``u <- (u + nu z)/|u + nu z|`` with ``nu = sqrt(expm1(2 eps / L) / d)``,
    the exact OU-on-the-sphere weight that decorrelates the velocity over
    distance ``L``. ``z`` ``(c, d)`` is the standard normal noise the JAX
    function draws from its key."""
    dim = u.shape[-1]
    nu = torch.sqrt(torch.expm1(2.0 * eps / L) / dim).to(u.dtype)
    w = u + _col(nu) * z
    return w / torch.clamp_min(_norm(w), _TINY)[:, None]


def _random_unit(z):
    """Standard normal noise ``z`` ``(c, d)`` as unit vectors: a uniform
    direction per chain."""
    return z / torch.clamp_min(_norm(z), _TINY)[:, None]


def _pooled_var_update(var_ema, position, rate, adapting):
    """EWMA of the instantaneous cross-chain per-dimension variance, pooled
    over the chains, so every chain carries the same estimate."""
    m1 = position.mean(dim=0)
    m2 = (position * position).mean(dim=0)
    var_inst = torch.clamp_min(m2 - m1 * m1, 0.0)
    new = var_ema + rate * (var_inst - var_ema)
    return torch.where(adapting[:, None], new, var_ema)


def _auto_L(var_ema, sqrt_diag, l_factor, eps):
    """Robnik et al. stage-1 heuristic in the whitened metric:
    ``l_factor * sqrt(sum var_i / diag_i)``; floored at ``2 eps`` so the
    refresh never degenerates."""
    whitened = var_ema / torch.clamp_min(sqrt_diag * sqrt_diag, _TINY)
    return torch.maximum(l_factor * torch.sqrt(whitened.sum(-1)), 2.0 * eps)


class MCLMCState(NamedTuple):
    """Chain-batched MCLMC state (chain batch ``c`` leading)."""
    position: torch.Tensor    # (c, d)
    velocity: torch.Tensor    # (c, d) unit norm
    logdens: torch.Tensor     # (c,) box_log_kernel(position)
    grad: torch.Tensor        # (c, d) its gradient (carried across steps)
    da: adaptation.DualAveraging
    log_L: torch.Tensor       # (c,)
    var_ema: torch.Tensor     # (c, d) pooled cross-chain variance, EWMA
    sqrt_diag: torch.Tensor   # (c, d) diagonal preconditioner (ones if off)
    draw_ind: torch.Tensor    # (c,) int32


class MAMSState(NamedTuple):
    """Chain-batched MAMS state (chain batch ``c`` leading)."""
    position: torch.Tensor
    logdens: torch.Tensor
    grad: torch.Tensor
    da: adaptation.DualAveraging
    log_L: torch.Tensor
    var_ema: torch.Tensor
    sqrt_diag: torch.Tensor
    draw_ind: torch.Tensor


def _finite_value_and_grad(box_log_kernel):
    """``fn(z) -> (value (c,), grad (c, d))`` of a batched log-kernel in one
    autograd pass, a non-finite value read as ``-inf``."""

    def fn(z):
        with torch.enable_grad():
            zz = z.detach().requires_grad_(True)
            v = box_log_kernel(zz)
            (g,) = torch.autograd.grad(v.sum(), zz, allow_unused=True)
        v = v.detach()
        g = torch.zeros_like(z) if g is None else g
        return torch.where(torch.isfinite(v), v, -torch.inf), g

    return fn


def _adapt_scales(state, position, eps, adapting, rate, adapt_mass, auto_L,
                  l_factor):
    """The pooled variance EWMA, the diagonal preconditioner and ``log L``
    after a transition, shared by MCLMC and MAMS."""
    var_ema = _pooled_var_update(state.var_ema, position, rate, adapting)
    sqrt_diag = state.sqrt_diag
    if adapt_mass:
        sqrt_diag = torch.where(adapting[:, None],
                                torch.sqrt(torch.clamp_min(var_ema, _TINY)),
                                state.sqrt_diag)
    log_L = state.log_L
    if auto_L:
        log_L = torch.where(
            adapting, torch.log(_auto_L(var_ema, sqrt_diag, l_factor, eps)),
            state.log_L)
    return var_ema, sqrt_diag, log_L


def _da_step(da, stat, target, adapting):
    da_new = adaptation.da_update(da, stat, target)
    return adaptation.DualAveraging(*[torch.where(adapting, new, old)
                                      for new, old in zip(da_new, da)])


def _init_common(vg, position, L0, eps0):
    """The fields MCLMC and MAMS start alike: value and gradient, dual
    averaging from ``eps0``, ``log L0``, unit variance and preconditioner."""
    c, dim = position.shape
    kw = {"dtype": position.dtype, "device": position.device}
    logp, g = vg(position)
    return dict(
        logdens=logp, grad=g,
        da=adaptation.da_init(torch.full((c,), float(eps0), **kw)),
        log_L=torch.log(torch.full((c,), float(L0), **kw)),
        var_ema=torch.ones((c, dim), **kw),
        sqrt_diag=torch.ones((c, dim), **kw),
        draw_ind=torch.zeros((c,), dtype=torch.int32, device=position.device),
    )


def build_mclmc_kernel(box_log_kernel, cfg: MCLMCSettings, n_adapt: int,
                       adapt_mass: bool = False):
    """Batch-pooled unadjusted MCLMC transition: returns ``init(gen,
    positions, L0, eps0) -> MCLMCState`` and ``step(gen, state) -> (state,
    info)``. ``step.draw(gen, state) -> (z,)`` (the refresh noise) and
    ``step.transition(state, z)`` are its two halves; ``step.counts``
    tallies draws, integrator steps (``leapfrogs``), gradients and host
    synchronisations (none)."""
    desired = float(cfg.desired_energy_var)
    l_factor = float(cfg.l_factor)
    rate = float(cfg.variance_ema_rate)
    auto_L = float(cfg.L) == 0.0
    vg = _finite_value_and_grad(box_log_kernel)
    make_integrator = _get_integrator(cfg.integrator)
    grads = _GRADS_PER_STEP[cfg.integrator]
    counts = {"draws": 0, "leapfrogs": 0, "gradients": 0, "syncs": 0}

    def draw(gen, state: MCLMCState):
        pos = state.position
        return (torch.randn(pos.shape, generator=gen, dtype=pos.dtype,
                            device=pos.device),)

    def transition(state: MCLMCState, z):
        dim = state.position.shape[1]
        adapting = state.draw_ind < n_adapt
        eps = torch.exp(torch.where(adapting, state.da.log_eps,
                                    state.da.log_eps_bar))
        L = torch.exp(state.log_L)
        vv = make_integrator(vg, state.sqrt_diag)

        x1, u1, logp1, g1, d_energy = vv(
            eps, state.position, state.velocity, state.logdens, state.grad)
        counts["draws"] += 1
        counts["leapfrogs"] += 1
        counts["gradients"] += grads

        # a non-finite step must not kill an unadjusted chain: bounce (keep
        # the position, flip the velocity)
        ok = torch.isfinite(logp1) & torch.isfinite(x1).all(-1) \
            & torch.isfinite(u1).all(-1)
        position = where_chains(ok, x1, state.position)
        velocity = where_chains(ok, u1, -state.velocity)
        logdens = torch.where(ok, logp1, state.logdens)
        grad = where_chains(ok, g1, state.grad)

        velocity = partial_velocity_refresh(z, velocity, eps, L)

        # step-size tuning: pooled per-dim energy-error variance
        de2 = torch.where(ok & torch.isfinite(d_energy), d_energy * d_energy,
                          10.0 * desired * dim)
        var_e = de2.mean().expand(de2.shape) / dim
        energy_stat = torch.exp(-0.5 * var_e / desired)
        da = _da_step(state.da, energy_stat, _ENERGY_STAT_TARGET, adapting)
        var_ema, sqrt_diag, log_L = _adapt_scales(
            state, position, eps, adapting, rate, adapt_mass, auto_L,
            l_factor)

        new_state = MCLMCState(
            position=position, velocity=velocity, logdens=logdens, grad=grad,
            da=da, log_L=log_L, var_ema=var_ema, sqrt_diag=sqrt_diag,
            draw_ind=state.draw_ind + 1,
        )
        info = {
            "accepted": ok,
            "energy_change": torch.where(torch.isfinite(d_energy), d_energy,
                                         0.0),
            "step_size": eps,
            "L": L,
        }
        return new_state, info

    def step(gen, state: MCLMCState):
        return transition(state, *draw(gen, state))

    def init(gen, position, L0, eps0):
        with torch.no_grad():
            velocity = _random_unit(torch.randn(
                position.shape, generator=gen, dtype=position.dtype,
                device=position.device))
            return MCLMCState(position=position, velocity=velocity,
                              **_init_common(vg, position, L0, eps0))

    step.draw, step.transition, step.counts = draw, transition, counts
    return init, step


def build_mams_kernel(box_log_kernel, cfg: MAMSSettings, n_adapt: int,
                      adapt_mass: bool = False):
    """Batch-pooled Metropolis-adjusted microcanonical transition: full
    velocity refresh + shared Halton-jittered isokinetic trajectory + accept
    on the accumulated energy error. Returns ``init(gen, positions, L0,
    eps0) -> MAMSState`` (``gen`` unused: the velocity is refreshed every
    draw) and ``step(gen, state) -> (state, info)``; ``step.draw(gen,
    state) -> (z, u)`` (the velocity noise, the accept uniform) and
    ``step.transition(state, z, u)`` are its two halves; ``step.counts``
    tallies draws, integrator steps, gradients and host synchronisations."""
    target = float(cfg.target_accept_rate)
    max_steps = int(cfg.max_leap_steps)
    l_factor = float(cfg.l_factor)
    rate = float(cfg.variance_ema_rate)
    auto_L = float(cfg.L) == 0.0
    vg = _finite_value_and_grad(box_log_kernel)
    make_integrator = _get_integrator(cfg.integrator)
    grads = _GRADS_PER_STEP[cfg.integrator]
    counts = {"draws": 0, "leapfrogs": 0, "gradients": 0, "syncs": 0}

    def draw(gen, state: MAMSState):
        pos = state.position
        kw = {"generator": gen, "dtype": pos.dtype, "device": pos.device}
        return torch.randn(pos.shape, **kw), torch.rand(pos.shape[:1], **kw)

    def transition(state: MAMSState, z, u):
        pos = state.position
        adapting = state.draw_ind < n_adapt
        eps = torch.exp(torch.where(adapting, state.da.log_eps,
                                    state.da.log_eps_bar))
        L = torch.exp(state.log_L)
        vv = make_integrator(vg, state.sqrt_diag)

        # shared jitter (the ChEES Halton trick): t in [L/2, 3L/2], mean L
        h = _vdc_base2(state.draw_ind + 1).to(pos.dtype)
        steps = _leap_count((0.5 + h) * L, eps, max_steps)

        # the draw's one host synchronisation: the loop's length
        lo, hi = torch.stack(torch.aminmax(steps)).tolist()
        counts["syncs"] += 1
        counts["draws"] += 1
        counts["leapfrogs"] += hi
        counts["gradients"] += grads * hi
        x, v, logp, g = pos, _random_unit(z), state.logdens, state.grad
        d_energy = torch.zeros_like(logp)
        for i in range(hi):
            x1, v1, logp1, g1, de = vv(eps, x, v, logp, g)
            if i < lo:
                x, v, logp, g, d_energy = x1, v1, logp1, g1, d_energy + de
            else:   # chains whose own count is reached keep their state
                go = i < steps
                x, v, g = (where_chains(go, x1, x), where_chains(go, v1, v),
                           where_chains(go, g1, g))
                logp = torch.where(go, logp1, logp)
                d_energy = torch.where(go, d_energy + de, d_energy)

        log_alpha = torch.clamp_max(-d_energy, 0.0)
        alpha = torch.where(torch.isnan(log_alpha), 0.0, torch.exp(log_alpha))
        accepted = u < alpha

        position = where_chains(accepted, x, pos)
        logdens = torch.where(accepted, logp, state.logdens)
        grad = where_chains(accepted, g, state.grad)

        da = _da_step(state.da, alpha.mean().expand(alpha.shape), target,
                      adapting)
        var_ema, sqrt_diag, log_L = _adapt_scales(
            state, position, eps, adapting, rate, adapt_mass, auto_L,
            l_factor)

        new_state = MAMSState(
            position=position, logdens=logdens, grad=grad, da=da,
            log_L=log_L, var_ema=var_ema, sqrt_diag=sqrt_diag,
            draw_ind=state.draw_ind + 1,
        )
        info = {
            "accepted": accepted,
            "accept_stat": alpha,
            "n_leap": steps,
            "step_size": eps,
            "trajectory_length": L,
        }
        return new_state, info

    def step(gen, state: MAMSState):
        return transition(state, *draw(gen, state))

    def init(gen, position, L0, eps0):
        del gen  # velocity is refreshed every draw
        with torch.no_grad():
            return MAMSState(position=position,
                             **_init_common(vg, position, L0, eps0))

    step.draw, step.transition, step.counts = draw, transition, counts
    return init, step


def _resolve_scales(cfg, dim, default_eps_frac):
    """(L0, eps0) with 0.0-means-auto defaults: L0 = sqrt(dim) (the whitened
    standard-Gaussian value the adaptation then corrects), eps0 a fixed
    fraction of L0."""
    L0 = float(cfg.L) if float(cfg.L) > 0.0 else float(dim) ** 0.5
    eps0 = float(cfg.step_size) if float(cfg.step_size) > 0.0 \
        else default_eps_frac * L0
    return L0, eps0


def _run_common(prob, init, step, L0, eps0, gen, algo, s, mesh,
                checkpoint_dir, checkpoint_every, thin, return_resume,
                extra_diags):
    """Shared run-and-assemble tail for mclmc/mams."""
    state0 = init(gen, prob.first_draw, L0, eps0)

    def assemble(key, state0, n_burnin, n_keep):
        final_state, draws, infos = common.run_sampler_loop(
            resolve_key(key, algo, prob.device), state0, step, n_burnin,
            n_keep, collect_fn=lambda st: st.position, mesh=mesh,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            thin=thin,
        )
        n_accept = common.tally_accepts(infos)
        draws = common.finalize_draws(draws, prob)
        diagnostics = extra_diags(infos, n_keep)
        diagnostics["adapted_step_size"] = torch.exp(
            final_state.da.log_eps_bar[0])
        diagnostics["adapted_L"] = torch.exp(final_state.log_L[0])
        if prob.squeeze:
            draws = draws[:, 0, :]
            n_accept = n_accept[0]
            diagnostics = {k: (v[:, 0] if v.ndim == 2 else
                               (v[0] if v.ndim == 1 else v))
                           for k, v in diagnostics.items()}
        if thin > 1:
            diagnostics["thin"] = int(thin)
        return SamplerResult(draws=draws, n_accept_draws=n_accept,
                             diagnostics=diagnostics), final_state

    result, final_state = assemble(gen, state0, s.n_burnin_draws,
                                   s.n_keep_draws)
    if return_resume:
        common.attach_resume(result, assemble, final_state)
    return result


def _check_problem(prob, name):
    if prob.n_vals < 2:
        raise ValueError(f"{name} needs dim >= 2 (the isokinetic dynamics "
                         "divide by dim-1); use mala/slice for 1-d targets")
    if prob.n_chains < 2:
        raise ValueError(f"{name} needs n_chains >= 2 (step-size and L "
                         "tuning pool cross-chain statistics)")


def mclmc(initial_vals, log_kernel, settings=None, *, n_chains=None, key=None,
          mesh=None, checkpoint_dir=None, checkpoint_every=500, dtype=None,
          adapt_mass=False, thin=1, return_resume=False,
          device=None) -> SamplerResult:
    """Unadjusted Microcanonical Langevin Monte Carlo (module docstring).

    One integrator step per draw, no accept/reject, lockstep across the
    chain batch; ``adapt_mass=True`` turns on diagonal preconditioning from
    the pooled cross-chain variances. Diagnostics: per-draw
    ``energy_change``, ``step_size``, ``L``, plus the adapted values (of
    chain 0; pooled, every chain holds them); ``accepted`` counts *finite*
    steps. ``log_kernel`` is batched: ``(n_chains, n_vals) -> (n_chains,)``;
    ``key`` a ``torch.Generator`` or an integer seed; ``device`` defaults to
    that of ``initial_vals``, else the card. ``mesh`` is not ported yet and
    raises; ``checkpoint_dir`` runs in restartable chunks
    (:mod:`mcmc_tpu_torch.checkpoint`).
    """
    algo, s = resolve_settings(settings, "mclmc_settings", MCLMCSettings)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")
    prob = common.setup_problem(initial_vals, log_kernel, algo, n_chains,
                                dtype, device)
    _check_problem(prob, "mclmc")
    gen = resolve_key(key, algo, prob.device)
    L0, eps0 = _resolve_scales(s, prob.n_vals, default_eps_frac=0.1)
    init, step = build_mclmc_kernel(prob.box_log_kernel, s, s.n_burnin_draws,
                                    adapt_mass)

    def extra_diags(infos, n_keep):
        if "energy_change" in infos:
            return {"energy_change": infos["energy_change"],
                    "step_size": infos["step_size"], "L": infos["L"]}
        totals = infos["totals"]      # checkpointed run
        return {"mean_energy_change":
                torch.as_tensor(totals["energy_change"]) / n_keep}

    return _run_common(prob, init, step, L0, eps0, gen, algo, s, mesh,
                       checkpoint_dir, checkpoint_every, thin, return_resume,
                       extra_diags)


def mams(initial_vals, log_kernel, settings=None, *, n_chains=None, key=None,
         mesh=None, checkpoint_dir=None, checkpoint_every=500, dtype=None,
         adapt_mass=False, thin=1, return_resume=False,
         device=None) -> SamplerResult:
    """Metropolis-adjusted microcanonical sampler (module docstring).

    Exact stationary distribution: full velocity refresh + a shared
    Halton-jittered isokinetic trajectory per draw, accepted on the
    accumulated microcanonical energy error. Arguments as :func:`mclmc`.
    """
    algo, s = resolve_settings(settings, "mams_settings", MAMSSettings)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")
    prob = common.setup_problem(initial_vals, log_kernel, algo, n_chains,
                                dtype, device)
    _check_problem(prob, "mams")
    gen = resolve_key(key, algo, prob.device)
    L0, eps0 = _resolve_scales(s, prob.n_vals, default_eps_frac=0.05)
    init, step = build_mams_kernel(prob.box_log_kernel, s, s.n_burnin_draws,
                                   adapt_mass)

    def extra_diags(infos, n_keep):
        if "accept_stat" in infos:
            return {"accept_stat": infos["accept_stat"],
                    "n_leap": infos["n_leap"],
                    "step_size": infos["step_size"],
                    "trajectory_length": infos["trajectory_length"]}
        totals = infos["totals"]      # checkpointed run
        return {"mean_accept_stat":
                torch.as_tensor(totals["accept_stat"]) / n_keep,
                "mean_n_leap": torch.as_tensor(totals["n_leap"]) / n_keep}

    return _run_common(prob, init, step, L0, eps0, gen, algo, s, mesh,
                       checkpoint_dir, checkpoint_every, thin, return_resume,
                       extra_diags)
