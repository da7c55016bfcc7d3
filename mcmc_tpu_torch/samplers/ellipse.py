"""Elliptical slice sampling (PyTorch port of
``mcmc_tpu.samplers.ellipse``).

Murray, Adams & MacKay (2010), for ``posterior(x) ∝ N(x; mu, Sigma)
exp(log_lik(x))``. One draw (the paper's Fig. 2):

    nu    ~ N(0, Sigma)                       (one prior draw)
    log_y = log_lik(x) + log U(0, 1)          (slice level)
    theta ~ U(0, 2 pi); bracket [theta - 2 pi, theta]
    repeat: x' = (x - mu) cos(theta) + nu sin(theta) + mu
            accept if log_lik(x') > log_y
            else shrink the bracket toward 0 and redraw theta

No step size, scale or mass to tune; every draw moves unless the
``max_shrink_steps`` safety cap binds (the chain then stays in place and
the draw reports as not accepted). Box constraints are rejected: the
Gaussian prior defines the geometry.

The JAX package vmaps a single-chain kernel whose shrinkage is a
``lax.while_loop`` that splits a new key every iteration. Here the chain
batch runs the loop in lockstep, one batched likelihood evaluation an
iteration, and a chain whose loop has ended keeps its result (position,
log-likelihood, shrink count) frozen, as a vmapped ``while_loop`` keeps a
finished lane's carry (its bracket and angle, read no more, move
unmasked). The loop tests its end on the host once an iteration (one host
synchronisation: a fixed ``max_shrink_steps`` loop would cost 64
likelihood evaluations where a few are typical). The random numbers of a
draw are drawn up front (``step.draw``): the prior's normals, the slice
level's uniform, the first angle's uniform and ``max_shrink_steps``
uniforms for the redrawn angles, of which a chain uses the first as many as
it iterates. The redrawn angle is JAX's ``uniform(minval=lo, maxval=hi)``
(``samplers.slice.uniform_between``). ``shrink_steps`` is JAX's count of
iterations.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mcmc_tpu_torch.results import SamplerResult
from mcmc_tpu_torch.settings import EllipticalSettings
from mcmc_tpu_torch.samplers import common
from mcmc_tpu_torch.samplers._resolve import resolve_settings, resolve_key
from mcmc_tpu_torch.samplers.slice import uniform_between

__all__ = ["elliptical_slice", "EllipticalSliceState",
           "build_elliptical_kernel"]

_TWO_PI = 2.0 * math.pi


class EllipticalSliceState(NamedTuple):
    position: torch.Tensor   # (c, d), the prior's own coordinates
    log_lik: torch.Tensor    # (c,) log_lik at position (-inf if non-finite)


def build_elliptical_kernel(log_lik, mu, spd: common.SPD, max_steps: int):
    """Batched elliptical slice draw: returns ``init(positions) ->
    EllipticalSliceState`` and ``step(gen, state) -> (state, info)``, info
    ``accepted`` (slice point found before the cap) and ``shrink_steps``
    (int32, likelihood evaluations). ``mu`` ``(d,)`` is the prior mean,
    ``spd`` the prior covariance. ``step.draw(gen, state) -> (xi, u, u_theta,
    u_shrink)`` (``(c, d)`` normals, ``(c,)``, ``(c,)`` and ``(c,
    max_steps)`` uniforms) and ``step.transition(state, xi, u, u_theta,
    u_shrink)`` are its two halves; ``step.counts`` tallies draws, batched
    likelihood evaluations and host synchronisations."""
    max_steps = int(max_steps)
    counts = {"draws": 0, "evaluations": 0, "syncs": 0}

    def ll_batch(x):
        counts["evaluations"] += 1
        v = log_lik(x)
        return torch.where(torch.isfinite(v), v, -torch.inf)

    def init(position):
        with torch.no_grad():
            return EllipticalSliceState(position=position,
                                        log_lik=ll_batch(position))

    def draw(gen, state: EllipticalSliceState):
        pos = state.position
        kw = {"generator": gen, "dtype": pos.dtype, "device": pos.device}
        c = pos.shape[0]
        return (torch.randn(pos.shape, **kw), torch.rand((c,), **kw),
                torch.rand((c,), **kw), torch.rand((c, max_steps), **kw))

    def transition(state: EllipticalSliceState, xi, u, u_theta, u_shrink):
        counts["draws"] += 1
        nu = spd.sqrt_mv(xi)
        log_y = state.log_lik + torch.log(u)
        theta = u_theta * _TWO_PI
        lo, hi = theta - _TWO_PI, theta
        x_c = state.position - mu
        done = torch.zeros_like(u, dtype=torch.bool)
        # a chain's shrink steps: the iteration it ends in, the cap if none
        it = torch.full(u.shape, max_steps, dtype=torch.int32,
                        device=u.device)
        xp, llp = state.position, state.log_lik
        u_shrink = u_shrink.double()   # uniform_between's, once a draw
        for t in range(max_steps):
            x_prop = x_c * torch.cos(theta)[:, None] \
                + nu * torch.sin(theta)[:, None] + mu
            ll = ll_batch(x_prop)
            ok = ~done & (ll > log_y)
            xp = common.where_chains(ok, x_prop, xp)
            llp = torch.where(ok, ll, llp)
            it = torch.where(ok, t + 1, it)
            done = done | ok
            # a finished chain's bracket and angle are read no more, so
            # they move unmasked
            lo = torch.where(theta < 0.0, theta, lo)
            hi = torch.where(theta >= 0.0, theta, hi)
            theta = uniform_between(u_shrink[:, t], lo, hi)
            if t + 1 < max_steps:
                counts["syncs"] += 1
                if bool(done.all()):
                    break
        return (EllipticalSliceState(position=xp, log_lik=llp),
                {"accepted": done, "shrink_steps": it})

    def step(gen, state: EllipticalSliceState):
        return transition(state, *draw(gen, state))

    step.draw, step.transition, step.counts = draw, transition, counts
    return init, step


def elliptical_slice(initial_vals, log_lik, settings=None, *,
                     prior_mean=None, prior_cov=None, n_chains=None,
                     key=None, mesh=None, checkpoint_dir=None,
                     checkpoint_every=500, dtype=None, thin=1,
                     return_resume=False, device=None) -> SamplerResult:
    """Run elliptical slice sampling on ``posterior(x) ∝ N(x; prior_mean,
    prior_cov) exp(log_lik(x))``. ``log_lik`` is batched: ``(n_chains,
    n_vals) -> (n_chains,)``, without the Gaussian prior's factor (the
    ellipse handles it). ``prior_mean`` defaults to zeros; ``prior_cov``
    is ``None`` (identity), a scalar, a 1-D diagonal or a 2-D SPD matrix
    (its Cholesky factor computed once).

    ``diagnostics["mean_shrink_steps"]`` reports the likelihood evaluations
    per draw. Box constraints (``vals_bound``) are rejected. ``key`` is a
    ``torch.Generator`` or an integer seed; ``device`` defaults to that of
    ``initial_vals``, else the card. ``mesh`` is not ported yet and raises;
    ``checkpoint_dir`` runs in restartable chunks
    (:mod:`mcmc_tpu_torch.checkpoint`)."""
    algo, s = resolve_settings(settings, "elliptical_settings",
                               EllipticalSettings)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")
    if algo.vals_bound:
        raise ValueError(
            "elliptical_slice does not support vals_bound: the Gaussian "
            "prior defines the sampling geometry; return -inf from log_lik "
            "outside the feasible set, or reparameterize")
    if int(s.max_shrink_steps) < 1:
        raise ValueError(f"max_shrink_steps must be >= 1, got "
                         f"{s.max_shrink_steps}")

    prob = common.setup_problem(initial_vals, log_lik, algo, n_chains, dtype,
                                device)
    gen = resolve_key(key, algo, prob.device)
    spd = common.make_spd(prior_cov, prob.n_vals, prob.dtype, prob.device)
    mu = torch.zeros((prob.n_vals,), dtype=prob.dtype, device=prob.device) \
        if prior_mean is None else torch.broadcast_to(torch.as_tensor(
            prior_mean, dtype=prob.dtype, device=prob.device),
            (prob.n_vals,))

    init, step = build_elliptical_kernel(prob.box_log_kernel, mu, spd,
                                         s.max_shrink_steps)
    state0 = init(prob.first_draw)

    def assemble(key, state0, n_burnin, n_keep):
        final_state, draws, infos = common.run_sampler_loop(
            resolve_key(key, algo, prob.device), state0, step, n_burnin,
            n_keep, collect_fn=lambda st: st.position, mesh=mesh,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, thin=thin)
        n_accept = common.tally_accepts(infos)
        if "shrink_steps" in infos:
            shrink = infos["shrink_steps"].to(prob.dtype).mean(dim=0)
        else:       # checkpointed run: the per-chain totals
            shrink = torch.as_tensor(infos["totals"]["shrink_steps"]).to(
                prob.dtype) / n_keep
        diagnostics = {"mean_shrink_steps": shrink}
        if prob.squeeze:
            draws = draws[:, 0, :]
            n_accept = n_accept[0]
            diagnostics = {k: v[0] for k, v in diagnostics.items()}
        if thin > 1:   # accept_rate divides by n_keep*thin
            diagnostics["thin"] = int(thin)
        return SamplerResult(draws=draws, n_accept_draws=n_accept,
                             diagnostics=diagnostics), final_state

    result, final_state = assemble(gen, state0, s.n_burnin_draws,
                                   s.n_keep_draws)
    if return_resume:
        common.attach_resume(result, assemble, final_state)
    return result
