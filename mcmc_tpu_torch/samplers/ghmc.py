"""Generalized HMC with persistent momentum, Horowitz 1991 (PyTorch port of
``mcmc_tpu.samplers.ghmc``).

No reference analog (the reference's HMC, src/hmc.cpp:30-254, refreshes the
momentum fully every draw). GHMC refreshes it partially,

    p' = alpha * p + sqrt(1 - alpha^2) * chol(M) xi ,    xi ~ N(0, I)

then runs one short leapfrog trajectory and a Metropolis test that NEGATES
the momentum on rejection (the flip keeps the kernel exactly invariant).
See the JAX module's docstring for the construction and the bench protocol.

The kernel is batched over chains and needs no host synchronisation: every
chain runs ``n_leap_steps`` leapfrogs. Dual averaging is per chain, not
pooled (each chain keeps its own step size), and the step-size jitter is a
per-chain uniform. A transition is a draw of its random numbers from the
run's one ``torch.Generator`` (``step.draw``: the refresh noise, the jitter
uniform when ``jitter > 0``, the accept uniform) followed by a function of
those draws (``step.transition``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mcmc_tpu_torch import adaptation, integrators
from mcmc_tpu_torch.results import SamplerResult
from mcmc_tpu_torch.settings import GHMCSettings
from mcmc_tpu_torch.samplers import common
from mcmc_tpu_torch.samplers._resolve import resolve_settings, resolve_key

__all__ = ["ghmc", "GHMCState", "build_ghmc_kernel"]


class GHMCState(NamedTuple):
    position: torch.Tensor     # (c, d) unconstrained coordinates
    potential: torch.Tensor    # (c,) U = -box_log_kernel(position)
    momentum: torch.Tensor     # (c, d) persistent momentum, covariance M
    da: adaptation.DualAveraging   # (c,) each, one per chain
    draw_ind: torch.Tensor     # (c,) int32


def build_ghmc_kernel(box_log_kernel, grad_fn, precond: common.SPD,
                      step_size, alpha, n_leap_steps, jitter,
                      adapt_cfg=None):
    """Batched GHMC transition: returns ``init(positions) -> GHMCState`` and
    ``step(gen, state) -> (state, info)``.

    ``alpha`` in [0, 1) is the momentum persistence (0 = plain HMC with
    ``n_leap_steps`` steps); ``jitter`` in [0, 1) scales the step size
    uniformly in ``[(1-jitter) eps, eps]`` per draw per chain.
    ``adapt_cfg``: dual-averaging step-size tuning (n_burnin, target).
    ``step.draw(gen, state) -> (xi, u_jitter or None, u_accept)`` and
    ``step.transition(state, xi, u_jitter, u_accept)`` are its two halves;
    ``step.counts`` tallies transitions, leapfrogs and host
    synchronisations (none).
    """
    alpha = float(alpha)
    beta = (1.0 - alpha * alpha) ** 0.5
    n_leap_steps = int(n_leap_steps)

    def init(position):
        with torch.no_grad():
            potential = -box_log_kernel(position)
        return GHMCState(
            position=position,
            potential=potential,
            momentum=torch.zeros_like(position),
            da=adaptation.da_init(torch.full(
                position.shape[:1], float(step_size), dtype=position.dtype,
                device=position.device)),
            draw_ind=torch.zeros(position.shape[:1], dtype=torch.int32,
                                 device=position.device),
        )

    counts = {"draws": 0, "leapfrogs": 0, "syncs": 0}

    def draw(gen, state: GHMCState):
        pos = state.position
        kw = {"generator": gen, "dtype": pos.dtype, "device": pos.device}
        xi = torch.randn(pos.shape, **kw)
        u_jit = torch.rand(pos.shape[:1], **kw) if jitter > 0.0 else None
        return xi, u_jit, torch.rand(pos.shape[:1], **kw)

    def transition(state: GHMCState, xi, u_jit, u_accept):
        pos = state.position
        if adapt_cfg is None:
            eps = step_size
        else:
            adapting = state.draw_ind < adapt_cfg["n_burnin"]
            eps = torch.exp(torch.where(adapting, state.da.log_eps,
                                        state.da.log_eps_bar))
        if jitter > 0.0:
            eps = eps * (1.0 - jitter * u_jit)

        # partial momentum refresh (exact N(0, M) invariant mix)
        p = alpha * state.momentum + beta * precond.sqrt_mv(xi)
        prev_K = integrators.kinetic_energy(p, precond.inv_mv)

        new_pos, new_mom = integrators.leapfrog(
            grad_fn, precond.inv_mv, eps, n_leap_steps, pos, p)
        counts["draws"] += 1
        counts["leapfrogs"] += n_leap_steps

        prop_U = -box_log_kernel(new_pos)
        prop_U = torch.where(torch.isfinite(prop_U), prop_U, torch.inf)
        prop_K = integrators.kinetic_energy(new_mom, precond.inv_mv)

        delta = -(prop_U + prop_K) + (state.potential + prev_K)
        comp = torch.clamp_max(delta, 0.0)
        accepted = torch.log(u_accept) < comp

        position = common.where_chains(accepted, new_pos, pos)
        potential = torch.where(accepted, prop_U, state.potential)
        # Horowitz flip: the rejected move keeps the refreshed momentum
        # NEGATED, which detailed balance of the persistent chain requires
        momentum = common.where_chains(accepted, new_mom, -p)

        da = state.da
        if adapt_cfg is not None:
            accept_stat = torch.clamp_max(torch.exp(delta), 1.0)
            accept_stat = torch.where(torch.isnan(accept_stat), 0.0,
                                      accept_stat)
            da_new = adaptation.da_update(da, accept_stat,
                                          adapt_cfg["target"])
            da = adaptation.DualAveraging(*[torch.where(adapting, new, old)
                                            for new, old in zip(da_new, da)])

        new_state = GHMCState(position=position, potential=potential,
                              momentum=momentum, da=da,
                              draw_ind=state.draw_ind + 1)
        return new_state, {"accepted": accepted, "energy_error": delta}

    def step(gen, state: GHMCState):
        return transition(state, *draw(gen, state))

    step.draw, step.transition, step.counts = draw, transition, counts
    return init, step


def ghmc(initial_vals, log_kernel, settings=None, *, n_chains=None,
         key=None, mesh=None, checkpoint_dir=None, checkpoint_every=500,
         dtype=None, bounded_grad="reference", adapt_step_size=True,
         target_accept=None, thin=1, return_resume=False,
         device=None) -> SamplerResult:
    """Run generalized HMC with persistent momentum (module docstring).

    ``momentum_persistence`` (settings) sets alpha, 0.0 = auto
    ``exp(-step_size/sqrt(dim))`` from the NOMINAL (initial) step size;
    ``adapt_step_size`` (default on) dual-averages each chain toward 0.95
    acceptance; ``jitter`` desynchronizes per-chain step sizes.
    ``log_kernel`` is batched: ``(n_chains, n_vals) -> (n_chains,)``.
    ``key`` is a ``torch.Generator`` or an integer seed (``None``: the
    settings' ``rng_seed_value``); ``device`` defaults to that of
    ``initial_vals``, else the card. ``mesh`` is not ported yet and raises;
    ``checkpoint_dir`` runs in restartable chunks
    (:mod:`mcmc_tpu_torch.checkpoint`).
    """
    algo, s = resolve_settings(settings, "ghmc_settings", GHMCSettings)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")
    if not (0.0 <= float(s.momentum_persistence) < 1.0):
        raise ValueError(f"momentum_persistence must be in [0, 1), got "
                         f"{s.momentum_persistence}")
    if not (0.0 <= float(s.jitter) < 1.0):
        raise ValueError(f"jitter must be in [0, 1), got {s.jitter}")

    prob = common.setup_problem(initial_vals, log_kernel, algo, n_chains,
                                dtype, device)
    gen = resolve_key(key, algo, prob.device)
    precond = common.make_spd(s.precond_mat, prob.n_vals, prob.dtype,
                              prob.device)
    grad_fn = integrators.make_kick_grad(prob, bounded_grad)

    adapt_cfg = None
    if adapt_step_size:
        adapt_cfg = {
            "n_burnin": s.n_burnin_draws,
            "target": (adaptation.TARGET_ACCEPT["ghmc"]
                       if target_accept is None else target_accept),
        }

    alpha = float(s.momentum_persistence)
    if alpha == 0.0:
        # from the NOMINAL step size, on purpose: see the JAX module
        alpha = math.exp(-float(s.step_size) / math.sqrt(prob.n_vals))
    init, step = build_ghmc_kernel(
        prob.box_log_kernel, grad_fn, precond, s.step_size, alpha,
        int(s.n_leap_steps), float(s.jitter), adapt_cfg)
    state0 = init(prob.first_draw)

    def assemble(key, state0, n_burnin, n_keep):
        final_state, draws, infos = common.run_sampler_loop(
            resolve_key(key, algo, prob.device), state0, step, n_burnin,
            n_keep, collect_fn=lambda st: st.position, mesh=mesh,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, thin=thin,
        )
        n_accept = common.tally_accepts(infos)
        draws = common.finalize_draws(draws, prob)
        diagnostics = {"momentum_persistence": alpha}
        if "energy_error" in infos:
            diagnostics["energy_error"] = infos["energy_error"]
        if adapt_step_size:
            diagnostics["adapted_step_size"] = torch.exp(
                final_state.da.log_eps_bar)
        if prob.squeeze:
            draws = draws[:, 0, :]
            n_accept = n_accept[0]
            diagnostics = {
                k: (v[:, 0] if getattr(v, "ndim", 0) == 2 else
                    v[0] if getattr(v, "ndim", 0) == 1 else v)
                for k, v in diagnostics.items()}
        if thin > 1:   # accept_rate divides by n_keep*thin
            diagnostics["thin"] = int(thin)
        return SamplerResult(draws=draws, n_accept_draws=n_accept,
                             diagnostics=diagnostics), final_state

    result, final_state = assemble(gen, state0, s.n_burnin_draws,
                                   s.n_keep_draws)
    if return_resume:
        common.attach_resume(result, assemble, final_state)
    return result
