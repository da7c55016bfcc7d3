"""Hamiltonian Monte Carlo (PyTorch port of ``mcmc_tpu.samplers.hmc``).

Reference src/hmc.cpp:30-254: fixed ``n_leap_steps`` leapfrog trajectories
with a constant preconditioner M, momentum refreshed as ``chol(M) @ xi``
each draw, and MH acceptance ``log u < min(0.01, -(U* + K*) + (U + K))``
(src/hmc.cpp:188) — the reference's 0.01 clamp (not 0) is preserved.
Non-finite proposal potentials are forced to +inf so they are always
rejected (src/hmc.cpp:180-182).

The kernel is batched over chains: every tensor of :class:`HMCState` has the
chain batch on its leading axis, and one ``torch.Generator`` supplies each
transition's momenta and uniforms for all chains at once.

Extensions (no reference analog): dual-averaging step-size adaptation
(``adapt_step_size=True``) and windowed diag/dense mass-matrix adaptation
(``adapt_mass_matrix=True``, sharing NUTS's Stan-style warmup schedule).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mcmc_tpu_torch import adaptation
from mcmc_tpu_torch import integrators
from mcmc_tpu_torch.results import SamplerResult
from mcmc_tpu_torch.settings import HMCSettings
from mcmc_tpu_torch.samplers import common
from mcmc_tpu_torch.samplers._resolve import resolve_settings, resolve_key

__all__ = ["hmc", "HMCState", "build_hmc_kernel"]


class HMCState(NamedTuple):
    position: torch.Tensor     # (c, d) unconstrained coordinates
    potential: torch.Tensor    # (c,) U = -box_log_kernel(position)
    da: adaptation.DualAveraging
    draw_ind: torch.Tensor     # (c,) int32
    inv_mass: torch.Tensor     # inverse mass: (c, d) diag or (c, d, d) dense
    mass_chol: torch.Tensor    # chol of inv_mass (dense mode; (c, 1) otherwise)
    w_count: torch.Tensor      # Welford window accumulators
    w_mean: torch.Tensor
    w_m2: torch.Tensor         # (c, d) diagonal or (c, d, d) outer-product


def build_hmc_kernel(box_log_kernel, grad_fn, precond: common.SPD,
                     step_size, n_leap_steps, adapt_cfg=None,
                     mass_cfg=None):
    """``adapt_cfg``: dual-averaging step-size tuning (n_burnin, target).
    ``mass_cfg``: windowed mass adaptation — dict with ``n_burnin``, the
    collect/window-end masks from
    :func:`mcmc_tpu_torch.adaptation.window_schedule`, and ``mode`` ("diag"
    or "dense"). With mass adaptation on, the preconditioner must be
    identity (the mass is learned). Returns batched ``init(positions)`` and
    ``step(gen, state) -> (state, info)``, whose two halves are
    ``step.draw(gen, state) -> (noise, u)`` (the momentum's normals and the
    accept uniform) and ``step.transition(state, noise, u)``."""
    adapt_mass = mass_cfg is not None
    mass_mode = mass_cfg.get("mode", "diag") if adapt_mass else None

    def kinetic(r, inv_mass):
        if mass_mode == "diag":
            return 0.5 * (r * r * inv_mass).sum(dim=-1)
        if mass_mode == "dense":
            return 0.5 * (r * (inv_mass @ r[:, :, None])[:, :, 0]).sum(dim=-1)
        return integrators.kinetic_energy(r, precond.inv_mv)

    def init(position):
        c, dim = position.shape
        kw = {"dtype": position.dtype, "device": position.device}
        if mass_mode == "dense":
            inv_mass0 = torch.eye(dim, **kw).expand(c, dim, dim).clone()
            chol0 = inv_mass0.clone()
            w_m2_0 = torch.zeros((c, dim, dim), **kw)
        else:
            inv_mass0 = torch.ones((c, dim), **kw)
            chol0 = torch.ones((c, 1), **kw)
            w_m2_0 = torch.zeros((c, dim), **kw)
        izeros = torch.zeros((c,), dtype=torch.int32, device=position.device)
        with torch.no_grad():
            potential = -box_log_kernel(position)
        return HMCState(
            position=position,
            potential=potential,
            da=adaptation.da_init(torch.full((c,), float(step_size), **kw)),
            draw_ind=izeros,
            inv_mass=inv_mass0,
            mass_chol=chol0,
            w_count=izeros,
            w_mean=torch.zeros((c, dim), **kw),
            w_m2=w_m2_0,
        )

    def draw(gen, state: HMCState):
        pos = state.position
        kw = {"generator": gen, "dtype": pos.dtype, "device": pos.device}
        return torch.randn(pos.shape, **kw), torch.rand(pos.shape[:1], **kw)

    def transition(state: HMCState, noise, u):
        pos = state.position
        if adapt_cfg is None:
            eps = step_size
            adapting_eps = None
        else:
            adapting_eps = state.draw_ind < adapt_cfg["n_burnin"]
            eps = torch.exp(torch.where(adapting_eps, state.da.log_eps,
                                        state.da.log_eps_bar))

        inv_mass = state.inv_mass
        if mass_mode == "diag":
            momentum = noise * torch.rsqrt(inv_mass)
            inv_mv = lambda v: inv_mass * v
        elif mass_mode == "dense":
            # inv_mass = Sigma = L L^T; p = L^{-T} xi ~ N(0, Sigma^{-1})
            momentum = torch.linalg.solve_triangular(
                state.mass_chol.transpose(1, 2), noise[:, :, None],
                upper=True)[:, :, 0]
            inv_mv = lambda v: (inv_mass @ v[:, :, None])[:, :, 0]
        else:
            momentum = precond.sqrt_mv(noise)
            inv_mv = precond.inv_mv
        prev_K = kinetic(momentum, inv_mass)

        new_pos, new_mom = integrators.leapfrog(
            grad_fn, inv_mv, eps, n_leap_steps, pos, momentum)

        prop_U = -box_log_kernel(new_pos)
        prop_U = torch.where(torch.isfinite(prop_U), prop_U, torch.inf)
        prop_K = kinetic(new_mom, inv_mass)

        comp = torch.clamp_max(
            -(prop_U + prop_K) + (state.potential + prev_K), 0.01)
        accepted = u < torch.exp(comp)

        position = common.where_chains(accepted, new_pos, pos)

        da = state.da
        if adapt_cfg is not None:
            accept_stat = torch.clamp_max(torch.exp(comp), 1.0)
            accept_stat = torch.where(torch.isnan(accept_stat), 0.0,
                                      accept_stat)
            da_new = adaptation.da_update(da, accept_stat, adapt_cfg["target"])
            da = adaptation.DualAveraging(*[
                torch.where(adapting_eps, new, old)
                for new, old in zip(da_new, da)])

        inv_mass_out = state.inv_mass
        chol_out = state.mass_chol
        wc, wm, wv = state.w_count, state.w_mean, state.w_m2
        if adapt_mass:
            n_sched = mass_cfg["collect"].shape[0]
            idx = torch.clamp_max(state.draw_ind, n_sched - 1).long()
            in_warmup = state.draw_ind < mass_cfg["n_burnin"]
            collecting = in_warmup & mass_cfg["collect"][idx]
            window_end = in_warmup & mass_cfg["window_end"][idx]

            wc, wm, wv, inv_mass_out, chol_out = \
                adaptation.windowed_mass_update(
                    wc, wm, wv, inv_mass_out, chol_out, position,
                    collecting, window_end, mass_mode)
            if adapt_cfg is not None:
                # restart dual averaging around the current step at the new
                # metric (Stan-style)
                eps_now = torch.exp(da.log_eps)
                da = adaptation.DualAveraging(
                    log_eps=da.log_eps,
                    log_eps_bar=torch.where(window_end, da.log_eps,
                                            da.log_eps_bar),
                    h=torch.where(window_end, 0.0, da.h),
                    t=torch.where(window_end, 0.0, da.t),
                    mu=torch.where(window_end, torch.log(10.0 * eps_now),
                                   da.mu),
                )

        new_state = HMCState(
            position=position,
            potential=torch.where(accepted, prop_U, state.potential),
            da=da,
            draw_ind=state.draw_ind + 1,
            inv_mass=inv_mass_out,
            mass_chol=chol_out,
            w_count=wc, w_mean=wm, w_m2=wv,
        )
        info = {"accepted": accepted,
                "energy_error": -(prop_U + prop_K) + (state.potential + prev_K)}
        return new_state, info

    def step(gen, state: HMCState):
        return transition(state, *draw(gen, state))

    step.draw, step.transition = draw, transition
    return init, step


def hmc(initial_vals, log_kernel, settings=None, *, n_chains=None, key=None,
        mesh=None, checkpoint_dir=None, checkpoint_every=500, dtype=None,
        bounded_grad="reference", adapt_step_size=False, target_accept=None,
        adapt_mass_matrix=False, thin=1, return_resume=False,
        device=None) -> SamplerResult:
    """Run HMC. See reference src/hmc.cpp and mcmc_structs.hpp:66-78 for the
    settings fields.

    ``log_kernel`` is batched: ``(n_chains, n_vals) -> (n_chains,)``.
    ``key`` is a ``torch.Generator`` or an integer seed (``None``: the
    settings' ``rng_seed_value``); ``device`` defaults to that of
    ``initial_vals``. ``bounded_grad`` selects the constrained-space
    gradient convention (see :mod:`mcmc_tpu_torch.integrators`).
    ``adapt_step_size=True`` tunes the step size by dual averaging toward
    0.8 acceptance during burn-in; ``adapt_mass_matrix=True`` (or ``"diag"``
    / ``"dense"``) adds windowed mass-matrix adaptation.
    ``return_resume=True`` attaches ``diagnostics["resume"](key, n_keep)``,
    a warm continuation from the final kernel state. ``mesh`` shards the chains
    over its ranks (:mod:`mcmc_tpu_torch.parallel`); ``checkpoint_dir`` runs in
    restartable chunks (:mod:`mcmc_tpu_torch.checkpoint`)."""
    algo, s = resolve_settings(settings, "hmc_settings", HMCSettings)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")

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
            "target": target_accept or adaptation.TARGET_ACCEPT["hmc"],
        }
    mass_cfg = None
    if adapt_mass_matrix:
        if s.precond_mat is not None:
            raise ValueError("adapt_mass_matrix is incompatible with a user "
                             "precond_mat — the mass matrix is learned")
        mode = {True: "diag"}.get(adapt_mass_matrix, adapt_mass_matrix)
        if mode not in ("diag", "dense"):
            raise ValueError(f"adapt_mass_matrix must be False/True/'diag'/"
                             f"'dense', got {adapt_mass_matrix!r}")
        collect, window_end = adaptation.window_schedule(s.n_burnin_draws,
                                                         prob.device)
        mass_cfg = {"n_burnin": s.n_burnin_draws, "collect": collect,
                    "window_end": window_end, "mode": mode}
    init, step = build_hmc_kernel(
        prob.box_log_kernel, grad_fn, precond, s.step_size, s.n_leap_steps,
        adapt_cfg, mass_cfg,
    )
    state0 = init(prob.first_draw)

    def assemble(key, state0, n_burnin, n_keep):
        final_state, draws, infos = common.run_sampler_loop(
            resolve_key(key, algo, prob.device), state0, step, n_burnin,
            n_keep, collect_fn=lambda st: st.position, mesh=mesh,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            thin=thin,
        )

        n_accept = common.tally_accepts(infos)
        draws = common.finalize_draws(draws, prob)
        diagnostics = {}
        if "energy_error" in infos:
            diagnostics["energy_error"] = infos["energy_error"]
        if adapt_step_size:
            diagnostics["adapted_step_size"] = torch.exp(
                final_state.da.log_eps_bar)
        if adapt_mass_matrix:
            diagnostics["inv_mass_diag"] = final_state.inv_mass
        if prob.squeeze:
            draws = draws[:, 0, :]
            n_accept = n_accept[0]
            def _squeeze(k, v):
                if k == "inv_mass_diag":
                    return v[0]
                return v[:, 0] if v.ndim == 2 else v[0]
            diagnostics = {k: _squeeze(k, v) for k, v in diagnostics.items()}
        if thin > 1:   # accept_rate divides by n_keep*thin
            diagnostics["thin"] = int(thin)
        return SamplerResult(draws=draws, n_accept_draws=n_accept,
                             diagnostics=diagnostics), final_state

    result, final_state = assemble(gen, state0, s.n_burnin_draws,
                                   s.n_keep_draws)
    if return_resume:
        common.attach_resume(result, assemble, final_state)
    return result
