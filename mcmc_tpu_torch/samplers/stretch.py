"""Affine-invariant ensemble sampler, the Goodman & Weare stretch move
(PyTorch port of ``mcmc_tpu.samplers.stretch``).

No reference analog — MCMCLib's gradient-free population machinery is
DE-MCMC (reference src/de.cpp:30-273). The stretch move (Goodman & Weare
2010; the default move of ``emcee``, Foreman-Mackey et al. 2013) is
affine-invariant: its efficiency is unchanged by any linear
reparameterization, so correlated targets need no preconditioner or scale
tuning. One walker moves along the line through itself and a partner drawn
from the complementary half of the ensemble:

    Y = X_j + z (X_i - X_j),     z ~ g(z) ∝ 1/sqrt(z) on [1/a, a],

accepted with probability ``min(1, z^(d-1) exp(logK(Y) - logK(X_i)))``.

A sweep is two batched half-updates (the parallel "red-black" scheme of
Foreman-Mackey et al. 2013, §3): half A proposes against the current half B
in one batch — partner gather, z, one log-kernel call, accepts — then half
B against the updated half A. Each half-update is a valid Metropolis-Hastings
kernel holding the complementary half fixed.

Bounded problems run on the unconstrained space via the box log-kernel
(+ log-Jacobian), with the initial ensemble placed there too.

Output convention matches ``de``: draws ``(n_keep, n_walkers, n_vals)``;
``n_accept_draws`` totals accepted moves over kept sweeps across walkers.

A sweep needs no host synchronisation. It is a draw of its random numbers
from the run's one ``torch.Generator`` (``sweep.draw``: each half's partner
integers, stretch uniforms and accept uniforms) followed by a function of
those draws (``sweep.transition``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mcmc_tpu_torch.parallel import mesh as mesh_mod
from mcmc_tpu_torch.results import SamplerResult
from mcmc_tpu_torch.settings import StretchSettings
from mcmc_tpu_torch.samplers import common
from mcmc_tpu_torch.samplers._resolve import resolve_settings, resolve_key

__all__ = ["stretch", "StretchState", "build_stretch_sweep"]


class StretchState(NamedTuple):
    X: torch.Tensor            # ensemble, (n_walkers, d), unconstrained
    kernel_vals: torch.Tensor  # (n_walkers,)


def _half_update(act_X, act_kv, comp_X, box, par_a, n_vals, j, u_z, u_acc):
    """Stretch-move update of the active half against a fixed
    complementary half, given the partner indices ``j``, the stretch
    uniforms ``u_z`` and the accept uniforms ``u_acc`` (each ``(h,)``);
    returns ``(X_new, kv_new, accepted)``."""
    partner = comp_X[j]
    # z ~ g(z) ∝ 1/sqrt(z) on [1/a, a] by inverse-CDF: ((a-1) u + 1)^2 / a
    z = ((par_a - 1.0) * u_z + 1.0) ** 2 / par_a
    prop = partner + z[:, None] * (act_X - partner)
    prop_vals = box(prop)
    prop_vals = torch.where(torch.isfinite(prop_vals), prop_vals, -torch.inf)
    log_acc = (n_vals - 1) * torch.log(z) + prop_vals - act_kv
    accepted = torch.log(u_acc) < torch.clamp_max(log_acc, 0.0)
    return (common.where_chains(accepted, prop, act_X),
            torch.where(accepted, prop_vals, act_kv), accepted)


def build_stretch_sweep(box_log_kernel, cfg: StretchSettings, n_vals: int):
    """One full ensemble sweep ``sweep(gen, state) -> (state, info)`` (both
    half-updates); ``sweep.draw(gen, state) -> (j_a, u_z_a, u_a, j_b, u_z_b,
    u_b)`` and ``sweep.transition(state, *draws)`` are its two halves, and
    ``sweep.counts`` tallies sweeps and host synchronisations (none)."""
    n_w = int(cfg.n_walkers)
    h = n_w // 2
    par_a = float(np.float32(cfg.par_a))
    counts = {"sweeps": 0, "syncs": 0}

    def draw(gen, state: StretchState):
        X = state.X
        kw = {"generator": gen, "device": X.device}
        out = []
        for _half in range(2):
            out += [torch.randint(0, n_w - h, (h,), **kw),
                    torch.rand((h,), dtype=X.dtype, **kw),
                    torch.rand((h,), dtype=X.dtype, **kw)]
        return tuple(out)

    def transition(state: StretchState, j_a, u_z_a, u_a, j_b, u_z_b, u_b):
        X_a, X_b = state.X[:h], state.X[h:]
        kv_a, kv_b = state.kernel_vals[:h], state.kernel_vals[h:]
        X_a, kv_a, acc_a = _half_update(X_a, kv_a, X_b, box_log_kernel,
                                        par_a, n_vals, j_a.long(), u_z_a, u_a)
        X_b, kv_b, acc_b = _half_update(X_b, kv_b, X_a, box_log_kernel,
                                        par_a, n_vals, j_b.long(), u_z_b, u_b)
        counts["sweeps"] += 1
        return (StretchState(X=torch.cat([X_a, X_b]),
                             kernel_vals=torch.cat([kv_a, kv_b])),
                {"accepted": torch.cat([acc_a, acc_b])})

    def sweep(gen, state: StretchState):
        return transition(state, *draw(gen, state))

    sweep.draw, sweep.transition, sweep.counts = draw, transition, counts
    return sweep


def stretch(initial_vals, log_kernel, settings=None, *, key=None, mesh=None,
            checkpoint_dir=None, checkpoint_every=500, dtype=None, thin=1,
            return_resume=False, device=None) -> SamplerResult:
    """Run the affine-invariant ensemble (stretch-move) sampler.
    ``log_kernel`` is batched over walkers: ``(h, n_vals) -> (h,)``, called
    once per half-update.

    ``initial_vals`` (shape ``(n_vals,)``) centers the initial ensemble:
    walkers start in a Gaussian ball of radius ``init_spread`` around it on
    the *unconstrained* sampling space (the ``emcee`` convention). Returns
    draws of shape ``(n_keep, n_walkers, n_vals)``. ``thin=k`` advances
    ``k`` sweeps per stored draw. ``return_resume=True`` attaches
    ``diagnostics["resume"](key, n_keep)``, a warm continuation from the
    final ensemble. ``key`` is a ``torch.Generator`` or an integer seed;
    ``device`` defaults to that of ``initial_vals``, else the card.
    ``mesh`` shards the walkers over the mesh's ranks
    (:func:`mcmc_tpu_torch.parallel.build_sharded_stretch_sweep`: one
    all-gather per half-update); ``checkpoint_dir`` runs in restartable
    chunks (``mcmc_tpu_torch.checkpoint``)."""
    algo, s = resolve_settings(settings, "stretch_settings", StretchSettings)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")
    common.check_mesh(mesh)

    prob = common.setup_problem(initial_vals, log_kernel, algo, None, dtype,
                                device)
    if not prob.squeeze:
        raise ValueError(
            f"stretch takes a single center point initial_vals of shape "
            f"(n_vals,); got a chain-batched array of shape "
            f"{tuple(np.shape(initial_vals))} — the ensemble size is "
            f"StretchSettings.n_walkers")
    n_vals, dt = prob.n_vals, prob.dtype
    n_w = int(s.n_walkers)
    if n_w < 4 or n_w % 2 != 0:
        raise ValueError(
            f"n_walkers must be an even number >= 4, got {n_w}")
    if not float(s.par_a) > 1.0:
        raise ValueError(f"par_a must be > 1, got {s.par_a}")
    if n_w < 2 * n_vals:
        # affine invariance needs the ensemble to span the space; emcee's
        # standard guidance is >= 2 d walkers
        raise ValueError(
            f"n_walkers={n_w} < 2 * n_vals={2 * n_vals}: the ensemble must "
            f"have at least twice as many walkers as dimensions")
    gen = resolve_key(key, algo, prob.device)

    center = prob.first_draw[0]
    spread = s.init_spread
    spread = torch.as_tensor(
        spread if torch.is_tensor(spread) else np.asarray(spread), dtype=dt,
        device=prob.device).expand(n_vals)
    with torch.no_grad():
        X0 = center + spread * torch.randn((n_w, n_vals), generator=gen,
                                           dtype=dt, device=prob.device)
        kv0 = prob.box_log_kernel(X0)
        kv0 = torch.where(torch.isfinite(kv0), kv0, -torch.inf)
    state0 = StretchState(X=X0, kernel_vals=kv0)

    if mesh_mod.chain_axis_of(mesh) is None:
        sweep = build_stretch_sweep(prob.box_log_kernel, s, n_vals)
    else:
        from mcmc_tpu_torch.parallel.stretch_sharded import \
            build_sharded_stretch_sweep
        sweep = build_sharded_stretch_sweep(prob.box_log_kernel, s, n_vals,
                                            mesh)
    sweep = common.thin_step(sweep, thin)
    if checkpoint_dir is not None:
        _, draws, totals = common.run_checkpointed(
            gen, state0, sweep, s.n_burnin_draws, s.n_keep_draws,
            lambda st: st.X, checkpoint_dir, checkpoint_every, mesh)
        per_walker = torch.as_tensor(totals["accepted"])
        return SamplerResult(
            draws=common.finalize_draws(draws, prob),
            n_accept_draws=per_walker.sum(),
            diagnostics=common.population_accept_diag_totals(
                per_walker, s.n_keep_draws, thin))
    run = common.make_population_runner(sweep, mesh)

    def assemble(key, state0, n_burnin, n_keep):
        final_state, (draws, accepted) = run(
            state0, resolve_key(key, algo, prob.device), n_burnin, n_keep)
        draws = common.finalize_draws(draws, prob)
        return SamplerResult(
            draws=draws, n_accept_draws=accepted.to(torch.int64).sum(),
            diagnostics=common.population_accept_diag(accepted, thin),
        ), final_state

    result, final_state = assemble(gen, state0, s.n_burnin_draws,
                                   s.n_keep_draws)
    if return_resume:
        common.attach_resume(result, assemble, final_state)
    return result
