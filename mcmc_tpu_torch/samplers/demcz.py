"""DE-MC(Z): differential evolution MCMC with an archive and snooker moves
(PyTorch port of ``mcmc_tpu.samplers.demcz``).

No reference analog — MCMCLib's DE-MCMC (reference src/de.cpp:30-273,
ported in samplers/de.py) needs a population at least comparable to the
dimension, because proposals are differences of *current* walkers. DE-MC(Z)
(ter Braak & Vrugt 2008, Stat Comput 18:435-446) draws difference vectors
from an **archive Z of past states**, so a handful of walkers (``n_pop`` as
small as 4) sample high-dimensional targets. Two moves per walker per
generation:

- **parallel direction** (prob ``1 - snooker_prob``):
  ``x* = x_i + gamma (Z_r1 - Z_r2) + U[-b, b]^d`` with
  ``gamma = 2.38 / sqrt(2 d)`` (and, every 10th generation when ``jumps``,
  ``par_gamma_jump``, as in samplers/de.py);
- **snooker** (prob ``snooker_prob``): along the line through ``x_i`` and an
  archive anchor ``z``: with ``e = x_i - z`` and ``gamma_s ~ U(1.2, 2.2)``,
  ``x* = x_i + gamma_s ((Z_r1 - Z_r2) . e / |e|^2) e``, accepted with the
  extra Jacobian factor ``(|x* - z| / |x_i - z|)^(d-1)`` (ter Braak & Vrugt
  2008, eq. 4).

The archive is appended every ``archive_stride`` generations and never read
in the generation that writes it, so every generation is a valid MH update.

Each walker's proposal depends only on its own state and the shared
archive, so the population is one batch; both candidate moves are formed
for every walker and selected by mask before the one batched log-kernel
call. ``n_runs`` independent replicas, each with its own archive, are one
more batch axis: every tensor is ``(n_runs, ...)``. The archive is a
fixed-capacity buffer (by default sized to hold every append of the run;
an explicit ``archive_size`` makes it a ring overwriting the oldest
entries), written in place.

The archive's fill count and the generation counter depend only on the
number of generations (the append is strided), so both are host integers:
every index draw's bound (``_distinct_triple``'s ``filled``), the jump
cadence and the append are host values, and a generation needs no host
synchronisation. It is a draw of its random numbers from the run's one
``torch.Generator`` (``sweep.draw``: the three archive indices of each
walker, the box noise, the snooker scale, the move choice and the accept
uniform) followed by a function of those draws (``sweep.transition``).

Output convention matches ``de``: draws ``(n_keep, n_pop, n_vals)``, or
``(n_keep, n_runs * n_pop, n_vals)`` with ``n_runs``; ``n_accept_draws``
totals accepted moves over kept generations.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from mcmc_tpu_torch import bounds as bounds_mod
from mcmc_tpu_torch.results import SamplerResult
from mcmc_tpu_torch.settings import DEMCZSettings
from mcmc_tpu_torch.samplers import common
from mcmc_tpu_torch.samplers._resolve import resolve_settings, resolve_key

__all__ = ["demcz", "DEMCZState", "build_demcz_sweep"]


class DEMCZState(NamedTuple):
    X: torch.Tensor            # (R, n_pop, d) populations, unconstrained
    kernel_vals: torch.Tensor  # (R, n_pop)
    Z: torch.Tensor            # (R, capacity, d) archive buffers
    m_total: int               # states ever appended to each archive
    gen_ind: int               # generation counter (jump cadence + stride)


def _distinct_triple(r1, r2, r3):
    """Three mutually distinct indices uniform on ``[0, filled)`` from
    uniform integers ``r1`` on ``[0, filled)``, ``r2`` on ``[0, filled-1)``
    and ``r3`` on ``[0, filled-2)``, by shifting past the indices already
    taken (the JAX package's mapping)."""
    r2 = r2 + (r2 >= r1)
    a = torch.minimum(r1, r2)
    b = torch.maximum(r1, r2)
    r3 = r3 + (r3 >= a)
    r3 = r3 + (r3 >= b)
    return r1, r2, r3


def build_demcz_sweep(box_log_kernel, cfg: DEMCZSettings, n_vals: int,
                      capacity: int):
    """One generation ``sweep(gen, state) -> (state, info)``: batched
    proposal and accept for every walker of every run, then the (strided)
    archive append, in place. ``sweep.draw(gen, state) -> (r1, r2, rz,
    noise, g_s, choice, u)`` and ``sweep.transition(state, *draws)`` are its
    two halves, and ``sweep.counts`` tallies sweeps and host
    synchronisations (none)."""
    n_pop = int(cfg.n_pop)
    gamma_par = 2.38 / math.sqrt(2.0 * n_vals)
    gamma_jump = float(cfg.par_gamma_jump)
    counts = {"sweeps": 0, "syncs": 0}

    def draw(gen, state: DEMCZState):
        X = state.X
        R = X.shape[0]
        filled = min(int(state.m_total), capacity)
        kw = {"generator": gen, "device": X.device}
        fk = dict(kw, dtype=X.dtype)
        r1 = torch.randint(0, filled, (R, n_pop), **kw)
        r2 = torch.randint(0, filled - 1, (R, n_pop), **kw)
        r3 = torch.randint(0, filled - 2, (R, n_pop), **kw)
        b = float(cfg.par_b)
        noise = -b + 2.0 * b * torch.rand(X.shape, **fk)
        g_s = 1.2 + torch.rand((R, n_pop), **fk)
        return (r1, r2, r3, noise, g_s, torch.rand((R, n_pop), **fk),
                torch.rand((R, n_pop), **fk))

    def transition(state: DEMCZState, r1, r2, rz, noise, g_s, choice, u):
        X, Z = state.X, state.Z
        R = X.shape[0]
        dtype = X.dtype
        tiny = torch.finfo(dtype).tiny
        gen_ind, m_total = int(state.gen_ind), int(state.m_total)
        r1, r2, rz = _distinct_triple(r1.long(), r2.long(), rz.long())
        rows = torch.arange(R, device=X.device)[:, None]

        use_jump = bool(cfg.jumps) and (gen_ind + 1) % 10 == 0
        g_par = float(np.float32(gamma_jump if use_jump else gamma_par))
        d1 = Z[rows, r1] - Z[rows, r2]                      # (R, n_pop, d)

        # parallel-direction candidate
        prop_par = X + g_par * d1 + noise

        # snooker candidate along e = x - z, gamma_s ~ U(1.2, 2.2)
        z = Z[rows, rz]
        e = X - z
        ee = (e * e).sum(-1)
        ee_safe = torch.clamp_min(ee, tiny)     # z == x_i -> proposal = x_i
        coef = g_s * (d1 * e).sum(-1) / ee_safe
        prop_snk = X + coef[..., None] * e
        ee_new = torch.clamp_min(((prop_snk - z) ** 2).sum(-1), tiny)
        log_jac_snk = 0.5 * (n_vals - 1) * (torch.log(ee_new)
                                            - torch.log(ee_safe))

        snooker = choice < cfg.snooker_prob
        prop = torch.where(snooker[..., None], prop_snk, prop_par)
        log_jac = torch.where(snooker, log_jac_snk, 0.0)

        prop_vals = box_log_kernel(prop.reshape(R * n_pop, n_vals)).reshape(
            R, n_pop)
        prop_vals = torch.where(torch.isfinite(prop_vals), prop_vals,
                                -torch.inf)

        log_acc = prop_vals - state.kernel_vals + log_jac
        accepted = torch.log(u) < torch.clamp_max(log_acc, 0.0)
        # a snooker whose anchor z equals x_i degenerates to the identity
        # proposal (always MH-accepted); count it as a rejection so
        # acceptance statistics report actual movement
        accepted = accepted & ~(snooker & (ee <= tiny))

        X_new = torch.where(accepted[..., None], prop, X)
        kv_new = torch.where(accepted, prop_vals, state.kernel_vals)

        # strided archive append at ring positions, in place; this
        # generation only read the buffer before the append
        if (gen_ind + 1) % int(cfg.archive_stride) == 0:
            start = m_total % capacity
            if start + n_pop <= capacity:
                Z[:, start:start + n_pop] = X_new
            else:
                at = torch.arange(m_total, m_total + n_pop,
                                  device=X.device) % capacity
                Z[:, at] = X_new
            m_total += n_pop
        counts["sweeps"] += 1
        new_state = DEMCZState(X=X_new, kernel_vals=kv_new, Z=Z,
                               m_total=m_total, gen_ind=gen_ind + 1)
        return new_state, {"accepted": accepted}

    def sweep(gen, state: DEMCZState):
        return transition(state, *draw(gen, state))

    sweep.draw, sweep.transition, sweep.counts = draw, transition, counts
    return sweep


def demcz(initial_vals, log_kernel, settings=None, *, key=None, n_runs=None,
          mesh=None, checkpoint_dir=None, checkpoint_every=500, dtype=None,
          thin=1, return_resume=False, device=None) -> SamplerResult:
    """Run DE-MC(Z) — archive-based differential evolution with snooker
    moves (ter Braak & Vrugt 2008). ``log_kernel`` is batched over walkers:
    ``(n_runs * n_pop, n_vals) -> (n_runs * n_pop,)``.

    ``initial_vals`` (shape ``(n_vals,)``) centers the initial box
    (``initial_lb``/``initial_ub`` default to ``initial_vals ± 0.5``); the
    initial archive is ``n_initial_archive`` uniform draws from that box
    (default ``max(n_pop, 10 * n_vals)``), and the population starts as the
    archive's last ``n_pop`` rows. For bounded problems the box is sampled
    in constrained space and transformed.

    Returns draws of shape ``(n_keep, n_pop, n_vals)``. ``n_runs`` runs that
    many replicas, each with its own initial archive, as one batch (draws
    ``(n_keep, n_runs * n_pop, n_vals)``, run-major: walkers of different
    runs share no archive, so cross-run R-hat is honest). ``thin=k``
    advances ``k`` generations per stored draw (the jump cadence and
    archive stride count generations). ``return_resume=True`` attaches
    ``diagnostics["resume"](key, n_keep)``, a warm continuation carrying the
    archive (the default capacity is sized for this run, so a continuation
    that appends past it overwrites the oldest entries). ``key`` is a
    ``torch.Generator`` or an integer seed; ``device`` defaults to that of
    ``initial_vals``, else the card. ``mesh`` is not ported yet and raises;
    ``checkpoint_dir`` runs in restartable chunks
    (:mod:`mcmc_tpu_torch.checkpoint`)."""
    algo, s = resolve_settings(settings, "demcz_settings", DEMCZSettings)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")
    if mesh is not None and n_runs is None:
        raise ValueError(
            "mesh shards the replica axis — pass n_runs (the population "
            "itself is deliberately tiny and is not sharded)")
    common._no_mesh(mesh)
    if n_runs is not None and int(n_runs) < 1:
        raise ValueError(f"n_runs must be >= 1, got {n_runs}")

    prob = common.setup_problem(initial_vals, log_kernel, algo, None, dtype,
                                device)
    if not prob.squeeze:
        raise ValueError(
            f"demcz takes a single center point initial_vals of shape "
            f"(n_vals,); got a chain-batched array of shape "
            f"{tuple(np.shape(initial_vals))} — the population size is "
            f"DEMCZSettings.n_pop")
    n_vals, dt = prob.n_vals, prob.dtype
    n_pop = int(s.n_pop)
    if n_pop < 4:
        raise ValueError(f"n_pop must be >= 4, got {n_pop}")
    if not 0.0 <= float(s.snooker_prob) <= 1.0:
        raise ValueError(f"snooker_prob must be in [0, 1], "
                         f"got {s.snooker_prob}")
    if int(s.archive_stride) < 1:
        raise ValueError(f"archive_stride must be >= 1, "
                         f"got {s.archive_stride}")

    n_init = int(s.n_initial_archive) if s.n_initial_archive is not None \
        else max(n_pop, 10 * n_vals)
    if n_init < max(n_pop, 4):
        raise ValueError(
            f"n_initial_archive must be >= max(n_pop, 4), got {n_init}")
    # total GENERATIONS this run executes (thin advances thin generations
    # per stored draw — the archive stride counts generations)
    n_gens = (int(s.n_burnin_draws) + int(s.n_keep_draws)) * int(thin)
    if s.archive_size is not None:
        capacity = int(s.archive_size)
        if capacity < n_init:
            raise ValueError(
                f"archive_size={capacity} < n_initial_archive={n_init}")
    else:
        capacity = n_init + n_pop * (n_gens // int(s.archive_stride))
    R = 1 if n_runs is None else int(n_runs)

    as_t = lambda a: torch.as_tensor(
        a if torch.is_tensor(a) else np.asarray(a), dtype=dt,
        device=prob.device)
    x0_c = as_t(initial_vals)            # constrained center for the box
    init_lb = as_t(s.initial_lb) if s.initial_lb is not None else x0_c - 0.5
    init_ub = as_t(s.initial_ub) if s.initial_ub is not None else x0_c + 0.5
    init_lb, init_ub = bounds_mod.sampling_bounds_check(
        prob.vals_bound, prob.codes, prob.lower_bounds, prob.upper_bounds,
        init_lb, init_ub)
    gen = resolve_key(key, algo, prob.device)

    with torch.no_grad():
        U = torch.rand((R, n_init, n_vals), generator=gen, dtype=dt,
                       device=prob.device)
        Z_init = init_lb + (init_ub - init_lb) * U
        if prob.vals_bound:
            Z_init = bounds_mod.transform(Z_init, prob.codes,
                                          prob.lower_bounds,
                                          prob.upper_bounds)
        Z0 = torch.zeros((R, capacity, n_vals), dtype=dt, device=prob.device)
        Z0[:, :n_init] = Z_init
        X0 = Z_init[:, -n_pop:].clone()
        kv0 = prob.box_log_kernel(X0.reshape(R * n_pop, n_vals)).reshape(
            R, n_pop)
        kv0 = torch.where(torch.isfinite(kv0), kv0, -torch.inf)
    state0 = DEMCZState(X=X0, kernel_vals=kv0, Z=Z0, m_total=n_init,
                        gen_ind=0)

    sweep = common.thin_step(build_demcz_sweep(prob.box_log_kernel, s,
                                               n_vals, capacity), thin)
    if checkpoint_dir is not None:
        _, draws, totals = common.run_checkpointed(
            gen, state0, sweep, s.n_burnin_draws, s.n_keep_draws,
            lambda st: st.X, checkpoint_dir, checkpoint_every)
        # (n_keep, R, n_pop, .) -> (n_keep, R * n_pop, .)
        draws = draws.reshape(draws.shape[0], R * n_pop, n_vals)
        per_walker = torch.as_tensor(totals["accepted"]).reshape(R * n_pop)
        return SamplerResult(
            draws=common.finalize_draws(draws, prob),
            n_accept_draws=per_walker.sum(),
            diagnostics=common.population_accept_diag_totals(
                per_walker, s.n_keep_draws, thin))
    run = common.make_population_runner(sweep)

    def assemble(key, state0, n_burnin, n_keep):
        final_state, (draws, accepted) = run(
            state0, resolve_key(key, algo, prob.device), n_burnin, n_keep)
        # (n_keep, R, n_pop, .) -> (n_keep, R * n_pop, .): walkers of
        # different runs are fully independent chains
        draws = draws.reshape(n_keep, R * n_pop, n_vals)
        accepted = accepted.reshape(n_keep, R * n_pop)
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
