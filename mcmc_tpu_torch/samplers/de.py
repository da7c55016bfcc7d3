"""Differential-evolution MCMC, a gradient-free population sampler
(PyTorch port of ``mcmc_tpu.samplers.de``).

Reference src/de.cpp:30-273. The population is the batch: every walker's
proposal ``X_i + gamma (X_c1 - X_c2) + U[-b, b]`` (src/de.cpp:163-184) is
formed and evaluated in one batched step per generation. Cross-walker
reads use the *previous generation* snapshot, as in the JAX package (the
reference's in-place row updates give scheduling-dependent mixtures of old
and new rows under OpenMP; the snapshot is their deterministic parallel
limit).

Reference semantics carried over:
- the running gamma is hard-coded to ``2.38 / sqrt(2 d)``; the
  ``par_gamma`` setting is ignored (src/de.cpp:59-60);
- with ``jumps``, every 10th generation uses ``par_gamma_jump``
  (src/de.cpp:151-153, 219-221);
- distinct indices ``c1 != i``, ``c2 not in {i, c1}``, drawn as two batched
  uniform integers with the JAX package's shifted mapping
  (:func:`_distinct_pair_indices`);
- the tempered accept ``delta_logK > T log u`` with the cooling schedule
  identically 1 (reference include/mcmc/de.hpp:84-89);
- the initial population is uniform in the (bounds-clipped) initial box and
  is treated as unconstrained coordinates, exactly as the reference does
  (src/de.cpp:114-139 never transforms);
- acceptance is counted over walkers after burn-in into a single total
  (src/de.cpp:157-204).

A sweep needs no host synchronisation. It is a draw of its random numbers
from the run's one ``torch.Generator`` (``sweep.draw``: the two index
integers of each walker, the box noise and the accept uniforms) followed by
a function of those draws (``sweep.transition``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mcmc_tpu_torch import bounds as bounds_mod
from mcmc_tpu_torch.results import SamplerResult
from mcmc_tpu_torch.parallel import mesh as mesh_mod
from mcmc_tpu_torch.settings import DESettings
from mcmc_tpu_torch.samplers import common
from mcmc_tpu_torch.samplers._resolve import resolve_settings, resolve_key

__all__ = ["de", "DEState", "build_de_sweep", "de_cooling_schedule"]


def de_cooling_schedule(s, n_gen):
    """Identically 1 (reference include/mcmc/de.hpp:84-89, placeholder)."""
    return 1.0


class DEState(NamedTuple):
    X: torch.Tensor            # (n_pop, d) population, unconstrained coords
    kernel_vals: torch.Tensor  # (n_pop,)
    gen_ind: torch.Tensor      # () int32 generation counter (jump cadence)


def _distinct_pair_indices(r1, r2, i=None):
    """Walker ``i``'s partners from its uniform integers ``r1`` on
    ``{0..n_pop-2}`` and ``r2`` on ``{0..n_pop-3}`` (each ``(n_pop,)``):
    ``c1`` uniform on ``{0..n_pop-1} \\ {i}``, ``c2`` on the rest minus
    ``{c1}``, by shifting past the excluded indices. ``i``: the walkers'
    population indices (default ``0..n-1``; a shard passes its rows')."""
    if i is None:
        i = torch.arange(r1.shape[0], device=r1.device)
    c1 = r1 + (r1 >= i)
    a = torch.minimum(i, c1)
    b = torch.maximum(i, c1)
    c2 = r2 + (r2 >= a)
    c2 = c2 + (c2 >= b)
    return c1, c2


def build_de_sweep(box_log_kernel, cfg: DESettings, n_vals: int):
    """One generation ``sweep(gen, state) -> (state, info)`` over the whole
    population; ``sweep.draw(gen, state) -> (r1, r2, noise, u)`` and
    ``sweep.transition(state, r1, r2, noise, u)`` are its two halves, and
    ``sweep.counts`` tallies sweeps and host synchronisations (none)."""
    n_pop = int(cfg.n_pop)
    par_gamma = 2.38 / math.sqrt(2.0 * n_vals)   # reference src/de.cpp:59-60
    counts = {"sweeps": 0, "syncs": 0}

    def draw(gen, state: DEState):
        X = state.X
        kw = {"generator": gen, "device": X.device}
        r1 = torch.randint(0, n_pop - 1, (n_pop,), **kw)
        r2 = torch.randint(0, n_pop - 2, (n_pop,), **kw)
        noise = cfg.par_b * (2.0 * torch.rand(X.shape, dtype=X.dtype, **kw)
                             - 1.0)
        return r1, r2, noise, torch.rand((n_pop,), dtype=X.dtype, **kw)

    def transition(state: DEState, r1, r2, noise, u):
        X = state.X
        c1, c2 = _distinct_pair_indices(r1.long(), r2.long())
        if cfg.jumps:
            use_jump = (state.gen_ind + 1) % 10 == 0
            gamma = torch.where(use_jump, cfg.par_gamma_jump,
                                par_gamma).to(X.dtype)
        else:
            gamma = par_gamma
        X_prop = X + gamma * (X[c1] - X[c2]) + noise
        prop_vals = box_log_kernel(X_prop)
        prop_vals = torch.where(torch.isfinite(prop_vals), prop_vals,
                                -torch.inf)
        counts["sweeps"] += 1

        temperature = de_cooling_schedule(state.gen_ind, cfg.n_keep_draws)
        accepted = (prop_vals - state.kernel_vals) > temperature * torch.log(u)
        new_state = DEState(
            X=common.where_chains(accepted, X_prop, X),
            kernel_vals=torch.where(accepted, prop_vals, state.kernel_vals),
            gen_ind=state.gen_ind + 1)
        return new_state, {"accepted": accepted}

    def sweep(gen, state: DEState):
        return transition(state, *draw(gen, state))

    sweep.draw, sweep.transition, sweep.counts = draw, transition, counts
    return sweep


def de(initial_vals, log_kernel, settings=None, *, key=None, mesh=None,
       checkpoint_dir=None, checkpoint_every=500, dtype=None, thin=1,
       device=None) -> SamplerResult:
    """Run DE-MCMC (module docstring). ``log_kernel`` is batched over the
    population: ``(n_pop, n_vals) -> (n_pop,)``. Returns draws of shape
    ``(n_keep, n_pop, n_vals)``, the reference's ``Cube_t draws_out(n_pop,
    n_vals, n_keep)`` with the generation axis leading.

    ``thin=k`` advances ``k`` generations per stored draw (burn-in and keep
    alike); ``n_accept_draws`` counts accepted moves over all ``n_keep * k``
    kept-phase generations, and the every-10th-generation jump cadence
    counts generations, not rows. ``key`` is a ``torch.Generator`` or an
    integer seed; ``device`` defaults to that of ``initial_vals``, else the
    card. ``mesh`` shards the population over the mesh's ranks
    (:func:`mcmc_tpu_torch.parallel.build_sharded_de_sweep`: one all-gather
    of the population per generation); ``checkpoint_dir`` runs in
    restartable chunks (:mod:`mcmc_tpu_torch.checkpoint`)."""
    algo, s = resolve_settings(settings, "de_settings", DESettings)
    common.check_mesh(mesh)

    prob = common.setup_problem(initial_vals, log_kernel, algo, None, dtype,
                                device)
    x0 = torch.as_tensor(initial_vals, dtype=prob.dtype, device=prob.device)
    n_vals = x0.shape[-1]
    as_t = lambda a: torch.as_tensor(a, dtype=prob.dtype, device=prob.device)
    init_lb = as_t(s.initial_lb) if s.initial_lb is not None else x0 - 0.5
    init_ub = as_t(s.initial_ub) if s.initial_ub is not None else x0 + 0.5
    init_lb, init_ub = bounds_mod.sampling_bounds_check(
        prob.vals_bound, prob.codes, prob.lower_bounds, prob.upper_bounds,
        init_lb, init_ub)

    gen = resolve_key(key, algo, prob.device)
    with torch.no_grad():
        U = torch.rand((s.n_pop, n_vals), generator=gen, dtype=prob.dtype,
                       device=prob.device)
        X0 = init_lb + (init_ub - init_lb) * U
        kv0 = prob.box_log_kernel(X0)
        kv0 = torch.where(torch.isfinite(kv0), kv0, -torch.inf)
    state0 = DEState(X=X0, kernel_vals=kv0,
                     gen_ind=torch.zeros((), dtype=torch.int32,
                                         device=prob.device))

    if mesh_mod.chain_axis_of(mesh) is None:
        sweep = build_de_sweep(prob.box_log_kernel, s, n_vals)
    else:
        from mcmc_tpu_torch.parallel.de_sharded import build_sharded_de_sweep
        sweep = build_sharded_de_sweep(prob.box_log_kernel, s, n_vals, mesh)
    sweep = common.thin_step(sweep, thin)
    if checkpoint_dir is not None:
        # restartable chunked execution: the same sweeps on the same
        # generator as the in-memory path below, bit for bit
        _, draws, totals = common.run_checkpointed(
            gen, state0, sweep, s.n_burnin_draws, s.n_keep_draws,
            lambda st: st.X, checkpoint_dir, checkpoint_every, mesh)
        per_walker = torch.as_tensor(totals["accepted"])
        return SamplerResult(
            draws=common.finalize_draws(draws, prob),
            n_accept_draws=per_walker.sum(),
            diagnostics=common.population_accept_diag_totals(
                per_walker, s.n_keep_draws, thin))
    _, (draws, accepted) = common.make_population_runner(sweep, mesh)(
        state0, gen, s.n_burnin_draws, s.n_keep_draws)
    n_accept = accepted.to(torch.int64).sum()
    draws = common.finalize_draws(draws, prob)
    return SamplerResult(
        draws=draws, n_accept_draws=n_accept,
        diagnostics=common.population_accept_diag(accepted, thin))
