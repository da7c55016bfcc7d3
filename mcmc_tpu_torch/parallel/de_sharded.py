"""Population-sharded DE-MCMC sweep (PyTorch port of
``mcmc_tpu.parallel.de_sharded``).

The reference parallelises DE with an OpenMP ``parallel for`` over the
population (reference src/de.cpp:161-207); every walker reads the shared
previous-generation matrix. Here each rank holds a contiguous block of the
population and, once per generation, all-gathers the previous generation
so it can form its walkers' ``X_i + gamma (X_c1 - X_c2) + U[-b, b]``
proposals against the whole population: one collective per generation.
"""

from __future__ import annotations

import math

import torch

from mcmc_tpu_torch.parallel import mesh as mesh_mod
from mcmc_tpu_torch.samplers import common
from mcmc_tpu_torch.samplers.de import (DEState, _distinct_pair_indices,
                                        de_cooling_schedule)
from mcmc_tpu_torch.settings import DESettings

__all__ = ["build_sharded_de_sweep"]


def build_sharded_de_sweep(box_log_kernel, cfg: DESettings, n_vals: int,
                           mesh, axis_name: str = mesh_mod.CHAIN_AXIS):
    """``sweep(gen, state) -> (state, info)`` over this rank's block of the
    population (``state.X`` ``(n_pop / R, d)``, ``state.kernel_vals``;
    ``gen_ind`` replicated), with :func:`mcmc_tpu_torch.samplers.de.
    build_de_sweep`'s ``sweep.draw(gen, state) -> (r1, r2, noise, u)`` (the
    block's rows of the unsharded draws) and ``sweep.transition(state, r1,
    r2, noise, u)`` halves, so the sharded sweep fed the unsharded sweep's
    draws row for row equals it bit for bit."""
    n_pop = int(cfg.n_pop)
    ax = mesh_mod.mesh_axis(mesh, axis_name)
    if ax is None:
        raise ValueError(f"mesh has no {axis_name!r} axis")
    if n_pop % ax.size != 0:
        raise ValueError(f"n_pop={n_pop} must divide evenly over "
                         f"{ax.size} devices")
    rows = mesh_mod.chain_sharding(mesh, n_pop, axis_name)
    par_gamma = 2.38 / math.sqrt(2.0 * n_vals)   # reference src/de.cpp:59-60
    counts = {"sweeps": 0, "syncs": 0, "collectives": 0}

    def draw(gen, state: DEState):
        X = state.X
        m = X.shape[0]
        kw = {"generator": gen, "device": X.device}
        r1 = torch.randint(0, n_pop - 1, (m,), **kw)
        r2 = torch.randint(0, n_pop - 2, (m,), **kw)
        noise = cfg.par_b * (2.0 * torch.rand(X.shape, dtype=X.dtype, **kw)
                             - 1.0)
        return r1, r2, noise, torch.rand((m,), dtype=X.dtype, **kw)

    def transition(state: DEState, r1, r2, noise, u):
        X = state.X
        X_full = mesh_mod.all_gather(X, ax.group, ax.size)   # (n_pop, d)
        counts["collectives"] += 1
        ids = torch.arange(rows.start, rows.stop, device=X.device)
        c1, c2 = _distinct_pair_indices(r1.long(), r2.long(), ids)
        if cfg.jumps:
            use_jump = (state.gen_ind + 1) % 10 == 0
            gamma = torch.where(use_jump, cfg.par_gamma_jump,
                                par_gamma).to(X.dtype)
        else:
            gamma = par_gamma
        X_prop = X + gamma * (X_full[c1] - X_full[c2]) + noise
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
    sweep.rows = rows
    return sweep
