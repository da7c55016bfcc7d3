"""Walker-sharded stretch-move ensemble sweep (PyTorch port of
``mcmc_tpu.parallel.stretch_sharded``).

Each rank holds a contiguous block of the walkers; half A is rows ``[0,
h)`` and half B rows ``[h, n_walkers)`` of the global ensemble, so a block
may hold rows of either half or both. Each half-update all-gathers the
ensemble once, so every rank draws its active walkers' partners uniformly
over the *whole* complementary half (drawing them from the local block
only would break the move's stationarity argument): two collectives per
sweep, off the per-walker path.
"""

from __future__ import annotations

import numpy as np
import torch

from mcmc_tpu_torch.parallel import mesh as mesh_mod
from mcmc_tpu_torch.samplers.stretch import StretchState, _half_update
from mcmc_tpu_torch.settings import StretchSettings

__all__ = ["build_sharded_stretch_sweep"]


def build_sharded_stretch_sweep(box_log_kernel, cfg: StretchSettings,
                                n_vals: int, mesh,
                                axis_name: str = mesh_mod.CHAIN_AXIS):
    """``sweep(gen, state) -> (state, info)`` over this rank's block of the
    walkers, with ``sweep.draw(gen, state) -> (j, u_z, u)`` (one partner
    integer, stretch uniform and accept uniform per local walker, for the
    half-update in which it moves) and ``sweep.transition(state, j, u_z,
    u)``. Fed the rows of :func:`mcmc_tpu_torch.samplers.stretch.
    build_stretch_sweep`'s draws (``j = cat(j_a, j_b)[rows]`` and so on),
    it equals the unsharded sweep bit for bit."""
    n_w = int(cfg.n_walkers)
    h = n_w // 2
    ax = mesh_mod.mesh_axis(mesh, axis_name)
    if ax is None:
        raise ValueError(f"mesh has no {axis_name!r} axis")
    if n_w % (2 * ax.size) != 0:
        raise ValueError(
            f"n_walkers={n_w} must divide evenly into two halves over "
            f"{ax.size} devices (need n_walkers % {2 * ax.size} == 0)")
    rows = mesh_mod.chain_sharding(mesh, n_w, axis_name)
    L = rows.stop - rows.start
    n_a = min(max(h - rows.start, 0), L)      # local rows of half A first
    par_a = float(np.float32(cfg.par_a))
    counts = {"sweeps": 0, "syncs": 0, "collectives": 0}

    def draw(gen, state: StretchState):
        X = state.X
        kw = {"generator": gen, "device": X.device}
        return (torch.randint(0, n_w - h, (L,), **kw),
                torch.rand((L,), dtype=X.dtype, **kw),
                torch.rand((L,), dtype=X.dtype, **kw))

    def transition(state: StretchState, j, u_z, u):
        X, kv = state.X, state.kernel_vals
        j = j.long()
        acc = []
        for active_a, sl in ((True, slice(0, n_a)), (False, slice(n_a, L))):
            X_full = mesh_mod.all_gather(X, ax.group, ax.size)
            counts["collectives"] += 1
            if sl.stop == sl.start:
                continue
            comp = X_full[h:] if active_a else X_full[:h]
            Xn, kvn, a = _half_update(X[sl], kv[sl], comp, box_log_kernel,
                                      par_a, n_vals, j[sl], u_z[sl], u[sl])
            X = torch.cat([X[:sl.start], Xn, X[sl.stop:]])
            kv = torch.cat([kv[:sl.start], kvn, kv[sl.stop:]])
            acc.append(a)
        counts["sweeps"] += 1
        return (StretchState(X=X, kernel_vals=kv),
                {"accepted": torch.cat(acc)})

    def sweep(gen, state: StretchState):
        return transition(state, *draw(gen, state))

    sweep.draw, sweep.transition, sweep.counts = draw, transition, counts
    sweep.rows = rows
    return sweep
