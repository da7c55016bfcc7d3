"""Ladder-sharded AEES: one ladder position per rank, history passed down
the ladder (PyTorch port of ``mcmc_tpu.parallel.aees_sharded``).

The reference parallelises the temperature ladder with OpenMP threads that
read the next-hotter chain's full history from shared memory (reference
src/aees.cpp:166-247, 196-222). Here ladder position ``k`` lives on rank
``k``:

- after every draw each rank sends its new state and kernel value, ``d + 1``
  numbers, one step down the ladder (k -> k+1), and the receiver appends
  them to its own copy of its hotter chain's history;
- the equi-energy ring construction and jump then read local memory only.

All positions advance together, so chain k sees its hotter chain's history
up to draw t-1 (a one-draw delay; the ring window is ``[begin, t-1]``, where
the one-device sampler's sequential ladder reads ``[begin, t]``). The
reference's OpenMP loop has the same property up to scheduling races
(src/aees.cpp:166-169); here it is deterministic. ``history_capacity=C``
keeps a C-slot reservoir of the window instead of the whole history, as in
:func:`mcmc_tpu_torch.samplers.aees.aees`.

Each rank draws every number of a draw (move choice, walk normals, ring
pick, accept uniform, and the reservoir's uniform and slot) from its own
generator and computes the local move and, once its ring exists, the jump
candidate, selecting between them on the card: no host synchronisation a
draw.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from mcmc_tpu_torch.parallel import mesh as mesh_mod
from mcmc_tpu_torch.results import SamplerResult
from mcmc_tpu_torch.settings import AEESSettings
from mcmc_tpu_torch.samplers import common
from mcmc_tpu_torch.samplers.aees import (_f32, make_ee_jump,
                                          make_mh_step_scaled, make_temps,
                                          safe_initial_kv)
from mcmc_tpu_torch.samplers._resolve import resolve_settings, resolve_key

__all__ = ["aees_sharded"]


def _pass_down(x, group, k, K):
    """Send ``x`` to rank ``k + 1`` and receive rank ``k - 1``'s (the
    hottest rank receives nothing and gets ``x`` back)."""
    dev = mesh_mod._comm_device(x, group)
    src = x.detach().to(dev).contiguous()
    out = torch.empty_like(src) if k > 0 else src
    works = []
    mesh_mod.COUNTS["p2p"] += 1
    if k + 1 < K:
        works.append(dist.isend(src, dist.get_global_rank(group, k + 1),
                                group=group))
    if k > 0:
        works.append(dist.irecv(out, dist.get_global_rank(group, k - 1),
                                group=group))
    for w in works:
        w.wait()
    return out.to(x.device)


def aees_sharded(initial_vals, log_kernel, settings=None, *, mesh, key=None,
                 history_capacity=None, dtype=None, device=None,
                 axis_name: str = mesh_mod.CHAIN_AXIS) -> SamplerResult:
    """Run AEES with ladder position ``k`` on rank ``k`` of ``mesh``
    (``len(temper_vec) + 1 == mesh size``). Every rank returns the T = 1
    chain's kept draws ``(n_keep, n_vals)``, like
    :func:`mcmc_tpu_torch.aees`, with ``n_accept_draws`` the kept draws at
    which it moved and ``diagnostics`` ``temperatures`` and ``transfers``
    (this rank's sends and receives down the ladder)."""
    algo, s = resolve_settings(settings, "aees_settings", AEESSettings)
    ax = mesh_mod.mesh_axis(mesh, axis_name)
    if ax is None:
        raise ValueError(f"mesh has no {axis_name!r} axis")
    prob = common.setup_problem(initial_vals, log_kernel, algo, None, dtype,
                                device)
    dim, dt, box, dev = prob.n_vals, prob.dtype, prob.box_log_kernel, \
        prob.device
    temps = make_temps(s, dt)
    K = int(temps.shape[0])
    if K != ax.size:
        raise ValueError(f"ladder size {K} (user temps + T=1) must equal "
                         f"mesh size {ax.size}")
    k = ax.index
    temps_f = [_f32(t) for t in temps.tolist()]
    my_t, hot_t = temps_f[k], temps_f[max(k - 1, 0)]
    sqrt_t = _f32(np.sqrt(np.float32(temps_f[k])))
    block = int(s.n_initial_draws) + int(s.n_burnin_draws)
    n_keep = int(s.n_keep_draws)
    n_total = n_keep + K * block
    n_rings = int(s.n_rings)
    capped = history_capacity is not None
    H = int(history_capacity) if capped else n_total
    begin = (max(k, 1) - 1) * block
    scale = _f32(s.par_scale)
    mh = make_mh_step_scaled(box, s, dim, dt, dev)
    pick_of = make_ee_jump(n_rings)

    gen = resolve_key(key, algo, dev)
    _seed, rgen = mesh_mod.rank_generator(gen, k)
    kw = {"generator": rgen, "dtype": dt, "device": dev}
    transfers = 0
    with torch.no_grad():
        x = prob.first_draw[:1].clone()                     # (1, d)
        kv = safe_initial_kv(box(x))                         # (1,)
        pair = torch.stack([kv / hot_t, kv / my_t], dim=1)   # (1, 2)
        hot_kv = kv.expand(H).clone()
        hot_x = x.expand(H, dim).clone()
        draws = x.new_empty((n_keep, dim))
        for t in range(n_total):
            sel, pick, u = (torch.rand((1,), **kw) for _ in range(3))
            noise = torch.randn((1, dim), **kw)
            if capped:
                res_u = torch.rand((1,), **kw)
                res_slot = torch.randint(0, H, (1,), generator=rgen,
                                         device=dev)
            if k == 0 or t > k * block:
                x_l, v_l, _ = mh(x, kv, sqrt_t, my_t, scale, noise, u)
                pair_l = torch.stack([v_l, v_l], 1) if k == 0 else \
                    torch.stack([v_l / hot_t, v_l / my_t], 1)
                local = (sel > float(s.ee_prob_par)) if k > 0 else None
                length = t - begin                 # window [begin, t-1]
                avail = min(length, H) if capped else length
                spacing = avail // n_rings if avail > 0 else 0
                if k == 0:
                    x, kv, pair = x_l, v_l, pair_l
                elif spacing > 0:
                    lo = 0 if capped else begin
                    idx = pick_of(hot_kv[None, lo:lo + avail], spacing, kv,
                                  pick) + lo
                    x_ee, v_ee = hot_x[idx], hot_kv[idx]
                    new_pair = torch.stack([v_ee / hot_t, v_ee / my_t], 1)
                    comp = torch.clamp_max((new_pair[:, 1] - pair[:, 1])
                                           + (pair[:, 0] - new_pair[:, 0]),
                                           0.01)
                    acc_e = u < torch.exp(comp)
                    took = ~local & acc_e
                    x = torch.where(took[:, None], x_ee,
                                    torch.where(local[:, None], x_l, x))
                    kv = torch.where(took, v_ee, torch.where(local, v_l, kv))
                    pair = torch.where(local[:, None], pair_l, torch.where(
                        acc_e[:, None], new_pair, pair))
                else:
                    # no ring yet: a jump draw stays
                    x = torch.where(local[:, None], x_l, x)
                    kv = torch.where(local, v_l, kv)
                    pair = torch.where(local[:, None], pair_l, pair)
            # my state down the ladder; my hotter chain's into my history
            got = _pass_down(torch.cat([x[0], kv]), ax.group, k, K)
            transfers += (k + 1 < K) + (k > 0)
            recv_x, recv_kv = got[:dim], got[dim:]
            if not capped:
                hot_kv[t:t + 1] = recv_kv
                hot_x[t] = recv_x
            else:
                # reservoir (algorithm R) over the window [begin, t]
                tw = t - begin + 1
                if 1 <= tw <= H:
                    hot_kv[tw - 1:tw] = recv_kv
                    hot_x[tw - 1] = recv_x
                elif tw > H:
                    repl = res_u * float(tw) < float(H)
                    hot_kv[res_slot] = torch.where(repl, recv_kv,
                                                   hot_kv[res_slot])
                    hot_x[res_slot] = torch.where(repl[:, None], recv_x,
                                                  hot_x[res_slot])
            if t >= K * block:
                draws[t - K * block] = x[0]

        cold = mesh_mod.all_gather(draws[None], ax.group, ax.size)[K - 1]
    draws = common.finalize_draws(cold, prob)
    moved = (draws[1:] != draws[:-1]).any(dim=-1).sum()
    return SamplerResult(
        draws=draws, n_accept_draws=moved,
        diagnostics={"temperatures": temps.to(dev), "transfers": transfers})
