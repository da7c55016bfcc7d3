"""Ladder-sharded parallel tempering: one rung per rank, swaps between
neighbours (PyTorch port of ``mcmc_tpu.parallel.pt_sharded``).

The library sampler (:func:`mcmc_tpu_torch.samplers.pt.pt`) runs the whole
ladder as a batch on one device. This variant puts rung ``k`` on rank ``k``
of the mesh, for problems where one replica's inner move fills a device:

- the inner tempered move is local to the rank, on its own generator;
- on a swap round each rank of an active pair sends its state and kernel
  value, ``d + 1`` numbers, to its neighbour and receives the neighbour's;
- the decision is symmetric: both ends read the same uniform from a stream
  every rank draws identically (``K - 1`` uniforms a round, one per pair),
  compute the same Metropolis ratio from the exchanged kernel values and so
  agree without further communication.

The ladder is fixed (adapt it with :func:`~mcmc_tpu_torch.samplers.pt.pt`
and ``adapt_temps=True`` first and pass it as ``temper_vec``). Swap and
accept semantics are :func:`~mcmc_tpu_torch.samplers.pt.pt`'s; only the
random streams differ, so agreement with it is distributional.
"""

from __future__ import annotations

import torch

from mcmc_tpu_torch.parallel import mesh as mesh_mod
from mcmc_tpu_torch.results import SamplerResult
from mcmc_tpu_torch.settings import PTSettings
from mcmc_tpu_torch.samplers import common
from mcmc_tpu_torch.samplers.pt import make_ladder, make_inner_move
from mcmc_tpu_torch.samplers._resolve import resolve_settings, resolve_key

__all__ = ["pt_sharded"]


def pt_sharded(initial_vals, log_kernel, settings=None, *, mesh, key=None,
               dtype=None, device=None,
               axis_name: str = mesh_mod.CHAIN_AXIS) -> SamplerResult:
    """Run PT with rung ``k`` of the ladder on rank ``k`` of ``mesh``
    (ladder size == mesh size). Every rank returns the cold chain's kept
    draws, ``(n_keep, n_vals)``, its ``n_accept_draws``, and
    ``diagnostics`` ``temperatures``, ``swap_accept_rate`` (per adjacent
    pair) and ``exchanges`` (this rank's neighbour exchanges)."""
    algo, s = resolve_settings(settings, "pt_settings", PTSettings)
    if s.adapt_temps:
        raise ValueError("pt_sharded runs a fixed ladder; adapt with "
                         "mcmc_tpu_torch.pt first and pass the result as "
                         "temper_vec")
    ax = mesh_mod.mesh_axis(mesh, axis_name)
    if ax is None:
        raise ValueError(f"mesh has no {axis_name!r} axis")
    prob = common.setup_problem(initial_vals, log_kernel, algo, None, dtype,
                                device)
    dim, dt, box, dev = prob.n_vals, prob.dtype, prob.box_log_kernel, \
        prob.device
    temps = make_ladder(s, dt)
    K = int(temps.shape[0])
    if K != ax.size:
        raise ValueError(f"ladder size {K} must equal mesh size {ax.size}")
    k = ax.index
    # the fixed ladder as the library sampler computes it: through the log
    log_temps = torch.log(temps).to(dev)
    betas = torch.exp(-log_temps)
    beta_k, temp_k = betas[k:k + 1], torch.exp(log_temps[k:k + 1])
    inner = make_inner_move(box, s, dim, dt, dev)
    swap_every = max(int(s.swap_every), 1)

    gen = resolve_key(key, algo, dev)
    seed, rgen = mesh_mod.rank_generator(gen, k)
    sgen = mesh_mod.shared_generator(seed, dev)
    kw = {"generator": rgen, "dtype": dt, "device": dev}
    n_burn, n_keep = int(s.n_burnin_draws), int(s.n_keep_draws)
    with torch.no_grad():
        x = prob.first_draw[:1].clone()
        kv = box(x)
        kv = torch.where(torch.isfinite(kv), kv, -torch.inf)
        draws = x.new_empty((n_keep, dim))
        n_acc = torch.zeros((), dtype=torch.int64, device=dev)
        sw_acc = torch.zeros((), dtype=dt, device=dev)
        sw_att = 0
        exchanges = 0
        for t in range(n_burn + n_keep):
            x, kv, acc = inner(x, kv, beta_k, temp_k,
                               torch.randn((1, dim), **kw),
                               torch.rand((1,), **kw))
            kept = t >= n_burn
            if K > 1 and t % swap_every == swap_every - 1:
                u_sw = torch.rand((K - 1,), generator=sgen, dtype=dt,
                                  device=dev)
                parity = (t // swap_every) % 2
                is_left = k % 2 == parity and k + 1 <= K - 1
                is_right = k % 2 != parity and k >= 1
                if is_left or is_right:
                    peer = k + 1 if is_left else k - 1
                    got = mesh_mod.exchange(torch.cat([x[0], kv]), ax.group,
                                            peer)
                    exchanges += 1
                    pair = k if is_left else k - 1
                    kv_peer = got[dim:]
                    kv_l, kv_r = (kv, kv_peer) if is_left else (kv_peer, kv)
                    log_alpha = (betas[pair] - betas[pair + 1]) \
                        * (kv_r - kv_l)
                    swap = torch.log(u_sw[pair]) \
                        < torch.clamp_max(log_alpha, 0.0)
                    x = torch.where(swap, got[None, :dim], x)
                    kv = torch.where(swap, kv_peer, kv)
                    if kept and is_left:   # pair k's record lives on rank k
                        sw_acc = sw_acc + swap.to(dt)[0]
                        sw_att += 1
            if kept:
                draws[t - n_burn] = x[0]
                n_acc = n_acc + acc.to(torch.int64)[0]

        # every rank's record; the cold chain is rung K - 1
        g = lambda v: mesh_mod.all_gather(v[None], ax.group, ax.size)
        all_draws = g(draws)
        all_acc = g(n_acc)
        all_sw = g(torch.stack([sw_acc, torch.tensor(float(sw_att),
                                                     dtype=dt, device=dev)]))
    swap_rate = all_sw[:-1, 0] / torch.clamp_min(all_sw[:-1, 1], 1.0)
    return SamplerResult(
        draws=common.finalize_draws(all_draws[K - 1], prob),
        n_accept_draws=all_acc[K - 1],
        diagnostics={"temperatures": temps.to(dev),
                     "swap_accept_rate": swap_rate,
                     "exchanges": exchanges})
