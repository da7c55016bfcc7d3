"""Parallel tempering (replica exchange) with HMC or RWMH inner moves
(PyTorch port of ``mcmc_tpu.samplers.pt``).

No reference analog: MCMCLib's multimodal answer is AEES (reference
src/aees.cpp:30-305), whose equi-energy jumps *approximate* what replica
exchange does exactly. A ladder of K replicas targets the tempered densities
``pi_k(x) ∝ exp(beta_k * log_kernel(x))`` (``beta = 1/T``, descending
temperatures, the cold ``T = 1`` chain last, the AEES convention), and
adjacent replicas attempt to swap states with the exact two-temperature
Metropolis ratio

    log alpha_k = (beta_k - beta_{k+1}) * (logK(x_{k+1}) - logK(x_k)).

The ``n_chains`` ladders of ``K`` replicas are one ``(n_chains, K, d)`` batch
and the inner move is one ``(n_chains * K, d)`` call of the log-kernel, with
a per-row inverse temperature and, for HMC, a per-row step
``step_size * sqrt(T)``. Each replica carries its *untempered* kernel value,
so a swap round costs no kernel evaluation. The even/odd swap round is a
per-ladder permutation of the K axis applied with ``torch.gather``; the
round-trip bookkeeping (Syed et al. 2022) follows the occupants with
``scatter``.

The draw counter is a host integer, the same for every ladder, so whether a
draw holds a swap round, its parity and whether the ladder still adapts are
host values: a draw without a swap round skips it. A transition needs no
host synchronisation.

**Ladder adaptation** (``adapt_temps=True``): Robbins-Monro on the log
inverse-temperature spacings (Miasojedow, Moulines & Vihola 2013): with
``log T_k = log T_{k+1} + exp(rho_k)``, each attempted swap updates
``rho_k += gamma_t * (alpha_k - target_swap_accept)``, the swap probability
pooled over the chain axis (a mean, where the JAX package takes
``lax.pmean``), so every chain's ladder stays identical. Adaptation freezes
after ``n_adapt_draws`` (default: the burn-in).

For bounded problems the tempered target is ``beta * box_log_kernel`` on the
unconstrained space (tempering includes the log-Jacobian); the cold chain is
exactly the usual box kernel.

A transition is a draw of its random numbers from the run's one
``torch.Generator`` (``step.draw``: the inner move's normals and accept
uniforms for every replica, and on a swap round the swap uniforms)
followed by a function of those draws (``step.transition``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mcmc_tpu_torch import integrators
from mcmc_tpu_torch.parallel.mesh import chain_mean
from mcmc_tpu_torch.results import SamplerResult
from mcmc_tpu_torch.settings import PTSettings
from mcmc_tpu_torch.samplers import common
from mcmc_tpu_torch.samplers._resolve import resolve_settings, resolve_key

__all__ = ["pt", "PTState", "build_pt_kernel", "make_ladder",
           "make_inner_move"]

_ADAPT_RATE = 0.25     # Robbins-Monro base step for rho updates
_ADAPT_DECAY = 0.6     # gamma_t = RATE / (1 + t)^DECAY over swap rounds


class PTState(NamedTuple):
    X: torch.Tensor      # (c, K, d) replica positions, cold chain last
    kv: torch.Tensor     # (c, K) untempered log-kernel values
    rho: torch.Tensor    # (c, K-1) log inverse-temperature spacings
    occ: torch.Tensor    # (c, K) int32 original-replica id on each rung
    odir: torch.Tensor   # (c, K) int32 per-ORIGINAL-replica flow state: 0
                         # virgin, +1 touched hot, -1 cold-after-hot
    trips: torch.Tensor  # (c, K) int32 completed round trips per replica
    draw_ind: int        # draw counter, the same for every ladder


def make_ladder(s: PTSettings, dtype=torch.float32):
    """Initial descending temperature ladder, on the CPU: explicit
    ``temper_vec`` + T = 1 (the AEES convention), or geometric from
    ``max_temp`` down to 1 over ``n_temps`` rungs."""
    if s.temper_vec is not None:
        user = torch.as_tensor(s.temper_vec, dtype=dtype).reshape(-1).cpu()
        if user.numel() and not bool((user > 1.0).all()):
            raise ValueError(
                "temper_vec entries must all be > 1 (temperatures, not "
                "inverse temperatures); T=1 is appended automatically and "
                "the coldest ladder slot must be the posterior chain")
        temps = torch.sort(torch.cat([user, torch.ones(1, dtype=dtype)]),
                           descending=True).values
    else:
        K = int(s.n_temps)
        if K < 1:
            raise ValueError(f"n_temps must be >= 1, got {K}")
        expo = torch.arange(K - 1, -1, -1, dtype=dtype) / max(K - 1, 1)
        temps = torch.tensor(float(s.max_temp), dtype=dtype) ** expo
    if temps.shape[0] > 1 and not bool((temps[:-1] > temps[1:]).all()):
        raise ValueError("temperature ladder must be strictly descending "
                         "after appending T=1 (duplicate temperatures?)")
    return temps


def make_inner_move(box, s: PTSettings, dim, dtype, device):
    """The batched tempered inner move ``(x, kv, beta, temper, noise, u) ->
    (x, kv, accepted)`` over rows: ``x`` ``(rows, d)``, ``kv``, ``beta``,
    ``temper`` and ``u`` ``(rows,)``, ``noise`` ``(rows, d)`` (HMC's initial
    momenta or RWMH's walk). HMC: ``U = -beta * box``, identity mass, step
    ``step_size * sqrt(T)`` (hot replicas take proportionally longer steps);
    RWMH: the walk ``sqrt(T) * par_scale * chol(cov) xi``."""
    inner = s.inner
    if inner not in ("hmc", "rwmh"):
        raise ValueError(f"inner must be 'hmc' or 'rwmh', got {inner!r}")
    grad_box = integrators.grad_of(box) if inner == "hmc" else None
    cov = common.make_spd(s.cov_mat, dim, dtype, device) \
        if inner == "rwmh" else None
    ident = lambda m: m

    def finite(v):
        return torch.where(torch.isfinite(v), v, -torch.inf)

    def inner_hmc(x, kv, beta, temper, p0, u):
        eps = s.step_size * torch.sqrt(temper)
        beta_col = beta[:, None]
        z, p = integrators.leapfrog(lambda zz: beta_col * grad_box(zz),
                                    ident, eps, int(s.n_leap_steps), x, p0)
        kv_safe = finite(box(z))
        dH = beta * (kv_safe - kv) - 0.5 * ((p * p).sum(-1)
                                            - (p0 * p0).sum(-1))
        acc = torch.log(u) < torch.clamp_max(dH, 0.0)
        return (common.where_chains(acc, z, x), torch.where(acc, kv_safe, kv),
                acc)

    def inner_rwmh(x, kv, beta, temper, noise, u):
        prop = x + (torch.sqrt(temper) * s.par_scale)[:, None] \
            * cov.sqrt_mv(noise)
        kv_safe = finite(box(prop))
        comp = torch.clamp_max(beta * (kv_safe - kv), 0.0)
        acc = torch.log(u) < comp
        return (common.where_chains(acc, prop, x),
                torch.where(acc, kv_safe, kv), acc)

    return inner_hmc if inner == "hmc" else inner_rwmh


def _log_temps_from_rho(rho):
    """(..., K-1) spacings -> (..., K) log-temperatures, cold (log T = 0)
    last."""
    spac = torch.exp(rho)
    rev = torch.flip(torch.cumsum(torch.flip(spac, [-1]), -1), [-1])
    return torch.cat([rev, torch.zeros_like(rev[..., :1])], dim=-1)


def _rm_gain(swap_round):
    """``_ADAPT_RATE / (1 + t)^_ADAPT_DECAY`` in float32 arithmetic, as the
    JAX package computes it from its int32 round counter."""
    one = np.float32(1.0) + np.float32(swap_round)
    return float(np.float32(_ADAPT_RATE) / np.power(one,
                                                     np.float32(_ADAPT_DECAY)))


def build_pt_kernel(box, s: PTSettings, dim, dtype, device, n_adapt):
    """Returns ``(make_state0, step)`` for the batched PT transition over
    ``n_chains`` ladders.

    ``box`` is the (unconstrained-space) batched log-kernel; ``n_adapt`` the
    number of leading draws during which the ladder adapts (0 disables).
    ``step.draw(gen, state) -> (noise, u, u_swap)`` (``u_swap`` ``None``
    off a swap round) and ``step.transition(state, noise, u, u_swap)`` are
    its two halves; ``step.counts`` tallies draws, swap rounds, log-kernel
    evaluations (rows of a batch count once) and host synchronisations
    (none)."""
    temps0 = make_ladder(s, dtype)
    K = int(temps0.shape[0])
    adapt = bool(s.adapt_temps) and n_adapt > 0 and K > 1
    swap_every = max(int(s.swap_every), 1)
    inner_step = make_inner_move(box, s, dim, dtype, device)
    # the fixed ladder's temperatures and inverse temperatures, as JAX
    # computes them: through the log
    log_temps0 = torch.log(temps0).to(device)
    temps_fixed, betas_fixed = torch.exp(log_temps0), torch.exp(-log_temps0)
    idx_K = torch.arange(K, device=device)
    if K > 1:
        lt0 = torch.log(temps0)
        rho0 = torch.log(lt0[:-1] - lt0[1:]).to(device)
        # the pairs (k, k+1) that a round of each parity attempts
        pair_mask = [(torch.arange(K - 1, device=device) % 2) == par
                     for par in (0, 1)]
    else:
        rho0 = torch.zeros((0,), dtype=dtype, device=device)
    counts = {"draws": 0, "swap_rounds": 0, "evaluations": 0, "syncs": 0}

    def draw(gen, state: PTState):
        X = state.X
        kw = {"generator": gen, "dtype": X.dtype, "device": X.device}
        noise = torch.randn(X.shape, **kw)
        u = torch.rand(X.shape[:2], **kw)
        u_swap = None
        if K > 1 and state.draw_ind % swap_every == swap_every - 1:
            u_swap = torch.rand((X.shape[0], K - 1), **kw)
        return noise, u, u_swap

    def transition(state: PTState, noise, u, u_swap=None):
        draw_ind = int(state.draw_ind)
        c = state.X.shape[0]
        if adapt:
            log_temps = _log_temps_from_rho(state.rho)           # (c, K)
            temps, betas = torch.exp(log_temps), torch.exp(-log_temps)
        else:
            temps, betas = temps_fixed.expand(c, K), betas_fixed.expand(c, K)

        X, kv, acc = inner_step(state.X.reshape(c * K, dim),
                                state.kv.reshape(c * K),
                                betas.reshape(c * K), temps.reshape(c * K),
                                noise.reshape(c * K, dim), u.reshape(c * K))
        X, kv, acc = X.reshape(c, K, dim), kv.reshape(c, K), acc.reshape(c, K)
        counts["draws"] += 1
        counts["evaluations"] += 1 + (int(s.n_leap_steps) + 1
                                      if s.inner == "hmc" else 0)
        info = {"accepted": acc[:, K - 1]}
        rho, occ, odir, trips = state.rho, state.occ, state.odir, state.trips

        if K > 1:
            swap_round = draw_ind // swap_every
            do_round = (draw_ind % swap_every) == (swap_every - 1)
            if not do_round:
                zero = torch.zeros((c, K - 1), dtype=X.dtype, device=X.device)
                info["swap_accepted"] = info["swap_attempted"] = zero
            else:
                counts["swap_rounds"] += 1
                active = pair_mask[swap_round % 2]                # (K-1,)
                log_alpha = (betas[:, :-1] - betas[:, 1:]) \
                    * (kv[:, 1:] - kv[:, :-1])
                acc_swap = active & (torch.log(u_swap)
                                     < torch.clamp_max(log_alpha, 0.0))
                no = torch.zeros_like(acc_swap[:, :1])
                with_next = torch.cat([acc_swap, no], dim=1)    # k takes k+1
                with_prev = torch.cat([no, acc_swap], dim=1)    # k takes k-1
                perm = torch.where(with_next, idx_K + 1,
                                   torch.where(with_prev, idx_K - 1, idx_K))
                X = torch.gather(X, 1, perm[:, :, None].expand(c, K, dim))
                kv = torch.gather(kv, 1, perm)
                occ = torch.gather(occ, 1, perm)
                act = active.to(X.dtype).expand(c, K - 1)
                info["swap_accepted"] = acc_swap.to(X.dtype)
                info["swap_attempted"] = act

                if adapt and draw_ind < n_adapt:
                    alpha = torch.exp(torch.clamp_max(log_alpha, 0.0))
                    alpha = chain_mean(alpha, dim=0, keepdim=True)  # pooled
                    upd = _rm_gain(swap_round) * (alpha
                                                  - s.target_swap_accept)
                    rho = torch.where(active, rho + upd, rho)

            # replica-flow bookkeeping (Syed et al. 2022 round-trip rate): a
            # round trip is a completed hot->cold->hot traversal; the
            # per-ORIGINAL-replica states follow the occupant through swaps:
            # 0 never touched the hot end, +1 touched hot, heading cold, -1
            # touched cold AFTER hot. JAX runs it every draw; with the
            # occupants unchanged since the last run it changes nothing, so
            # it runs on swap rounds and on the draws before the first.
            if do_round or draw_ind < swap_every - 1:
                hot = occ[:, :1].long()
                cold = occ[:, K - 1:].long()
                trips = trips.scatter_add(
                    1, hot, (torch.gather(odir, 1, hot) < 0).to(trips.dtype))
                odir = odir.scatter(1, hot, torch.ones_like(hot,
                                                            dtype=odir.dtype))
                od_cold = torch.gather(odir, 1, cold)
                odir = odir.scatter(1, cold, torch.where(
                    od_cold == 1, -torch.ones_like(od_cold), od_cold))

        new_state = PTState(X=X, kv=kv, rho=rho, occ=occ, odir=odir,
                            trips=trips, draw_ind=draw_ind + 1)
        return new_state, info

    def step(gen, state: PTState):
        return transition(state, *draw(gen, state))

    def make_state0(first, val_init):
        """Every ladder's K replicas at its row of ``first`` ``(c, d)``,
        with kernel values ``val_init`` ``(c,)``."""
        c = first.shape[0]
        i32 = {"dtype": torch.int32, "device": first.device}
        return PTState(
            X=first[:, None, :].expand(c, K, dim).clone(),
            kv=val_init[:, None].expand(c, K).clone(),
            rho=rho0.to(first.dtype).expand(c, max(K - 1, 0)).clone(),
            occ=torch.arange(K, **i32).expand(c, K).clone(),
            odir=torch.zeros((c, K), **i32),
            trips=torch.zeros((c, K), **i32),
            draw_ind=0)

    step.draw, step.transition, step.counts = draw, transition, counts
    step.K = K
    return make_state0, step


def pt(initial_vals, log_kernel, settings=None, *, n_chains=None, key=None,
       mesh=None, checkpoint_dir=None, checkpoint_every=500, dtype=None,
       thin=1, return_resume=False, device=None) -> SamplerResult:
    """Run parallel tempering (module docstring). ``log_kernel`` is batched:
    ``(rows, n_vals) -> (rows,)``; it is called on all ``n_chains * K``
    replicas at once. Returns the cold (T = 1) chain's kept draws,
    ``(n_keep, n_chains, n_vals)`` (chain axis squeezed when ``n_chains``
    is None).

    Diagnostics: ``temperatures`` (the final ladder, adapted when
    ``adapt_temps=True``), ``swap_accept_rate`` (per adjacent pair, over
    kept draws), and the replica-flow measures ``round_trips`` /
    ``round_trip_rate`` (completed hot->cold->hot traversals per ladder
    over the whole run, burn-in included, and per sweep; on a warm
    ``resume`` the counts stay cumulative while the denominator restarts).
    ``return_resume=True`` attaches ``diagnostics["resume"](key, n_keep)``.
    ``key`` is a ``torch.Generator`` or an integer seed; ``device``
    defaults to that of ``initial_vals``, else the card. ``mesh`` shards the
    chains over its ranks (:mod:`mcmc_tpu_torch.parallel`); ``checkpoint_dir``
    runs in restartable chunks (:mod:`mcmc_tpu_torch.checkpoint`)."""
    algo, s = resolve_settings(settings, "pt_settings", PTSettings)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")
    common.check_mesh(mesh)

    prob = common.setup_problem(initial_vals, log_kernel, algo, n_chains,
                                dtype, device)
    gen = resolve_key(key, algo, prob.device)
    dim, dt, box = prob.n_vals, prob.dtype, prob.box_log_kernel

    n_adapt = s.n_adapt_draws if s.n_adapt_draws is not None \
        else s.n_burnin_draws
    make_state0, step = build_pt_kernel(box, s, dim, dt, prob.device,
                                        int(n_adapt))
    K = step.K
    with torch.no_grad():
        kv0 = box(prob.first_draw)
        kv0 = torch.where(torch.isfinite(kv0), kv0, -torch.inf)
    state0 = make_state0(prob.first_draw, kv0)

    def assemble(key, state0, n_burnin, n_keep):
        final, draws, infos = common.run_sampler_loop(
            resolve_key(key, algo, prob.device), state0, step, n_burnin,
            n_keep, collect_fn=lambda st: st.X[:, K - 1], mesh=mesh,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            thin=thin)
        draws = common.finalize_draws(draws, prob)
        n_accept = common.tally_accepts(infos)

        if K > 1:
            if "totals" in infos:
                acc_sum = torch.as_tensor(infos["totals"]["swap_accepted"])
                att_sum = torch.as_tensor(infos["totals"]["swap_attempted"])
            else:
                acc_sum = infos["swap_accepted"].sum(dim=0)
                att_sum = infos["swap_attempted"].sum(dim=0)
            swap_rate = acc_sum / torch.clamp_min(att_sum, 1.0)  # (c, K-1)
            if prob.squeeze:
                swap_rate = swap_rate[0]
        else:
            swap_rate = torch.zeros((0,), dtype=dt, device=prob.device)

        if s.adapt_temps and K > 1:
            # chain-pooled adaptation keeps every chain's ladder identical;
            # report chain 0's
            temps_final = torch.exp(_log_temps_from_rho(final.rho[0]))
        else:
            temps_final = make_ladder(s, dt).to(prob.device)

        # replica-flow efficiency (Syed, Bouchard-Côté et al. 2022): total
        # hot->cold->hot round trips per ladder over the WHOLE run and the
        # per-sweep rate
        n_sweeps = (n_burnin + n_keep) * max(int(thin), 1)
        round_trips = final.trips.sum(dim=-1)                 # (c,)
        trip_rate = round_trips.to(dt) / float(max(n_sweeps, 1))
        if prob.squeeze:
            round_trips, trip_rate = round_trips[0], trip_rate[0]
            draws = draws[:, 0, :]
            n_accept = n_accept[0]

        return SamplerResult(
            draws=draws, n_accept_draws=n_accept,
            diagnostics={"temperatures": temps_final,
                         "swap_accept_rate": swap_rate,
                         "round_trips": round_trips,
                         "round_trip_rate": trip_rate,
                         **({"thin": int(thin)} if thin > 1 else {})},
        ), final

    result, final_state = assemble(gen, state0, s.n_burnin_draws,
                                   s.n_keep_draws)
    if return_resume:
        common.attach_resume(result, assemble, final_state)
    return result
