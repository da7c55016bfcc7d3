"""Univariate slice sampling within Gibbs (PyTorch port of
``mcmc_tpu.samplers.slice``).

Neal (2003): one coordinate update is

    log_y = log f(x) + log U(0, 1)                  (slice level)
    [L, R] = [x_i - w U(0, 1), L + w]               (randomly placed)
    expand L (resp. R) by w while log f > log_y, the total expansion budget
      max_step_out split randomly between the sides (reversibility)
    repeat: x' ~ U(L, R); accept if log f(x') > log_y
            else shrink (x' < x_i -> L = x', else R = x')

and a draw sweeps the ``d`` coordinates in order. ``max_shrink_steps`` caps
the shrinkage (a capped coordinate keeps its value and the draw reports as
not accepted). ``adapt_w`` learns per-dimension widths ``w_i = 2.5 sd_i``
from windowed Welford variances during burn-in (pooled over the chains with
``pooled_adaptation``).

The JAX package vmaps a single-chain kernel whose stepping-out and
shrinkage are ``lax.while_loop``s. Here the chain batch runs the loops in
lockstep: each iteration is one batched log-kernel evaluation, and a chain
whose loop has ended keeps its result (position, log density, counters)
frozen, as a vmapped ``while_loop`` keeps a finished lane's carry (its
shrinking bracket, read no more, moves unmasked). The two sides
of the stepping-out run in one loop (each side evaluated while any chain
still expands it). Each loop tests its end on the host once an iteration
(one host synchronisation, reading the two sides' flags together in the
stepping-out); the masked iterations a finished chain sits out change
nothing, so the draws are the same as a fixed-length loop's. The random
numbers of a draw are drawn up front (``step.draw``): per coordinate the
slice level's and the bracket's uniforms, the stepping-out budget, and the
shrinkage's ``max_shrink_steps`` uniforms, of which a chain uses the first
as many as it iterates. The proposal ``U(L, R)`` is JAX's
``uniform(minval=L, maxval=R)``, ``max(L, u (R - L) + L)`` with one
rounding (:func:`uniform_between`). ``n_evals``
counts as JAX counts: ``e_l + e_r + it + 1`` a coordinate.

The draw counter is a host integer, so width adaptation stops on the host
after warmup.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mcmc_tpu_torch import adaptation
from mcmc_tpu_torch.results import SamplerResult
from mcmc_tpu_torch.settings import SliceSettings
from mcmc_tpu_torch.samplers import common
from mcmc_tpu_torch.samplers._resolve import resolve_settings, resolve_key

__all__ = ["slice_sampler", "SliceState", "build_slice_kernel",
           "uniform_between"]

# E[slice width] for N(0, sd^2) is 2 sd E[sqrt(-2 ln U)] ~ 2.5 sd, so the
# adapted bracket w_i = 2.5 sd_i spans a typical slice in one placement
_W_PER_SD = 2.5


class SliceState(NamedTuple):
    position: torch.Tensor   # (c, d) unconstrained coordinates
    log_prob: torch.Tensor   # (c,) box log-kernel (-inf if non-finite)
    wv: adaptation.WindowedVariance   # width adaptation ((c, 1) when off)
    draw_ind: int            # host counter


def uniform_between(u, lo, hi):
    """JAX's ``uniform(key, minval=lo, maxval=hi)`` from the ``[0, 1)``
    uniform ``u`` of the same key: ``max(lo, u (hi - lo) + lo)``, where
    XLA's compiler fuses the product and the sum into one multiply-add (one
    rounding). For float32 that is the float64 evaluation rounded once: the
    product of two float32 numbers is exact in float64. (``u`` may come in
    float64 already.)"""
    fused = torch.addcmul(lo.double(), u.double(), (hi - lo).double())
    return torch.maximum(lo, fused.to(lo.dtype))


def _finite_or_neg_inf(v):
    return torch.where(torch.isfinite(v), v, -torch.inf)


def build_slice_kernel(box_log_kernel, n_vals: int, dtype, w,
                       max_step_out: int, max_shrink: int,
                       precond_cfg=None):
    """Batched slice sweep: returns ``init(positions) -> SliceState`` and
    ``step(gen, state) -> (state, info)``, one sweep over the coordinates;
    info ``accepted`` (every coordinate found its slice point before the
    cap) and ``n_evals`` (int32, log-kernel evaluations as JAX counts
    them). ``precond_cfg`` (:func:`mcmc_tpu_torch.adaptation.
    make_precond_cfg`) enables width adaptation.

    ``step.draw(gen, state) -> (u_y, u_place, budget, u_shrink)``: ``(c,
    d)`` uniforms, ``(c, d)`` uniforms, ``(c, d)`` integers in ``[0,
    max_step_out)`` and ``(c, d, max_shrink)`` uniforms;
    ``step.transition(state, u_y, u_place, budget, u_shrink)``.
    ``step.counts`` tallies draws, batched log-kernel evaluations and host
    synchronisations."""
    max_step_out = int(max_step_out)
    max_shrink = int(max_shrink)
    adapting = precond_cfg is not None
    counts = {"draws": 0, "evaluations": 0, "syncs": 0}
    w_host = torch.broadcast_to(torch.as_tensor(w, dtype=dtype).cpu(),
                                (n_vals,))
    w_on = {}   # w_host's copy on each device it has run on
    cols_on = {}   # each device's one-hot column masks, (d, d) bool
    if adapting:   # the schedule on the host, read by the host counter
        sched = [precond_cfg[k].cpu().tolist()
                 for k in ("collect", "window_end")]

    def width_on(device):
        if device not in w_on:
            w_on[device] = w_host.to(device)
        return w_on[device]

    def cols(device):
        if device not in cols_on:
            cols_on[device] = torch.eye(n_vals, dtype=torch.bool,
                                        device=device)
        return cols_on[device]

    def lp_batch(x):
        counts["evaluations"] += 1
        return _finite_or_neg_inf(box_log_kernel(x))

    def init(position):
        c = position.shape[0]
        w_vec = width_on(position.device)
        if adapting:
            wv = adaptation.wv_init(n_vals, position.dtype, c,
                                    position.device)
            # the pre-first-window width is exactly the user's w
            wv = wv._replace(var=((w_vec / _W_PER_SD) ** 2).expand(
                c, n_vals).clone())
        else:
            wv = adaptation.wv_init(1, position.dtype, c, position.device)
        with torch.no_grad():
            lp = lp_batch(position)
        return SliceState(position=position, log_prob=lp, wv=wv,
                          draw_ind=0)

    def draw(gen, state: SliceState):
        pos = state.position
        kw = {"generator": gen, "dtype": pos.dtype, "device": pos.device}
        c, d = pos.shape
        return (torch.rand((c, d), **kw), torch.rand((c, d), **kw),
                torch.randint(0, max_step_out, (c, d), generator=gen,
                              device=pos.device),
                torch.rand((c, d, max_shrink), **kw))

    def any_flags(a, b):
        """The host's view of ``a.any()`` and ``b.any()``: one
        synchronisation for both."""
        counts["syncs"] += 1
        return torch.stack([a.any(), b.any()]).tolist()

    def coord_update(x, lp, i, wi, u_y, u_place, budget, u_shrink):
        """One coordinate ``i`` of every chain; returns the new ``x``,
        ``lp``, the chains that found their slice point and the
        evaluations as JAX counts them."""
        xi = x[:, i]
        col = cols(x.device)[i]
        log_y = lp + torch.log(u_y)

        def lp_at(v):
            return lp_batch(torch.where(col, v[:, None], x))

        # --- stepping out: both sides in one loop, each side's chains
        # frozen once their budget is spent or their end left the slice
        L = xi - wi * u_place
        R = L + wi
        b_l = budget.to(torch.int32)
        b_r = (max_step_out - 1) - b_l
        sides = [[L, b_l, torch.zeros_like(b_l), b_l > 0, -1.0],
                 [R, b_r, torch.zeros_like(b_r), b_r > 0, 1.0]]
        live = [True, True]
        while any(live):
            for s, side in enumerate(sides):
                if not live[s]:
                    continue
                v, b, e, act, sign = side
                cont = act & (lp_at(v) > log_y)
                side[0] = torch.where(cont, v + sign * wi, v)
                side[1] = b - cont.to(b.dtype)
                side[2] = e + cont.to(e.dtype)
                side[3] = cont & (side[1] > 0)
            live = [lv and f for lv, f in
                    zip(live, any_flags(sides[0][3], sides[1][3]))]
        (L, _, e_l, _, _), (R, _, e_r, _, _) = sides

        # --- shrinkage, each chain's t-th iteration on its t-th uniform
        done = torch.zeros_like(xi, dtype=torch.bool)
        # a chain's shrink iterations: the one it ends in, the cap if none
        it = torch.full_like(b_l, max_shrink)
        lo, hi, x_new, lp_new = L, R, xi, lp
        for t in range(max_shrink):
            prop = uniform_between(u_shrink[:, t], lo, hi)
            lp_prop = lp_at(prop)
            ok = ~done & (lp_prop > log_y)
            x_new = torch.where(ok, prop, x_new)
            lp_new = torch.where(ok, lp_prop, lp_new)
            it = torch.where(ok, t + 1, it)
            # a chain done (now or before) reads its bracket no more: it
            # moves unmasked
            lo = torch.where(prop < xi, prop, lo)
            hi = torch.where(prop >= xi, prop, hi)
            done = done | ok
            if t + 1 < max_shrink:
                counts["syncs"] += 1
                if bool(done.all()):
                    break
        return (torch.where(col, x_new[:, None], x), lp_new, done,
                e_l + e_r + it + 1)

    def transition(state: SliceState, u_y, u_place, budget, u_shrink):
        x, lp = state.position, state.log_prob
        c, d = x.shape
        counts["draws"] += 1
        if adapting:
            width = _W_PER_SD * torch.sqrt(state.wv.var)
        else:
            width = width_on(x.device).expand(c, d)
        all_ok = torch.ones((c,), dtype=torch.bool, device=x.device)
        n_evals = torch.zeros((c,), dtype=torch.int32, device=x.device)
        u_shrink = u_shrink.double()   # uniform_between's, once a draw
        for i in range(d):
            x, lp, ok, ev = coord_update(x, lp, i, width[:, i], u_y[:, i],
                                         u_place[:, i], budget[:, i],
                                         u_shrink[:, i])
            all_ok = all_ok & ok
            n_evals = n_evals + ev
        wv = state.wv
        if adapting and state.draw_ind < precond_cfg["n_adapt"]:
            j = min(state.draw_ind, len(sched[0]) - 1)
            flags = [torch.full((c,), m[j], device=x.device) for m in sched]
            wv = adaptation.wv_update(wv, x, *flags,
                                      pooled=precond_cfg["pooled"])
        return (SliceState(position=x, log_prob=lp, wv=wv,
                           draw_ind=state.draw_ind + 1),
                {"accepted": all_ok, "n_evals": n_evals})

    def step(gen, state: SliceState):
        return transition(state, *draw(gen, state))

    step.draw, step.transition, step.counts = draw, transition, counts
    return init, step


def slice_sampler(initial_vals, log_kernel, settings=None, *, n_chains=None,
                  key=None, mesh=None, checkpoint_dir=None,
                  checkpoint_every=500, dtype=None, thin=1,
                  adapt_w=False, pooled_adaptation=False,
                  return_resume=False, device=None) -> SamplerResult:
    """Run univariate slice sampling within Gibbs (module docstring).
    ``log_kernel`` is batched: ``(n_chains, n_vals) -> (n_chains,)``.

    ``SliceSettings.w`` is the initial bracket width (scalar or
    per-dimension). ``accept_rate == 1.0`` is the healthy state (below it
    the ``max_shrink_steps`` cap bound); ``diagnostics
    ["mean_kernel_evals"]`` reports log-kernel evaluations per draw, as
    JAX counts them. ``adapt_w=True`` learns per-dimension widths (pooled
    with ``pooled_adaptation``), reported as ``diagnostics["adapted_w"]``.
    ``key`` is a ``torch.Generator`` or an integer seed; ``device``
    defaults to that of ``initial_vals``, else the card. ``mesh`` is not ported
    yet and raises; ``checkpoint_dir`` runs in restartable chunks
    (:mod:`mcmc_tpu_torch.checkpoint`)."""
    algo, s = resolve_settings(settings, "slice_settings", SliceSettings)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")
    if int(s.max_step_out) < 1:
        raise ValueError(f"max_step_out must be >= 1, got {s.max_step_out}")
    if int(s.max_shrink_steps) < 1:
        raise ValueError(f"max_shrink_steps must be >= 1, got "
                         f"{s.max_shrink_steps}")

    prob = common.setup_problem(initial_vals, log_kernel, algo, n_chains,
                                dtype, device)
    gen = resolve_key(key, algo, prob.device)
    w = torch.as_tensor(s.w, dtype=prob.dtype)
    if not bool((w > 0).all()):
        raise ValueError("w (initial bracket width) must be positive")

    precond_cfg = None
    if adapt_w:
        precond_cfg = adaptation.make_precond_cfg(
            s.n_burnin_draws, pooled_adaptation, prob.device)
    init, step = build_slice_kernel(prob.box_log_kernel, prob.n_vals,
                                    prob.dtype, w, s.max_step_out,
                                    s.max_shrink_steps, precond_cfg)
    state0 = init(prob.first_draw)

    def assemble(key, state0, n_burnin, n_keep):
        final_state, draws, infos = common.run_sampler_loop(
            resolve_key(key, algo, prob.device), state0, step, n_burnin,
            n_keep, collect_fn=lambda st: st.position, mesh=mesh,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, thin=thin)
        n_accept = common.tally_accepts(infos)
        draws = common.finalize_draws(draws, prob)
        if "n_evals" in infos:
            evals = infos["n_evals"].to(prob.dtype).mean(dim=0)
        else:       # checkpointed run: the per-chain totals
            evals = torch.as_tensor(infos["totals"]["n_evals"]).to(
                prob.dtype) / n_keep
        diagnostics = {"mean_kernel_evals": evals}
        if adapt_w:
            diagnostics["adapted_w"] = \
                _W_PER_SD * torch.sqrt(final_state.wv.var)
        if prob.squeeze:
            draws = draws[:, 0, :]
            n_accept = n_accept[0]
            diagnostics = {k: v[0] for k, v in diagnostics.items()}
        if thin > 1:   # accept_rate divides by n_keep*thin
            diagnostics["thin"] = int(thin)
        return SamplerResult(draws=draws, n_accept_draws=n_accept,
                             diagnostics=diagnostics), final_state

    result, final_state = assemble(gen, state0, s.n_burnin_draws,
                                   s.n_keep_draws)
    if return_resume:
        common.attach_resume(result, assemble, final_state)
    return result
