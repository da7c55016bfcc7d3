"""Random-walk Metropolis-Hastings (PyTorch port of
``mcmc_tpu.samplers.rwmh``).

Reference src/rwmh.cpp:30-199: the Gaussian random walk
``z* = z + par_scale * chol(cov) @ xi`` (src/rwmh.cpp:113,122-123), the
accept test ``log u < min(0, delta_logK)`` (src/rwmh.cpp:133-136) with
non-finite proposal log-kernels forced to -inf (src/rwmh.cpp:127-129).

Extensions (no reference analog), as in the JAX package:
- ``adapt_scale=True``: dual averaging of the proposal scale toward 0.234
  acceptance during burn-in, the averaged iterate frozen afterwards;
- ``adapt_precond=True`` / ``"diag"`` / ``"dense"``: a windowed Welford
  estimate of the posterior (co)variance as the proposal covariance, pooled
  over the chains with ``pooled_adaptation``; dual averaging restarts at
  window ends;
- ``delayed_rejection=True``: a second-stage proposal after a first-stage
  rejection, the same walk shrunk by ``dr_shrink`` (Mira 2001; DRAM with
  ``adapt_precond="dense"``), accepted with the exact two-stage ratio in
  noise space. Both stages' random numbers are drawn every draw for every
  chain, and stage two is masked where stage one accepted.

The kernel is batched over chains and needs no host synchronisation. A
transition is a draw of its random numbers from the run's one
``torch.Generator`` (``step.draw``: the walk's normals and the accept
uniform, and with delayed rejection stage two's) followed by a function of
those draws (``step.transition``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mcmc_tpu_torch import adaptation
from mcmc_tpu_torch.results import SamplerResult
from mcmc_tpu_torch.settings import RWMHSettings
from mcmc_tpu_torch.samplers import common
from mcmc_tpu_torch.samplers._resolve import resolve_settings, resolve_key

__all__ = ["rwmh", "RWMHState", "build_rwmh_kernel"]


class RWMHState(NamedTuple):
    position: torch.Tensor    # (c, d) unconstrained coordinates
    log_prob: torch.Tensor    # (c,) box log-kernel at position
    da: adaptation.DualAveraging       # (c,) each
    wv: adaptation.WindowedVariance    # proposal-covariance adaptation (diag)
    pchol: torch.Tensor       # (c, d, d) chol of the proposal cov; (c, 1)
    pm2: torch.Tensor         # (c, d, d) dense outer-product sums; (c, 1)
    draw_ind: torch.Tensor    # (c,) int32


def build_rwmh_kernel(box_log_kernel, prop_chol_mv, par_scale,
                      adapt_cfg=None, precond_cfg=None, dr_shrink=None):
    """Batched RWMH transition: returns ``init(positions) -> RWMHState``
    and ``step(gen, state) -> (state, info)``.

    ``adapt_cfg`` is ``None`` (fixed scale) or a dict with ``n_burnin`` and
    ``target`` for dual-averaging scale adaptation. ``precond_cfg`` is
    ``None`` or :func:`mcmc_tpu_torch.adaptation.make_precond_cfg`'s bundle
    with ``mode`` ("diag" or "dense") for the windowed proposal covariance.
    ``dr_shrink`` turns on delayed rejection. ``step.draw(gen, state) ->
    (noise, u, noise2, u2)`` (the last two ``None`` without delayed
    rejection) and ``step.transition(state, noise, u, noise2, u2)`` are its
    two halves; ``step.counts`` tallies draws, log-kernel evaluations and
    host synchronisations (none).
    """
    dense = precond_cfg is not None and precond_cfg.get("mode") == "dense"

    def init(position):
        c, dim = position.shape
        kw = {"dtype": position.dtype, "device": position.device}
        with torch.no_grad():
            log_prob = box_log_kernel(position)
        return RWMHState(
            position=position,
            log_prob=log_prob,
            da=adaptation.da_init(torch.full((c,), float(par_scale), **kw)),
            wv=adaptation.wv_init(dim, position.dtype, c, position.device),
            pchol=(torch.eye(dim, **kw).expand(c, dim, dim).clone() if dense
                   else torch.ones((c, 1), **kw)),
            pm2=(torch.zeros((c, dim, dim), **kw) if dense
                 else torch.ones((c, 1), **kw)),
            draw_ind=torch.zeros((c,), dtype=torch.int32,
                                 device=position.device),
        )

    counts = {"draws": 0, "evaluations": 0, "syncs": 0}

    def draw(gen, state: RWMHState):
        pos = state.position
        kw = {"generator": gen, "dtype": pos.dtype, "device": pos.device}
        noise = torch.randn(pos.shape, **kw)
        u = torch.rand(pos.shape[:1], **kw)
        if dr_shrink is None:
            return noise, u, None, None
        return noise, u, torch.randn(pos.shape, **kw), \
            torch.rand(pos.shape[:1], **kw)

    def finite_or_neg_inf(lp):
        return torch.where(torch.isfinite(lp), lp, -torch.inf)

    def transition(state: RWMHState, noise, u, noise2=None, u2=None):
        pos = state.position
        if adapt_cfg is None:
            scale = par_scale
        else:
            adapting = state.draw_ind < adapt_cfg["n_burnin"]
            scale = torch.exp(torch.where(adapting, state.da.log_eps,
                                          state.da.log_eps_bar))

        def chol_mv(v):
            if precond_cfg is None:
                return prop_chol_mv(v)
            if dense:
                return (state.pchol @ v[:, :, None])[:, :, 0]
            return torch.sqrt(state.wv.var) * v

        proposal = pos + common.chain_col(scale) * chol_mv(noise)
        prop_lp = finite_or_neg_inf(box_log_kernel(proposal))
        counts["draws"] += 1
        counts["evaluations"] += 1

        comp = torch.clamp_max(prop_lp - state.log_prob, 0.0)
        accepted = u < torch.exp(comp)
        new_position = common.where_chains(accepted, proposal, pos)
        new_lp = torch.where(accepted, prop_lp, state.log_prob)

        if dr_shrink is not None:
            # second-stage (delayed-rejection) move for every chain:
            # y2 = x + s2 C z2, s2 = dr_shrink * s1. Mira (2001) ratio for
            # symmetric shared-Cholesky stages, the q1 terms in noise space:
            # log q1(y2->y1) - log q1(x->y1)
            #   = -(|s1 z1 - s2 z2|^2 / s1^2 - |z1|^2) / 2
            s2 = dr_shrink * scale
            y2 = pos + common.chain_col(s2) * chol_mv(noise2)
            y2_lp = finite_or_neg_inf(box_log_kernel(y2))
            counts["evaluations"] += 1

            diffz = common.chain_col(scale) * noise \
                - common.chain_col(s2) * noise2
            qdiff = -0.5 * ((diffz * diffz).sum(dim=-1) / (scale * scale)
                            - (noise * noise).sum(dim=-1))
            # log(1 - alpha1(a -> y1)) = log1p(-exp(min(0, lp1 - lp_a))):
            # exactly -inf when alpha1 = 1, which is right (zero weight) in
            # the numerator; in the denominator it reaches -inf only by f32
            # rounding (a rejected stage one has alpha1 < 1), and then the
            # ratio means nothing and stage two rejects
            c_num = torch.clamp_max(prop_lp - y2_lp, 0.0)
            c_den = comp
            log1m_den = torch.log1p(-torch.exp(c_den))
            log_a2 = (y2_lp + qdiff + torch.log1p(-torch.exp(c_num))) \
                - (state.log_prob + log1m_den)
            log_a2 = torch.where(torch.isnan(log_a2) | (c_den >= 0.0)
                                 | ~torch.isfinite(log1m_den),
                                 -torch.inf, log_a2)
            accepted2 = (~accepted) & (
                torch.log(u2) < torch.clamp_max(log_a2, 0.0))
            new_position = common.where_chains(accepted2, y2, new_position)
            new_lp = torch.where(accepted2, y2_lp, new_lp)
            accepted = accepted | accepted2

        da = state.da
        if adapt_cfg is not None:
            accept_stat = torch.exp(comp)
            accept_stat = torch.where(torch.isnan(accept_stat), 0.0,
                                      accept_stat)
            da_new = adaptation.da_update(da, accept_stat,
                                          adapt_cfg["target"])
            da = adaptation.DualAveraging(*[torch.where(adapting, new, old)
                                            for new, old in zip(da_new, da)])

        wv, pchol, pm2 = state.wv, state.pchol, state.pm2
        if precond_cfg is not None and not dense:
            wv, da = adaptation.windowed_precond_step(
                wv, da, new_position, state.draw_ind, precond_cfg,
                reset_da=adapt_cfg is not None)
        elif dense:
            # the adopted covariance itself is discarded (only its Cholesky
            # drives the proposal), hence the zeros placeholder
            wv, da, _cov, pchol, pm2 = adaptation.windowed_dense_step(
                wv, da, torch.zeros_like(pm2), pchol, pm2, new_position,
                state.draw_ind, precond_cfg, reset_da=adapt_cfg is not None)

        new_state = RWMHState(position=new_position, log_prob=new_lp, da=da,
                              wv=wv, pchol=pchol, pm2=pm2,
                              draw_ind=state.draw_ind + 1)
        return new_state, {"accepted": accepted}

    def step(gen, state: RWMHState):
        return transition(state, *draw(gen, state))

    step.draw, step.transition, step.counts = draw, transition, counts
    return init, step


def rwmh(initial_vals, log_kernel, settings=None, *, n_chains=None, key=None,
         mesh=None, checkpoint_dir=None, checkpoint_every=500, dtype=None,
         adapt_scale=False, adapt_precond=False, pooled_adaptation=False,
         target_accept=None, delayed_rejection=False, thin=1,
         return_resume=False, device=None) -> SamplerResult:
    """Run RWMH (module docstring). ``log_kernel`` is batched: ``(n_chains,
    n_vals) -> (n_chains,)``.

    With ``n_chains`` set, ``initial_vals`` may be ``(n_vals,)``
    (broadcast) or ``(n_chains, n_vals)``; draws come back as ``(n_keep,
    n_chains, n_vals)``. ``adapt_scale=True`` tunes the proposal scale
    during burn-in (target acceptance 0.234 unless overridden);
    ``adapt_precond=True`` (or ``"diag"`` / ``"dense"``) learns a diagonal
    or full proposal covariance, pooled across chains when
    ``pooled_adaptation``. ``delayed_rejection=True`` adds the second-stage
    fallback proposal (with ``adapt_precond="dense"`` this is DRAM); the
    reported ``accept_rate`` counts either stage, while scale adaptation
    targets the first stage's. ``return_resume=True`` attaches
    ``diagnostics["resume"](key, n_keep)``. ``key`` is a
    ``torch.Generator`` or an integer seed (``None``: the settings'
    ``rng_seed_value``); ``device`` defaults to that of ``initial_vals``,
    else the card. ``mesh`` shards the chains over its ranks
    (:mod:`mcmc_tpu_torch.parallel`); ``checkpoint_dir``
    runs in restartable chunks (:mod:`mcmc_tpu_torch.checkpoint`).
    """
    algo, s = resolve_settings(settings, "rwmh_settings", RWMHSettings)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")

    prob = common.setup_problem(initial_vals, log_kernel, algo, n_chains,
                                dtype, device)
    gen = resolve_key(key, algo, prob.device)
    cov = common.make_spd(s.cov_mat, prob.n_vals, prob.dtype, prob.device)
    if adapt_precond and s.cov_mat is not None:
        raise ValueError("adapt_precond is incompatible with a user cov_mat "
                         "— the proposal covariance is learned")

    adapt_cfg = None
    if adapt_scale:
        adapt_cfg = {
            "n_burnin": s.n_burnin_draws,
            "target": target_accept or adaptation.TARGET_ACCEPT["rwmh"],
        }
    precond_cfg = None
    if adapt_precond:
        mode = {True: "diag"}.get(adapt_precond, adapt_precond)
        if mode not in ("diag", "dense"):
            raise ValueError(f"adapt_precond must be False/True/'diag'/"
                             f"'dense', got {adapt_precond!r}")
        precond_cfg = adaptation.make_precond_cfg(
            s.n_burnin_draws, pooled_adaptation, prob.device)
        precond_cfg["mode"] = mode
    init, step = build_rwmh_kernel(
        prob.box_log_kernel, cov.sqrt_mv, s.par_scale, adapt_cfg,
        precond_cfg, dr_shrink=s.dr_shrink if delayed_rejection else None)
    state0 = init(prob.first_draw)

    def assemble(key, state0, n_burnin, n_keep):
        final_state, draws, infos = common.run_sampler_loop(
            resolve_key(key, algo, prob.device), state0, step, n_burnin,
            n_keep, collect_fn=lambda st: st.position, mesh=mesh,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, thin=thin,
        )
        n_accept = common.tally_accepts(infos)
        draws = common.finalize_draws(draws, prob)
        diagnostics = {}
        if adapt_scale:
            diagnostics["adapted_scale"] = torch.exp(
                final_state.da.log_eps_bar)
        if adapt_precond:
            diagnostics["proposal_var"] = final_state.wv.var \
                if precond_cfg["mode"] == "diag" else \
                final_state.pchol @ final_state.pchol.transpose(-1, -2)
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
