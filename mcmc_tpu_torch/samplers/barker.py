"""Barker proposal MCMC (PyTorch port of ``mcmc_tpu.samplers.barker``).

Livingstone & Zanella (2022, JRSS-B): the gradient skews the *sign* of a
symmetric per-coordinate kick instead of shifting the proposal's mean,

    z_i ~ N(0, (eps s_i)^2),   y_i = x_i + b_i z_i,
    P(b_i = +1) = sigmoid(z_i g_i(x)),   g = grad log pi,

so the proposal never travels further than its Gaussian envelope, and the
MH correction keeps only the skew factors (the envelopes cancel):

    log alpha = pi(y) - pi(x)
              + sum_i [softplus(-d_i g_i(x)) - softplus(d_i g_i(y))],
    d = y - x.

Carried over from the JAX package: the current point's box gradient rides
in the chain state (one autograd gradient a draw), non-finite log-densities
become -inf and non-finite gradients 0, a NaN log-ratio rejects, dual
averaging of the global scale toward 0.574 acceptance and windowed
diagonal proposal scales ``s_i`` (pooled over the chains with
``pooled_adaptation``). Bounded problems use the exact box gradient.

The kernel is batched over chains and needs no host synchronisation. A
transition is a draw of its random numbers from the run's one
``torch.Generator`` (``step.draw``: the kick's normals, the sign uniforms
and the accept uniform) followed by a function of those draws
(``step.transition``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from mcmc_tpu_torch import adaptation
from mcmc_tpu_torch.results import SamplerResult
from mcmc_tpu_torch.settings import BarkerSettings
from mcmc_tpu_torch.samplers import common
from mcmc_tpu_torch.samplers._resolve import resolve_settings, resolve_key
from mcmc_tpu_torch.samplers.mala import _value_and_grad

__all__ = ["barker", "BarkerState", "build_barker_kernel"]


class BarkerState(NamedTuple):
    position: torch.Tensor   # (c, d)
    log_prob: torch.Tensor   # (c,)
    grad: torch.Tensor       # (c, d) box gradient at position
    da: adaptation.DualAveraging       # (c,) each
    wv: adaptation.WindowedVariance    # diagonal proposal-scale adaptation
    draw_ind: torch.Tensor   # (c,) int32


def _finite(lp, grad):
    return (torch.where(torch.isfinite(lp), lp, -torch.inf),
            torch.where(torch.isfinite(grad), grad, 0.0))


def build_barker_kernel(prob: common.Problem, step_size, adapt_cfg=None,
                        precond_cfg=None):
    """Batched Barker transition: returns ``init(positions) -> BarkerState``
    and ``step(gen, state) -> (state, info)``; ``adapt_cfg`` (dual
    averaging: ``n_burnin``, ``target``) and ``precond_cfg``
    (:func:`mcmc_tpu_torch.adaptation.make_precond_cfg`) as for MALA.
    ``step.draw(gen, state) -> (xi, u_sign, u_accept)`` and
    ``step.transition(state, xi, u_sign, u_accept)`` are its two halves;
    ``step.counts`` tallies draws, gradients and host synchronisations
    (none)."""
    box_vg = _value_and_grad(prob.box_log_kernel)
    adapt_m = precond_cfg is not None
    counts = {"draws": 0, "gradients": 0, "syncs": 0}

    def init(position):
        c, dim = position.shape
        kw = {"dtype": position.dtype, "device": position.device}
        lp, grad = _finite(*box_vg(position))
        return BarkerState(
            position=position, log_prob=lp, grad=grad,
            da=adaptation.da_init(torch.full((c,), float(step_size), **kw)),
            wv=adaptation.wv_init(dim, position.dtype, c, position.device),
            draw_ind=torch.zeros((c,), dtype=torch.int32,
                                 device=position.device),
        )

    def draw(gen, state: BarkerState):
        pos = state.position
        kw = {"generator": gen, "dtype": pos.dtype, "device": pos.device}
        return (torch.randn(pos.shape, **kw), torch.rand(pos.shape, **kw),
                torch.rand(pos.shape[:1], **kw))

    def transition(state: BarkerState, xi, u_sign, u_accept):
        pos = state.position
        if adapt_cfg is None:
            eps = step_size
        else:
            adapting = state.draw_ind < adapt_cfg["n_burnin"]
            eps = torch.exp(torch.where(adapting, state.da.log_eps,
                                        state.da.log_eps_bar))
        scale = common.chain_col(eps)
        if adapt_m:
            scale = scale * torch.sqrt(state.wv.var)
        counts["draws"] += 1

        z = scale * xi
        # P(b = +1) = sigmoid(z g): one uniform per coordinate
        b = torch.where(u_sign < torch.sigmoid(z * state.grad), 1.0, -1.0)
        d = b * z
        proposal = pos + d
        prop_lp, prop_grad = _finite(*box_vg(proposal))
        counts["gradients"] += 1

        adj = (F.softplus(-d * state.grad)
               - F.softplus(d * prop_grad)).sum(dim=-1)
        comp = torch.clamp_max(prop_lp - state.log_prob + adj, 0.0)
        comp = torch.where(torch.isnan(comp), -torch.inf, comp)
        accepted = torch.log(u_accept) < comp
        new_position = common.where_chains(accepted, proposal, pos)

        da = state.da
        if adapt_cfg is not None:
            da_new = adaptation.da_update(da, torch.exp(comp),
                                          adapt_cfg["target"])
            da = adaptation.DualAveraging(*[torch.where(adapting, new, old)
                                            for new, old in zip(da_new, da)])
        wv = state.wv
        if adapt_m:
            wv, da = adaptation.windowed_precond_step(
                wv, da, new_position, state.draw_ind, precond_cfg,
                reset_da=adapt_cfg is not None)

        new_state = BarkerState(
            position=new_position,
            log_prob=torch.where(accepted, prop_lp, state.log_prob),
            grad=common.where_chains(accepted, prop_grad, state.grad),
            da=da, wv=wv, draw_ind=state.draw_ind + 1)
        return new_state, {"accepted": accepted}

    def step(gen, state: BarkerState):
        return transition(state, *draw(gen, state))

    step.draw, step.transition, step.counts = draw, transition, counts
    return init, step


def barker(initial_vals, log_kernel, settings=None, *, n_chains=None,
           key=None, mesh=None, checkpoint_dir=None, checkpoint_every=500,
           dtype=None, adapt_step_size=False, adapt_precond=False,
           pooled_adaptation=False, target_accept=None, thin=1,
           return_resume=False, device=None) -> SamplerResult:
    """Run the Barker proposal sampler (module docstring). ``log_kernel``
    is batched: ``(n_chains, n_vals) -> (n_chains,)``.

    ``adapt_step_size=True`` dual-averages the global scale toward 0.574
    acceptance during burn-in; ``adapt_precond=True`` learns per-coordinate
    proposal scales from windowed Welford variances, pooled across chains
    with ``pooled_adaptation``. ``return_resume=True`` attaches
    ``diagnostics["resume"](key, n_keep)``. ``key`` is a
    ``torch.Generator`` or an integer seed; ``device`` defaults to that of
    ``initial_vals``, else the card. ``mesh`` is not ported yet and raises;
    ``checkpoint_dir`` runs in restartable chunks
    (:mod:`mcmc_tpu_torch.checkpoint`)."""
    algo, s = resolve_settings(settings, "barker_settings", BarkerSettings)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")

    prob = common.setup_problem(initial_vals, log_kernel, algo, n_chains,
                                dtype, device)
    gen = resolve_key(key, algo, prob.device)
    adapt_cfg = None
    if adapt_step_size:
        adapt_cfg = {"n_burnin": s.n_burnin_draws,
                     "target": target_accept
                     or adaptation.TARGET_ACCEPT["barker"]}
    precond_cfg = None
    if adapt_precond:
        precond_cfg = adaptation.make_precond_cfg(
            s.n_burnin_draws, pooled_adaptation, prob.device)
    init, step = build_barker_kernel(prob, s.step_size, adapt_cfg,
                                     precond_cfg)
    state0 = init(prob.first_draw)

    def assemble(key, state0, n_burnin, n_keep):
        final_state, draws, infos = common.run_sampler_loop(
            resolve_key(key, algo, prob.device), state0, step, n_burnin,
            n_keep, collect_fn=lambda st: st.position, mesh=mesh,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, thin=thin)
        n_accept = common.tally_accepts(infos)
        draws = common.finalize_draws(draws, prob)
        diagnostics = {}
        if adapt_step_size:
            diagnostics["adapted_step_size"] = torch.exp(
                final_state.da.log_eps_bar)
        if adapt_precond:
            diagnostics["precond_var"] = final_state.wv.var
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
