"""Simplified manifold MALA (PyTorch port of ``mcmc_tpu.samplers.mmala``).

Girolami & Calderhead (2011, JRSS-B) position-dependent Langevin proposals

    y ~ N( x + eps^2/2 G(x)^{-1} grad log p(x),  eps^2 G(x)^{-1} )

with the Metropolis-Hastings correction evaluating the asymmetric proposal
density in both directions; the "simplified" variant drops the Christoffel
drift terms, which the MH test makes exact anyway. One metric evaluation,
Cholesky factorisation and gradient a draw (the current point's pieces ride
in the chain state); the proposal and both densities are triangular solves
against the same factors.

The metric is batched: ``metric_fn((n_chains, d)) -> (n_chains, d, d)``, as
for :func:`mcmc_tpu_torch.rmhmc` (and :func:`mcmc_tpu_torch.softabs_metric`
gives one for any twice-differentiable target). Bounded problems run on the
box kernel with the exact unconstrained-space gradient; the metric is
evaluated at the unconstrained point.

JAX's Cholesky returns NaN where the metric is not positive definite, and
the JAX package turns that into a rejection. ``torch.linalg.cholesky``
raises instead (and reads its status back, a host synchronisation), so the
port factors with ``cholesky_ex`` and sets the factor to NaN on and below
the diagonal where the status is not 0, as JAX's is (the state carries the
factor, so its NaN pattern is JAX's too): a failed factorisation can leave
a finite factor behind. A factor that is not finite everywhere
rejects the proposal, as in JAX. The kernel is batched over chains and needs
no host synchronisation. A transition is a draw of its random numbers from
the run's one ``torch.Generator`` (``step.draw``: the proposal's normals and
the accept uniform) followed by a function of those draws
(``step.transition``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mcmc_tpu_torch import adaptation
from mcmc_tpu_torch.results import SamplerResult
from mcmc_tpu_torch.settings import MMALASettings
from mcmc_tpu_torch.samplers import common
from mcmc_tpu_torch.samplers._resolve import resolve_settings, resolve_key
from mcmc_tpu_torch.samplers.mala import _value_and_grad

__all__ = ["mmala", "MMALAState", "build_mmala_kernel"]


class MMALAState(NamedTuple):
    position: torch.Tensor   # (c, d)
    log_prob: torch.Tensor   # (c,)
    grad: torch.Tensor       # (c, d) box gradient at position
    chol: torch.Tensor       # (c, d, d) Cholesky factor of G(position)
    da: adaptation.DualAveraging
    draw_ind: torch.Tensor   # (c,) int32


def _solve_lower(L, v):
    return torch.linalg.solve_triangular(L, v[:, :, None],
                                         upper=False)[:, :, 0]


def _solve_upper_t(L, v):
    """``L^{-T} v`` for each chain."""
    return torch.linalg.solve_triangular(L.transpose(1, 2), v[:, :, None],
                                         upper=True)[:, :, 0]


def build_mmala_kernel(box, metric_fn, step_size, adapt_cfg=None):
    """Batched mMALA transition on the box log-kernel ``box`` and the
    batched ``metric_fn``: returns ``init(positions) -> MMALAState`` and
    ``step(gen, state) -> (state, info)``; ``adapt_cfg`` (``n_burnin``,
    ``target``) turns on dual averaging of the step size.
    ``step.draw(gen, state) -> (xi, u)`` and ``step.transition(state, xi,
    u)`` are its two halves; ``step.counts`` tallies draws, gradients,
    metric evaluations and host synchronisations (none)."""
    box_vg = _value_and_grad(box)
    counts = {"draws": 0, "gradients": 0, "metrics": 0, "syncs": 0}
    lower_on = {}   # each device's lower-triangle mask

    def eval_point(z):
        lp, g = box_vg(z)
        lp = torch.where(torch.isfinite(lp), lp, -torch.inf)
        g = torch.where(torch.isfinite(g), g, 0.0)
        G = metric_fn(z)
        G = 0.5 * (G + G.transpose(1, 2))
        counts["gradients"] += 1
        counts["metrics"] += 1
        L, info = torch.linalg.cholesky_ex(G)
        lower = lower_on.get(L.device)
        if lower is None:
            lower = lower_on[L.device] = torch.ones(
                L.shape[-2:], dtype=torch.bool, device=L.device).tril()
        return lp, g, torch.where((info != 0)[:, None, None] & lower,
                                  torch.nan, L)

    def mean_of(z, g, L, eps2):
        # G^{-1} g by two triangular solves against L
        return z + 0.5 * common.chain_col(eps2) * _solve_upper_t(
            L, _solve_lower(L, g))

    def log_q(y, mu, L, eps):
        # N(y; mu, eps^2 G^{-1}): logdet(eps^2 G^{-1}) = 2 d log eps
        #   - 2 sum log diag L; quad = |L^T (y - mu)|^2 / eps^2
        d = y.shape[-1]
        r = (L.transpose(1, 2) @ (y - mu)[:, :, None])[:, :, 0] \
            / common.chain_col(eps)
        log_eps = torch.log(eps) if torch.is_tensor(eps) else math.log(eps)
        return (torch.log(torch.diagonal(L, dim1=1, dim2=2)).sum(dim=-1)
                - d * log_eps - 0.5 * d * math.log(2 * math.pi)
                - 0.5 * (r * r).sum(dim=-1))

    def init(position):
        c = position.shape[0]
        lp, g, L = eval_point(position)
        return MMALAState(
            position=position, log_prob=lp, grad=g, chol=L,
            da=adaptation.da_init(torch.full((c,), float(step_size),
                                             dtype=position.dtype,
                                             device=position.device)),
            draw_ind=torch.zeros((c,), dtype=torch.int32,
                                 device=position.device))

    def draw(gen, state: MMALAState):
        pos = state.position
        kw = {"generator": gen, "dtype": pos.dtype, "device": pos.device}
        return torch.randn(pos.shape, **kw), torch.rand(pos.shape[:1], **kw)

    def transition(state: MMALAState, xi, u):
        pos = state.position
        if adapt_cfg is None:
            eps = step_size
        else:
            adapting = state.draw_ind < adapt_cfg["n_burnin"]
            eps = torch.exp(torch.where(adapting, state.da.log_eps,
                                        state.da.log_eps_bar))
        eps2 = eps * eps
        counts["draws"] += 1

        mu = mean_of(pos, state.grad, state.chol, eps2)
        # a draw of N(mu, eps^2 G^{-1}): the square root is eps L^{-T}
        proposal = mu + common.chain_col(eps) * _solve_upper_t(state.chol, xi)

        prop_lp, prop_g, prop_L = eval_point(proposal)
        prop_ok = torch.isfinite(prop_L).all(dim=-1).all(dim=-1)
        eye = torch.eye(pos.shape[1], dtype=pos.dtype, device=pos.device)
        safe_L = torch.where(prop_ok[:, None, None], prop_L, eye)
        mu_rev = mean_of(proposal, prop_g, safe_L, eps2)

        adj = log_q(pos, mu_rev, safe_L, eps) \
            - log_q(proposal, mu, state.chol, eps)
        comp = torch.clamp_max(prop_lp - state.log_prob + adj, 0.0)
        comp = torch.where(torch.isnan(comp) | ~prop_ok, -torch.inf, comp)
        accepted = torch.log(u) < comp

        da = state.da
        if adapt_cfg is not None:
            da_new = adaptation.da_update(da, torch.exp(comp),
                                          adapt_cfg["target"])
            da = adaptation.DualAveraging(*[torch.where(adapting, new, old)
                                            for new, old in zip(da_new, da)])

        new_state = MMALAState(
            position=common.where_chains(accepted, proposal, pos),
            log_prob=torch.where(accepted, prop_lp, state.log_prob),
            grad=common.where_chains(accepted, prop_g, state.grad),
            chol=common.where_chains(accepted, safe_L, state.chol),
            da=da, draw_ind=state.draw_ind + 1)
        return new_state, {"accepted": accepted}

    def step(gen, state: MMALAState):
        return transition(state, *draw(gen, state))

    step.draw, step.transition, step.counts = draw, transition, counts
    return init, step


def mmala(initial_vals, log_kernel, metric_fn, settings=None, *,
          n_chains=None, key=None, mesh=None, checkpoint_dir=None,
          checkpoint_every=500, dtype=None, adapt_step_size=False,
          target_accept=None, thin=1, return_resume=False,
          device=None) -> SamplerResult:
    """Run simplified manifold MALA (module docstring). ``log_kernel`` is
    batched: ``(n_chains, n_vals) -> (n_chains,)``; ``metric_fn`` maps
    ``(n_chains, n_vals) -> (n_chains, n_vals, n_vals)``, an SPD metric at
    each (unconstrained) point. ``adapt_step_size=True`` dual-averages
    toward 0.574 acceptance during burn-in. ``key`` is a
    ``torch.Generator`` or an integer seed; ``device`` defaults to that of
    ``initial_vals``, else the card. ``mesh`` is not ported yet and raises;
    ``checkpoint_dir`` runs in restartable chunks
    (:mod:`mcmc_tpu_torch.checkpoint`)."""
    algo, s = resolve_settings(settings, "mmala_settings", MMALASettings)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")
    if not callable(metric_fn):
        raise TypeError(
            f"metric_fn must be callable (z -> SPD matrix); got "
            f"{type(metric_fn).__name__}")

    prob = common.setup_problem(initial_vals, log_kernel, algo, n_chains,
                                dtype, device)
    gen = resolve_key(key, algo, prob.device)
    adapt_cfg = None
    if adapt_step_size:
        adapt_cfg = {"n_burnin": s.n_burnin_draws,
                     "target": target_accept
                     or adaptation.TARGET_ACCEPT["mala"]}
    init, step = build_mmala_kernel(prob.box_log_kernel, metric_fn,
                                    s.step_size, adapt_cfg)
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
