"""Metropolis-adjusted Langevin algorithm (PyTorch port of
``mcmc_tpu.samplers.mala``).

Reference src/mala.cpp:30-235 + include/mcmc/mala.ipp: drift
``mu(z) = z + eps^2/2 * M * grad logK`` (src/mala.cpp:97-125), proposal
``mu + eps * chol(M) * xi`` (src/mala.cpp:149-160), and an MH correction with
the proposal-asymmetry term computed from two MVN log-densities
(mala.ipp:30-70). Carried over unchanged from the JAX package:

- the accept clamp ``min(0.01, .)`` (src/mala.cpp:170);
- ``bounded_grad="reference"`` (the default): the user's gradient is taken
  at the constrained point and chained by the diagonal inverse Jacobian,
  and the *proposal's* inverse Jacobian appears in both asymmetry terms
  (mala.ipp:48-57). That makes the MH ratio inconsistent with the actual
  proposal, a measurable stationary bias (truncated N(1, 1) at 0: mean
  1.40 against the true 1.288); ``bounded_grad="exact"`` is the corrected
  mode;
- with a dense user ``precond_mat`` in reference mode the proposal
  covariance ``eps^2 J M`` is not symmetric, and the asymmetry term is the
  reference's general solve with ``slogdet`` (:func:`_log_mvn_general`);
- with ``adapt_precond="dense"`` the asymmetry term is two triangular solves
  against the carried Cholesky factor (the log-dets cancel).

The gradient at the current point is carried in the chain state, so each
draw costs one autograd gradient of the target. The kernel is batched over
chains, every MVN term batched over them too, and needs no host
synchronisation. A transition is a draw of its random numbers from the
run's one ``torch.Generator`` (``step.draw``: the proposal's normals and the
accept uniform) followed by a function of those draws
(``step.transition``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mcmc_tpu_torch import adaptation
from mcmc_tpu_torch import bounds as bounds_mod
from mcmc_tpu_torch import stats
from mcmc_tpu_torch.results import SamplerResult
from mcmc_tpu_torch.settings import MALASettings
from mcmc_tpu_torch.samplers import common
from mcmc_tpu_torch.samplers._resolve import resolve_settings, resolve_key

__all__ = ["mala", "MALAState", "build_mala_kernel"]


class MALAState(NamedTuple):
    position: torch.Tensor   # (c, d)
    log_prob: torch.Tensor   # (c,)
    grad: torch.Tensor       # (c, d) raw target gradient at position
                             # (constrained-space user gradient in reference
                             # mode, box gradient else)
    jac: torch.Tensor        # (c, d) inv-Jacobian diagonal (ones when unused)
    da: adaptation.DualAveraging       # (c,) each
    wv: adaptation.WindowedVariance    # preconditioner adaptation (diag)
    pM: torch.Tensor         # (c, d, d) dense learned preconditioner; (c, 1)
    pchol: torch.Tensor      # (c, d, d) its Cholesky; (c, 1)
    pm2: torch.Tensor        # (c, d, d) dense outer-product sums; (c, 1)
    draw_ind: torch.Tensor   # (c,) int32


def _log_mvn_general(x, mu, sigma):
    """MVN log-density of each row on a general (possibly asymmetric)
    matrix ``sigma`` ``(c, k, k)`` via an explicit solve and ``slogdet``:
    the bounded dense-preconditioner path builds ``eps^2 J M``, which is not
    symmetric, and the reference evaluates dmvnorm on it directly
    (mala.ipp:54-57, dmvnorm.hpp:28-54); a Cholesky would read only its
    lower triangle. Quirk reproduced."""
    cent = x - mu
    k = x.shape[-1]
    sol = torch.linalg.solve_ex(sigma, cent[..., None])[0][..., 0]
    quad = (cent * sol).sum(dim=-1)
    _sign, logdet = torch.linalg.slogdet(sigma)
    return -0.5 * k * stats.LOG_2PI - 0.5 * (logdet + quad)


def _value_and_grad(log_kernel):
    """``vg(z) -> (log_kernel(z), its gradient)`` per chain from one
    autograd pass of the batched log-kernel's sum."""
    def vg(z):
        with torch.enable_grad():
            zz = z.detach().requires_grad_(True)
            val = log_kernel(zz)
            (g,) = torch.autograd.grad(val.sum(), zz, allow_unused=True)
        return val.detach(), torch.zeros_like(z) if g is None else g
    return vg


def build_mala_kernel(prob: common.Problem, precond: common.SPD, step_size,
                      bounded_grad="reference", adapt_cfg=None,
                      precond_cfg=None):
    """Batched MALA transition: returns ``init(positions) -> MALAState``
    and ``step(gen, state) -> (state, info)``; ``adapt_cfg`` and
    ``precond_cfg`` as for :func:`~mcmc_tpu_torch.samplers.rwmh.
    build_rwmh_kernel`. ``step.draw(gen, state) -> (noise, u)`` and
    ``step.transition(state, noise, u)`` are its two halves;
    ``step.counts`` tallies draws, gradients and host synchronisations
    (none)."""
    reference_mode = prob.vals_bound and bounded_grad == "reference"
    adapt_m = precond_cfg is not None
    dense = adapt_m and precond_cfg.get("mode") == "dense"
    bnds = (prob.codes, prob.lower_bounds, prob.upper_bounds)
    counts = {"draws": 0, "gradients": 0, "syncs": 0}

    if reference_mode:
        user_vg = _value_and_grad(prob.log_kernel)

        def eval_point(z):
            """(box_log_prob, raw gradient, jac) at each row of z."""
            val, grad_x = user_vg(bounds_mod.inv_transform(z, *bnds))
            counts["gradients"] += 1
            lp = val + bounds_mod.log_jacobian(z, *bnds)
            return lp, grad_x, bounds_mod.inv_jacobian_diag(z, *bnds)
    else:
        box_vg = _value_and_grad(prob.box_log_kernel)

        def eval_point(z):
            val, grad_z = box_vg(z)
            counts["gradients"] += 1
            return val, grad_z, torch.ones_like(z)

    def kick_of(grad, jac, pvar, pM):
        """Drift direction J * (M @ grad); M is the fixed preconditioner or
        the adapted diagonal/dense covariance."""
        if dense:
            mg = (pM @ grad[:, :, None])[:, :, 0]
        elif adapt_m:
            mg = pvar * grad
        else:
            mg = precond.mv(grad)
        return jac * mg if reference_mode else mg

    def prop_sigma(jac, eps2, pvar):
        """Each chain's proposal covariance eps^2 * J * M, as a ``(c, d)``
        diagonal or a ``(c, d, d)`` matrix. (The dense mode never calls
        this: its asymmetry term comes from the carried Cholesky.)"""
        if adapt_m:
            return common.chain_col(eps2) * jac * pvar
        if precond.kind == "identity":
            return common.chain_col(eps2) * jac
        if precond.kind == "diag":
            return common.chain_col(eps2) * jac * precond.mat
        e2 = eps2[:, None, None] if torch.is_tensor(eps2) else eps2
        return e2 * jac[:, :, None] * precond.mat

    def init(position):
        c, dim = position.shape
        kw = {"dtype": position.dtype, "device": position.device}
        lp, grad, jac = eval_point(position)
        eye = torch.eye(dim, **kw).expand(c, dim, dim)
        return MALAState(
            position=position, log_prob=lp, grad=grad, jac=jac,
            da=adaptation.da_init(torch.full((c,), float(step_size), **kw)),
            wv=adaptation.wv_init(dim, position.dtype, c, position.device),
            pM=eye.clone() if dense else torch.ones((c, 1), **kw),
            pchol=eye.clone() if dense else torch.ones((c, 1), **kw),
            pm2=(torch.zeros((c, dim, dim), **kw) if dense
                 else torch.ones((c, 1), **kw)),
            draw_ind=torch.zeros((c,), dtype=torch.int32,
                                 device=position.device),
        )

    def draw(gen, state: MALAState):
        pos = state.position
        kw = {"generator": gen, "dtype": pos.dtype, "device": pos.device}
        return torch.randn(pos.shape, **kw), torch.rand(pos.shape[:1], **kw)

    def transition(state: MALAState, noise, u):
        pos = state.position
        if adapt_cfg is None:
            eps = step_size
        else:
            adapting = state.draw_ind < adapt_cfg["n_burnin"]
            eps = torch.exp(torch.where(adapting, state.da.log_eps,
                                        state.da.log_eps_bar))
        eps2 = eps * eps
        pvar = state.wv.var
        counts["draws"] += 1

        prev_mean = pos + 0.5 * common.chain_col(eps2) * kick_of(
            state.grad, state.jac, pvar, state.pM)
        if dense:
            scaled = (state.pchol @ noise[:, :, None])[:, :, 0]
        elif adapt_m:
            scaled = torch.sqrt(pvar) * noise
        else:
            scaled = precond.sqrt_mv(noise)
        if reference_mode:
            scaled = torch.sqrt(state.jac) * scaled
        proposal = prev_mean + common.chain_col(eps) * scaled

        prop_lp, prop_grad, prop_jac = eval_point(proposal)
        prop_lp = torch.where(torch.isfinite(prop_lp), prop_lp, -torch.inf)
        prop_mean = proposal + 0.5 * common.chain_col(eps2) * kick_of(
            prop_grad, prop_jac, pvar, state.pM)

        # mala_prop_adjustment (reference mala.ipp:30-70): both covariance
        # terms use the proposal's Jacobian, as in the reference
        if dense:
            # sigma = eps^2 pM is symmetric PD (dense adaptation is
            # unbounded-only) and its Cholesky eps * pchol is in the state;
            # the two log-dets cancel, leaving two triangular solves
            r_back = torch.linalg.solve_triangular(
                state.pchol, (pos - prop_mean)[:, :, None],
                upper=False)[:, :, 0] / common.chain_col(eps)
            r_fwd = torch.linalg.solve_triangular(
                state.pchol, (proposal - prev_mean)[:, :, None],
                upper=False)[:, :, 0] / common.chain_col(eps)
            adj = 0.5 * ((r_fwd * r_fwd).sum(dim=-1)
                         - (r_back * r_back).sum(dim=-1))
        elif reference_mode and precond.kind == "full" and not adapt_m:
            # eps^2 J M is asymmetric; evaluate it the reference's way
            sigma = prop_sigma(prop_jac, eps2, pvar)
            adj = _log_mvn_general(pos, prop_mean, sigma) \
                - _log_mvn_general(proposal, prev_mean, sigma)
        else:
            sigma = prop_sigma(prop_jac, eps2, pvar)
            adj = stats.dmvnorm(pos, prop_mean, sigma, log=True,
                                batched=True) \
                - stats.dmvnorm(proposal, prev_mean, sigma, log=True,
                                batched=True)

        comp = torch.clamp_max(prop_lp - state.log_prob + adj, 0.01)
        accepted = u < torch.exp(comp)
        new_position = common.where_chains(accepted, proposal, pos)

        da = state.da
        if adapt_cfg is not None:
            accept_stat = torch.clamp_max(torch.exp(comp), 1.0)
            accept_stat = torch.where(torch.isnan(accept_stat), 0.0,
                                      accept_stat)
            da_new = adaptation.da_update(da, accept_stat,
                                          adapt_cfg["target"])
            da = adaptation.DualAveraging(*[torch.where(adapting, new, old)
                                            for new, old in zip(da_new, da)])

        wv, pM, pchol, pm2 = state.wv, state.pM, state.pchol, state.pm2
        if adapt_m and not dense:
            wv, da = adaptation.windowed_precond_step(
                wv, da, new_position, state.draw_ind, precond_cfg,
                reset_da=adapt_cfg is not None)
        elif dense:
            wv, da, pM, pchol, pm2 = adaptation.windowed_dense_step(
                wv, da, pM, pchol, pm2, new_position, state.draw_ind,
                precond_cfg, reset_da=adapt_cfg is not None)

        new_state = MALAState(
            position=new_position,
            log_prob=torch.where(accepted, prop_lp, state.log_prob),
            grad=common.where_chains(accepted, prop_grad, state.grad),
            jac=common.where_chains(accepted, prop_jac, state.jac),
            da=da, wv=wv, pM=pM, pchol=pchol, pm2=pm2,
            draw_ind=state.draw_ind + 1,
        )
        return new_state, {"accepted": accepted}

    def step(gen, state: MALAState):
        return transition(state, *draw(gen, state))

    step.draw, step.transition, step.counts = draw, transition, counts
    return init, step


def mala(initial_vals, log_kernel, settings=None, *, n_chains=None, key=None,
         mesh=None, checkpoint_dir=None, checkpoint_every=500, dtype=None,
         bounded_grad="reference", adapt_step_size=False,
         adapt_precond=False, pooled_adaptation=False, target_accept=None,
         thin=1, return_resume=False, device=None) -> SamplerResult:
    """Run MALA (module docstring). ``log_kernel`` is batched: ``(n_chains,
    n_vals) -> (n_chains,)``.

    ``adapt_step_size=True`` tunes the step size toward 0.574 acceptance
    during burn-in; ``adapt_precond=True`` (or ``"diag"`` / ``"dense"``)
    learns the preconditioner (drift **and** proposal covariance) from
    windowed Welford estimates, pooled across chains with
    ``pooled_adaptation``; incompatible with a user ``precond_mat``, and
    ``"dense"`` is unbounded-only. ``return_resume=True`` attaches
    ``diagnostics["resume"](key, n_keep)``. ``key`` is a ``torch.Generator``
    or an integer seed; ``device`` defaults to that of ``initial_vals``,
    else the card. ``mesh`` is not ported yet and raises; ``checkpoint_dir``
    runs in restartable chunks (:mod:`mcmc_tpu_torch.checkpoint`)."""
    algo, s = resolve_settings(settings, "mala_settings", MALASettings)
    if bounded_grad not in ("reference", "exact"):
        raise ValueError(f"bounded_grad must be 'reference' or 'exact', "
                         f"got {bounded_grad!r}")
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")

    prob = common.setup_problem(initial_vals, log_kernel, algo, n_chains,
                                dtype, device)
    gen = resolve_key(key, algo, prob.device)
    precond = common.make_spd(s.precond_mat, prob.n_vals, prob.dtype,
                              prob.device)
    if adapt_precond and s.precond_mat is not None:
        raise ValueError("adapt_precond is incompatible with a user "
                         "precond_mat — the preconditioner is learned")

    adapt_cfg = None
    if adapt_step_size:
        adapt_cfg = {
            "n_burnin": s.n_burnin_draws,
            "target": target_accept or adaptation.TARGET_ACCEPT["mala"],
        }
    precond_cfg = None
    if adapt_precond:
        mode = {True: "diag"}.get(adapt_precond, adapt_precond)
        if mode not in ("diag", "dense"):
            raise ValueError(f"adapt_precond must be False/True/'diag'/"
                             f"'dense', got {adapt_precond!r}")
        if mode == "dense" and algo.vals_bound:
            raise ValueError("adapt_precond='dense' is unbounded-only "
                             "(the bounded dense proposal matrix is "
                             "asymmetric; use 'diag' with bounds)")
        precond_cfg = adaptation.make_precond_cfg(
            s.n_burnin_draws, pooled_adaptation, prob.device)
        precond_cfg["mode"] = mode
    init, step = build_mala_kernel(prob, precond, s.step_size, bounded_grad,
                                   adapt_cfg, precond_cfg)
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
        if adapt_step_size:
            diagnostics["adapted_step_size"] = torch.exp(
                final_state.da.log_eps_bar)
        if adapt_precond:
            diagnostics["precond_var"] = final_state.wv.var \
                if precond_cfg["mode"] == "diag" else final_state.pM
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
