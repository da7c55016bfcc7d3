"""Riemannian-manifold HMC with the fixed-point generalized leapfrog
(PyTorch port of ``mcmc_tpu.samplers.rmhmc``).

Reference src/rmhmc.cpp:30-325. The user supplies a batched
``metric_fn(params (c, d)) -> (c, d, d)``, the position-dependent metric G;
the derivative cube the reference requires by hand (``Cube_t*
tensor_deriv_out``, examples/eigen/rmhmc_normal.cpp:78-111) is ``d`` calls
of ``torch.func.jvp(metric_fn, (x,), (e_i,))`` with the basis vector
broadcast over the chains, stacked as ``(c, i, a, b) = dG_ab / dx_i``.

As in the JAX package (src/rmhmc.cpp:199-238):

- ``n_fp_steps`` fixed-point iterations for the implicit momentum half-step
  and for the implicit position step that averages ``G^{-1}`` at the old and
  new positions;
- the Hamiltonian includes ``0.5 d log(2 pi) + 0.5 log|G|``
  (src/rmhmc.cpp:188-190) and acceptance is clamped ``min(0.01, .)``;
- momentum is refreshed as ``chol(G(theta)) @ xi`` (src/rmhmc.cpp:202);
- reference quirk: within a multi-step trajectory the first half-kick and
  the position fixed point use the tensor of the trajectory *start*
  (``inv_prev_tensor`` is only updated on acceptance,
  src/rmhmc.cpp:213-228), the final half-kick the fresh tensor at the new
  position (:232-237);
- Deviation (bug fix): the reference's momentum update *adds*
  ``eps/2 * dH/dtheta`` (src/rmhmc.cpp:213-215), which integrates no
  Hamiltonian for more than one leapfrog; the kick here subtracts, the
  standard Girolami-Calderhead generalized leapfrog.

The kernel is batched over chains; its inverses, Cholesky factors and
log-determinants are batched ``inv_ex``, ``cholesky_ex`` and ``slogdet``
calls, none of which reads a result back to the host. A metric whose
evaluation syncs (SoftAbs's ``eigh``) makes the kernel sync as often as it
evaluates the metric (``step.counts["metric_evaluations"]``). A transition
is a draw of its random numbers from the run's one ``torch.Generator``
(``step.draw``: the momentum's normals and the accept uniform) followed by a
function of those draws (``step.transition``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mcmc_tpu_torch import bounds as bounds_mod
from mcmc_tpu_torch import integrators
from mcmc_tpu_torch.results import SamplerResult
from mcmc_tpu_torch.settings import RMHMCSettings
from mcmc_tpu_torch.stats import LOG_2PI, cholesky_or_nan
from mcmc_tpu_torch.samplers import common
from mcmc_tpu_torch.samplers._resolve import resolve_settings, resolve_key

__all__ = ["rmhmc", "RMHMCState", "build_rmhmc_kernel"]


class RMHMCState(NamedTuple):
    position: torch.Tensor      # (c, d) unconstrained coordinates
    potential: torch.Tensor     # (c,) U incl. 0.5 log|G| and the 2pi constant
    tensor: torch.Tensor        # (c, d, d) G at position
    inv_tensor: torch.Tensor    # (c, d, d) G^{-1}
    chol_tensor: torch.Tensor   # (c, d, d) chol(G), for the momentum refresh
    deriv: torch.Tensor         # (c, d, d, d) dG/dtheta_i on axis 1


def _mv(m, v):
    """Each chain's matrix times its vector: ``(c, a, b) x (c, b)``."""
    return (m @ v[:, :, None])[:, :, 0]


def build_rmhmc_kernel(prob: common.Problem, metric_fn, cfg: RMHMCSettings):
    """Batched RM-HMC transition: returns ``init(positions) -> RMHMCState``
    and ``step(gen, state) -> (state, info)``. ``step.draw(gen, state) ->
    (noise, u)`` and ``step.transition(state, noise, u)`` are its two
    halves; ``step.counts`` tallies draws, leapfrogs and the metric's
    evaluations (each derivative JVP evaluates it once)."""
    dim = prob.n_vals
    cons_term = 0.5 * dim * LOG_2PI
    eps = cfg.step_size
    n_leap, n_fp = int(cfg.n_leap_steps), int(cfg.n_fp_steps)
    bnds = (prob.codes, prob.lower_bounds, prob.upper_bounds)
    user_grad = integrators.grad_of(prob.log_kernel)
    counts = {"draws": 0, "leapfrogs": 0, "metric_evaluations": 0}

    def to_constrained(z):
        if prob.vals_bound:
            return bounds_mod.inv_transform(z, *bnds)
        return z

    def box_tensor(z):
        """G and dG at the constrained point (reference src/rmhmc.cpp:
        152-165: the metric and its derivatives are the user's, evaluated
        at x, no Jacobian chaining): ``(c, d, d)`` and ``(c, i, a, b)``."""
        x = to_constrained(z)
        eye = torch.eye(dim, dtype=x.dtype, device=x.device)
        g, cols = None, []
        for i in range(dim):
            g, dg = torch.func.jvp(metric_fn, (x,), (eye[i].expand_as(x),))
            cols.append(dg)
        counts["metric_evaluations"] += dim
        return g, torch.stack(cols, dim=1)

    def box_tensor_only(z):
        counts["metric_evaluations"] += 1
        return metric_fn(to_constrained(z))

    def inv(m):
        return torch.linalg.inv_ex(m)[0]

    def potential_at(z, tensor):
        return cons_term - prob.box_log_kernel(z) \
            + 0.5 * torch.linalg.slogdet(tensor)[1]

    def grad_at(z):
        """The user gradient at the constrained point of ``z`` and, bounded,
        the inverse-Jacobian diagonal that chains it."""
        jac = bounds_mod.inv_jacobian_diag(z, *bnds) if prob.vals_bound \
            else None
        return user_grad(to_constrained(z)), jac

    def tensor_terms(inv_tensor, deriv):
        """``(G^-1, G^-1 dG_i, their traces)``: the kick's terms that depend
        on the tensor only."""
        tmp = inv_tensor[:, None] @ deriv          # (c, i, a, b) G^-1 dG_i
        return inv_tensor, tmp, torch.diagonal(tmp, dim1=-2,
                                               dim2=-1).sum(dim=-1)

    def mntm_update_fn(at_z, terms):
        """``p -> -eps/2 * (J *) dH/dtheta`` at the point whose
        ``grad_at`` is ``at_z``, with the tensor's ``terms`` (reference
        src/rmhmc.cpp:100-148, with the sign corrected, module docstring);
        everything but ``p`` is computed once for the fixed-point
        iterations."""
        grad_x, jac = at_z
        inv_tensor, tmp, trace = terms

        def update(p):
            w = _mv(inv_tensor, p)
            # p^T G^-1 dG_i G^-1 p for each i
            quad = (p[:, None, :] * (tmp @ w[:, None, :, None])[..., 0]
                    ).sum(dim=-1)
            grad_vec = -grad_x + 0.5 * (trace - quad)
            if jac is not None:
                grad_vec = jac * grad_vec
            return -0.5 * eps * grad_vec

        return update

    def init(position):
        with torch.no_grad():
            tensor, deriv = box_tensor(position)
            return RMHMCState(
                position=position,
                potential=potential_at(position, tensor),
                tensor=tensor,
                inv_tensor=inv(tensor),
                chol_tensor=cholesky_or_nan(tensor),
                deriv=deriv,
            )

    def draw(gen, state: RMHMCState):
        pos = state.position
        kw = {"generator": gen, "dtype": pos.dtype, "device": pos.device}
        return torch.randn(pos.shape, **kw), torch.rand(pos.shape[:1], **kw)

    def transition(state: RMHMCState, noise, u):
        momentum = _mv(state.chol_tensor, noise)
        prev_K = 0.5 * (momentum * _mv(state.inv_tensor, momentum)).sum(-1)
        counts["draws"] += 1

        z, p = state.position, momentum
        # the new point's tensor, derivative and inverse: the last
        # leapfrog's final half-kick computes them (the start's without one);
        # likewise each leapfrog's start gradient is the one its predecessor
        # ended with, at the same point
        fresh, at_z = None, grad_at(z)
        start_terms = tensor_terms(state.inv_tensor, state.deriv)
        for _ in range(n_leap):
            # implicit momentum half-step: n_fp fixed-point iterations with
            # the trajectory-start tensor (reference quirk, module doc)
            update = mntm_update_fn(at_z, start_terms)
            p_new = p
            for _ in range(n_fp):
                p_new = p + update(p_new)
            # implicit position step averaging the inverse tensors
            z_new = z
            for _ in range(n_fp):
                inv_new = inv(box_tensor_only(z_new))
                z_new = z + 0.5 * eps * _mv(state.inv_tensor + inv_new, p_new)
            # final explicit momentum half-step with the fresh tensor
            tensor_new, deriv_new = box_tensor(z_new)
            inv_new = inv(tensor_new)
            at_z = grad_at(z_new)
            p = p_new + mntm_update_fn(
                at_z, tensor_terms(inv_new, deriv_new))(p_new)
            z = z_new
            fresh = (tensor_new, deriv_new, inv_new)
            counts["leapfrogs"] += 1
        if fresh is None:
            tensor_new, deriv_new = box_tensor(z)
            fresh = (tensor_new, deriv_new, inv(tensor_new))
        new_tensor, new_deriv, new_inv = fresh

        prop_U = potential_at(z, new_tensor)
        prop_U = torch.where(torch.isfinite(prop_U), prop_U, torch.inf)
        prop_K = 0.5 * (p * _mv(new_inv, p)).sum(-1)

        comp = torch.clamp_max(-(prop_U + prop_K)
                               + (state.potential + prev_K), 0.01)
        accepted = u < torch.exp(comp)

        def pick(a, b):
            return common.where_chains(accepted, a, b)

        new_state = RMHMCState(
            position=pick(z, state.position),
            potential=pick(prop_U, state.potential),
            tensor=pick(new_tensor, state.tensor),
            inv_tensor=pick(new_inv, state.inv_tensor),
            chol_tensor=pick(cholesky_or_nan(new_tensor), state.chol_tensor),
            deriv=pick(new_deriv, state.deriv),
        )
        return new_state, {"accepted": accepted}

    def step(gen, state: RMHMCState):
        return transition(state, *draw(gen, state))

    step.draw, step.transition, step.counts = draw, transition, counts
    return init, step


def rmhmc(initial_vals, log_kernel, metric_fn, settings=None, *,
          n_chains=None, key=None, mesh=None, checkpoint_dir=None,
          checkpoint_every=500, dtype=None, thin=1, return_resume=False,
          device=None) -> SamplerResult:
    """Run RM-HMC (module docstring). ``log_kernel`` is batched:
    ``(n_chains, n_vals) -> (n_chains,)``; ``metric_fn(params (n_chains,
    n_vals)) -> (n_chains, n_vals, n_vals)`` is the SPD metric in
    constrained space (:func:`mcmc_tpu_torch.models.normal_fisher_metric`,
    :func:`mcmc_tpu_torch.softabs_metric`), differentiable by
    ``torch.func.jvp``. ``return_resume=True`` attaches
    ``diagnostics["resume"](key, n_keep)``. ``key`` is a ``torch.Generator``
    or an integer seed; ``device`` defaults to that of ``initial_vals``,
    else the card. ``mesh`` is not ported yet and raises; ``checkpoint_dir``
    runs in restartable chunks (:mod:`mcmc_tpu_torch.checkpoint`)."""
    algo, s = resolve_settings(settings, "rmhmc_settings", RMHMCSettings)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")

    prob = common.setup_problem(initial_vals, log_kernel, algo, n_chains,
                                dtype, device)
    gen = resolve_key(key, algo, prob.device)
    init, step = build_rmhmc_kernel(prob, metric_fn, s)
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
        if prob.squeeze:
            draws = draws[:, 0, :]
            n_accept = n_accept[0]
        diagnostics = {"thin": int(thin)} if thin > 1 else {}
        return SamplerResult(draws=draws, n_accept_draws=n_accept,
                             diagnostics=diagnostics), final_state

    result, final_state = assemble(gen, state0, s.n_burnin_draws,
                                   s.n_keep_draws)
    if return_resume:
        common.attach_resume(result, assemble, final_state)
    return result
