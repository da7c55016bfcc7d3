"""Stochastic-gradient MCMC: SGLD (Welling & Teh 2011), pSGLD (Li et al.
2016) and SGHMC (Chen, Fox & Guestrin 2014); PyTorch port of
``mcmc_tpu.samplers.sgld``.

SGLD's update (one draw)::

    g_t  = grad log_prior(x_t) + (N / B) grad log_lik(x_t, minibatch_t)
    x_+  = x_t + (h_t / 2) M g_t + sqrt(h_t) chol(M) xi,  xi ~ N(0, I)

with ``h_t = step_size (decay_b / (decay_b + t)) ** decay_gamma``; pSGLD
replaces M by the RMSprop preconditioner ``1 / (lambda + sqrt(V))``; SGHMC
is the SGD-with-momentum form ``v <- (1 - alpha) v + eta g + N(0, 2 (alpha -
beta_hat) eta)``, ``x <- x + v``. No Metropolis correction. A draw whose
update is not finite (position, or pSGLD's accumulator, or SGHMC's
momentum) is rejected in place: the chain stays put and ``accepted`` is
False, so ``accept_rate`` is the share of finite updates. Bounded problems
run on the unconstrained coordinates, the N/B scaling applied to the
likelihood's gradient after the chain rule.

The likelihood is batched over chains: ``log_lik(theta: (c, d), batch) ->
(c,)``, the sum of the minibatch's log-likelihood terms for each chain,
where every leaf of ``batch`` has the shape ``(c, B, ...)``. ``data`` is a
tensor, or a tuple, list or dict of them, sharing the leading observation
axis; minibatches are drawn uniformly with replacement. In
``minibatch="per-chain"`` mode each chain draws its own ``B`` indices (one
``(c, B)`` gather a leaf); in ``"shared"`` mode one set of ``B`` indices
serves every chain (chain 0's index stream in the JAX package), gathered
once and ``expand``ed to ``(c, B, ...)`` without a copy.

The draw counter that drives the step-size schedule is a host integer, so
``h_t`` is a number on the host and the kernel needs no host
synchronisation. A transition is a draw of its random numbers from the
run's one ``torch.Generator`` (``step.draw``: the minibatch indices and the
injected normals) followed by a function of those draws
(``step.transition``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mcmc_tpu_torch import bounds as bounds_mod
from mcmc_tpu_torch.results import SamplerResult
from mcmc_tpu_torch.settings import SGHMCSettings, SGLDSettings
from mcmc_tpu_torch.samplers import common
from mcmc_tpu_torch.samplers._resolve import resolve_settings, resolve_key
from mcmc_tpu_torch.integrators import grad_of

__all__ = ["sgld", "sghmc", "SGLDState", "SGHMCState", "build_sgld_kernel",
           "build_sghmc_kernel", "gather_batch"]


def _leaves(data):
    if isinstance(data, dict):
        return list(data.values())
    if isinstance(data, (tuple, list)):
        return list(data)
    return [data]


def _map_data(fn, data):
    """``fn`` applied to each leaf of ``data`` (a tensor, or a tuple, list
    or dict of them), the container kept."""
    if isinstance(data, dict):
        return {k: fn(v) for k, v in data.items()}
    if isinstance(data, (tuple, list)):
        return type(data)(fn(v) for v in data)
    return fn(data)


def _validate_data(data, batch_size, dtype, device):
    """Data as tensors on ``device`` (floating leaves in ``dtype``), and the
    number of observations."""
    def to(a):
        t = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
        return t.to(device=device, dtype=dtype if t.is_floating_point()
                    else t.dtype)
    data = _map_data(to, data)
    leaves = _leaves(data)
    if not leaves:
        raise ValueError("data must contain at least one array")
    for a in leaves:
        if a.ndim == 0:
            raise ValueError(
                "every data leaf needs a leading observation axis (rank-0 "
                "leaf found); close the log_lik over scalar hyperparameters "
                "instead of putting them in data")
    n_data = leaves[0].shape[0]
    for a in leaves[1:]:
        if a.shape[0] != n_data:
            raise ValueError(
                f"all data leaves must share the leading observation axis; "
                f"got {a.shape[0]} vs {n_data}")
    if batch_size > n_data:
        raise ValueError(f"batch_size {batch_size} exceeds the dataset "
                         f"size {n_data}")
    return data, n_data


def gather_batch(data, idx, n_chains):
    """The minibatch of ``data`` at ``idx``: ``(c, B)`` indices, one set a
    chain, or ``(B,)`` indices shared by the chains, gathered once and
    expanded to ``(c, B, ...)`` without a copy."""
    idx = idx.long()
    if idx.ndim == 2:
        return _map_data(lambda a: a[idx], data)
    return _map_data(lambda a: a[idx].expand((n_chains,) + (idx.shape[0],)
                                             + tuple(a.shape[1:])), data)


def _check_minibatch(minibatch):
    if minibatch not in ("per-chain", "shared"):
        raise ValueError(f"minibatch must be 'per-chain' or 'shared', "
                         f"got {minibatch!r}")


def _make_grad_parts(prob, log_lik):
    """``(grad_prior(z), grad_lik(z, batch))``: the gradient of the prior
    with the log-Jacobian, and of the likelihood, in the unconstrained
    coordinates (callers scale the latter by N/B)."""
    def grad_lik(z, batch):
        def lik_z(zz):
            if prob.vals_bound:
                zz = bounds_mod.inv_transform(zz, prob.codes,
                                              prob.lower_bounds,
                                              prob.upper_bounds)
            return log_lik(zz, batch)
        return grad_of(lik_z)(z)
    return grad_of(prob.box_log_kernel), grad_lik


def _f32(x):
    """``x`` rounded as the JAX package rounds its f32 settings."""
    return float(np.float32(x))


class SGLDState(NamedTuple):
    position: torch.Tensor   # (c, d) unconstrained coordinates
    v: torch.Tensor          # (c, d) RMSprop accumulator; (c, 1) unused
    draw_ind: int            # host counter: drives the step-size schedule


def _draw_fn(n_data, batch_size, shared):
    def draw(gen, state):
        pos = state.position
        c = pos.shape[0]
        shape = (batch_size,) if shared else (c, batch_size)
        return (torch.randint(0, n_data, shape, generator=gen,
                              device=pos.device),
                torch.randn(pos.shape, generator=gen, dtype=pos.dtype,
                            device=pos.device))
    return draw


def build_sgld_kernel(prob: common.Problem, log_lik, data, n_data,
                      precond: common.SPD, s: SGLDSettings, rmsprop=False,
                      shared=False):
    """Batched SGLD / pSGLD transition: returns ``init(positions) ->
    SGLDState`` and ``step(gen, state) -> (state, info)``.
    ``step.draw(gen, state) -> (idx, noise)`` (``(c, B)`` indices, or
    ``(B,)`` with ``shared``, and ``(c, d)`` normals) and
    ``step.transition(state, idx, noise)`` are its two halves;
    ``step.counts`` tallies draws, gradients (two autograd passes a draw)
    and host synchronisations (none)."""
    B, N = int(s.batch_size), int(n_data)
    scale = _f32(N / B)
    h0, b, gamma = np.float32(s.step_size), np.float32(s.decay_b), \
        float(s.decay_gamma)
    alpha, lam = _f32(s.rmsprop_alpha), _f32(s.rmsprop_lambda)
    one_m_alpha = _f32(np.float32(1.0) - np.float32(s.rmsprop_alpha))
    grad_prior, grad_lik = _make_grad_parts(prob, log_lik)
    counts = {"draws": 0, "gradients": 0, "syncs": 0}

    def schedule(t):
        """``h_t`` in f32, as the JAX package computes it."""
        if not gamma:
            return h0
        return np.float32(h0 * (b / (b + np.float32(t)))
                          ** np.float32(gamma))

    def init(position):
        c, dim = position.shape
        kw = {"dtype": position.dtype, "device": position.device}
        v0 = torch.zeros((c, dim), **kw) if rmsprop \
            else torch.ones((c, 1), **kw)
        return SGLDState(position=position, v=v0, draw_ind=0)

    def transition(state: SGLDState, idx, noise):
        x = state.position
        h = schedule(state.draw_ind)
        batch = gather_batch(data, idx, x.shape[0])
        g = grad_prior(x) + scale * grad_lik(x, batch)
        counts["draws"] += 1
        counts["gradients"] += 2
        if rmsprop:
            gbar = g / N
            v = alpha * state.v + one_m_alpha * gbar * gbar
            G = 1.0 / (lam + torch.sqrt(v))
            prop = x + 0.5 * float(h) * G * g + torch.sqrt(float(h) * G) \
                * noise
        else:
            v = state.v
            prop = x + float(np.float32(0.5) * h) * precond.mv(g) \
                + float(np.sqrt(h)) * precond.sqrt_mv(noise)
        # the accumulator must pass the guard too: a finite but huge
        # gradient squares to inf in V, which makes G = 0, a silently
        # frozen coordinate on an otherwise finite draw
        ok = torch.isfinite(prop).all(dim=-1) & torch.isfinite(v).all(dim=-1)
        return (SGLDState(position=common.where_chains(ok, prop, x),
                          v=common.where_chains(ok, v, state.v),
                          draw_ind=state.draw_ind + 1),
                {"accepted": ok})

    draw = _draw_fn(N, B, shared)

    def step(gen, state):
        return transition(state, *draw(gen, state))

    step.draw, step.transition, step.counts = draw, transition, counts
    return init, step


def sgld(initial_vals, log_prior, log_lik, data, settings=None, *,
         n_chains=None, key=None, mesh=None, checkpoint_dir=None,
         checkpoint_every=500, dtype=None, thin=1, adapt_precond=False,
         minibatch="per-chain", return_resume=False,
         device=None) -> SamplerResult:
    """Run SGLD (module docstring). ``log_prior`` is batched, ``(c, d) ->
    (c,)``; ``log_lik(theta, batch) -> (c,)`` takes the chain batch and a
    minibatch whose leaves are ``(c, B, ...)``. ``minibatch`` is
    ``"per-chain"`` (each chain its own indices) or ``"shared"`` (one set of
    indices for every chain, one gather). ``adapt_precond=True`` (or
    ``"rmsprop"``) runs pSGLD; incompatible with a fixed ``precond_mat``.
    ``accept_rate`` is the share of finite updates (1.0 is healthy).
    ``key`` is a ``torch.Generator`` or an integer seed; ``device`` defaults
    to that of ``initial_vals``, else the card. ``mesh`` is not ported yet and
    raises; ``checkpoint_dir`` runs in restartable chunks
    (:mod:`mcmc_tpu_torch.checkpoint`)."""
    algo, s = resolve_settings(settings, "sgld_settings", SGLDSettings)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")
    if not callable(log_lik):
        raise TypeError("log_lik must be callable: log_lik(params, batch)")
    rmsprop = {True: "rmsprop"}.get(adapt_precond, adapt_precond)
    if rmsprop not in (False, "rmsprop"):
        raise ValueError(f"adapt_precond must be False/True/'rmsprop', "
                         f"got {adapt_precond!r}")
    if rmsprop and s.precond_mat is not None:
        raise ValueError("adapt_precond is incompatible with a user "
                         "precond_mat — the preconditioner is learned")
    _check_minibatch(minibatch)

    prob = common.setup_problem(initial_vals, log_prior, algo, n_chains,
                                dtype, device)
    data, n_data = _validate_data(data, s.batch_size, prob.dtype,
                                  prob.device)
    precond = common.make_spd(s.precond_mat, prob.n_vals, prob.dtype,
                              prob.device)
    kernel = build_sgld_kernel(prob, log_lik, data, n_data, precond, s,
                               rmsprop=bool(rmsprop),
                               shared=minibatch == "shared")
    return _drive_sg_mcmc(kernel, prob, algo, key, s.n_burnin_draws,
                          s.n_keep_draws, mesh, checkpoint_dir,
                          checkpoint_every, thin, return_resume)


def _drive_sg_mcmc(kernel, prob, algo, key, n_burnin, n_keep, mesh,
                   checkpoint_dir, checkpoint_every, thin, return_resume):
    """The SGLD / SGHMC driver's tail: init, run, assemble the result with
    the squeeze and thin conventions, attach the warm resume."""
    init, step = kernel
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
        if prob.squeeze:
            draws = draws[:, 0, :]
            n_accept = n_accept[0]
        if thin > 1:   # accept_rate divides by n_keep*thin
            diagnostics["thin"] = int(thin)
        return SamplerResult(draws=draws, n_accept_draws=n_accept,
                             diagnostics=diagnostics), final_state

    result, final_state = assemble(key, state0, n_burnin, n_keep)
    if return_resume:
        common.attach_resume(result, assemble, final_state)
    return result


class SGHMCState(NamedTuple):
    position: torch.Tensor   # (c, d) unconstrained coordinates
    momentum: torch.Tensor   # (c, d) the SGD-with-momentum velocity v
    draw_ind: int            # host counter


def build_sghmc_kernel(prob: common.Problem, log_lik, data, n_data,
                       s: SGHMCSettings, shared=False):
    """Batched SGHMC transition in the paper's SGD-with-momentum form
    (Chen, Fox & Guestrin 2014, eq. 15; module docstring): ``init``,
    ``step``, ``step.draw(gen, state) -> (idx, noise)``,
    ``step.transition(state, idx, noise)`` and ``step.counts`` as for
    :func:`build_sgld_kernel`."""
    B, N = int(s.batch_size), int(n_data)
    scale = _f32(N / B)
    eta = _f32(s.step_size)
    one_m_alpha = _f32(np.float32(1.0) - np.float32(s.friction_alpha))
    noise_sd = float(np.sqrt(np.float32(max(
        2.0 * (s.friction_alpha - s.beta_hat) * s.step_size, 0.0))))
    grad_prior, grad_lik = _make_grad_parts(prob, log_lik)
    counts = {"draws": 0, "gradients": 0, "syncs": 0}

    def init(position):
        return SGHMCState(position=position,
                          momentum=torch.zeros_like(position), draw_ind=0)

    def transition(state: SGHMCState, idx, noise):
        x = state.position
        batch = gather_batch(data, idx, x.shape[0])
        g = grad_prior(x) + scale * grad_lik(x, batch)
        counts["draws"] += 1
        counts["gradients"] += 2
        v = one_m_alpha * state.momentum + eta * g + noise_sd * noise
        prop = x + v
        ok = torch.isfinite(prop).all(dim=-1) & torch.isfinite(v).all(dim=-1)
        # a rejected draw also zeroes the momentum: carrying a huge or
        # non-finite v forward would re-explode the very next step
        return (SGHMCState(position=common.where_chains(ok, prop, x),
                           momentum=common.where_chains(
                               ok, v, torch.zeros_like(v)),
                           draw_ind=state.draw_ind + 1),
                {"accepted": ok})

    draw = _draw_fn(N, B, shared)

    def step(gen, state):
        return transition(state, *draw(gen, state))

    step.draw, step.transition, step.counts = draw, transition, counts
    return init, step


def sghmc(initial_vals, log_prior, log_lik, data, settings=None, *,
          n_chains=None, key=None, mesh=None, checkpoint_dir=None,
          checkpoint_every=500, dtype=None, thin=1, minibatch="per-chain",
          return_resume=False, device=None) -> SamplerResult:
    """Run SGHMC (Chen, Fox & Guestrin 2014): the calling convention, data
    contract, ``minibatch`` modes, driver options, bounds and failure
    semantics of :func:`sgld`; the momentum carries gradient memory across
    draws."""
    algo, s = resolve_settings(settings, "sghmc_settings", SGHMCSettings)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")
    if not callable(log_lik):
        raise TypeError("log_lik must be callable: log_lik(params, batch)")
    if not 0.0 < s.friction_alpha <= 1.0:
        raise ValueError(f"friction_alpha must be in (0, 1], got "
                         f"{s.friction_alpha}")
    if not 0.0 <= s.beta_hat < s.friction_alpha:
        raise ValueError("beta_hat must satisfy 0 <= beta_hat < "
                         "friction_alpha (it estimates a noise variance, "
                         "so it cannot be negative, and the injected noise "
                         "variance 2(alpha - beta_hat)eta must stay "
                         "positive)")
    _check_minibatch(minibatch)

    prob = common.setup_problem(initial_vals, log_prior, algo, n_chains,
                                dtype, device)
    data, n_data = _validate_data(data, s.batch_size, prob.dtype,
                                  prob.device)
    kernel = build_sghmc_kernel(prob, log_lik, data, n_data, s,
                                shared=minibatch == "shared")
    return _drive_sg_mcmc(kernel, prob, algo, key, s.n_burnin_draws,
                          s.n_keep_draws, mesh, checkpoint_dir,
                          checkpoint_every, thin, return_resume)
