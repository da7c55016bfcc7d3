"""MAP + Laplace approximation — posterior-mode initialization (PyTorch port
of ``mcmc_tpu.laplace``).

The framework finds the posterior mode itself and wraps a Gaussian
(Laplace) approximation around it, giving overdispersed chain
initialization (:meth:`LaplaceResult.draw_init`) and a curvature-matched
covariance.

The ``n_restarts`` Adam runs are one ``(n_restarts, d)`` batch: each step is
one batched evaluation of the log-kernel and one autograd gradient of its
sum (the restarts are independent rows), then Adam's update, written out as
``optax.adam`` computes it (b1 0.9, b2 0.999, eps 1e-8, eps_root 0, bias
correction), so the best-iterate tracking and the zeroing of non-finite
gradients stay those of the JAX package. The Hessian comes from
``torch.func.hessian`` of the box kernel at the best mode; a symmetric
eigenvalue clamp makes the covariance PD even at saddle-ish stationary
points. Bounded problems optimize in unconstrained coordinates via the
samplers' transform / log-Jacobian stack, so the covariance lives in the
samplers' working space.

Bounded-mode semantics: the objective is the *box* log-kernel (user
log-kernel plus log-Jacobian), the density the chains sample in
unconstrained coordinates; its maximizer mapped back differs from the
constrained-space MAP by the Jacobian term (a Gamma(k, r) posterior behind
``z = log x`` yields ``mode = k/r``, not ``(k-1)/r``). That is deliberate:
the Gaussian must match where the unconstrained-space mass sits.

API differences: ``log_kernel`` is batched; ``key`` is an integer seed or a
``torch.Generator``; ``optimizer=`` takes a PyTorch optimizer factory
``factory([z]) -> torch.optim.Optimizer`` in place of an optax
transformation (see :func:`map_laplace`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from mcmc_tpu_torch import bounds as bounds_mod
from mcmc_tpu_torch._optim import adam_direction
from mcmc_tpu_torch.integrators import grad_of, value_and_grad_of
from mcmc_tpu_torch.pytree import coerce_model
from mcmc_tpu_torch.samplers import common
from mcmc_tpu_torch.samplers._resolve import resolve_key
from mcmc_tpu_torch.settings import AlgoSettings

__all__ = ["map_laplace", "LaplaceResult"]

def _generator(key, device):
    """A ``torch.Generator`` on ``device`` from a seed or a generator."""
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=device).manual_seed(int(key))


@dataclasses.dataclass
class LaplaceResult:
    """Laplace approximation around the MAP.

    Attributes:
        mode: MAP point in constrained (user) space, ``(n_vals,)``.
        mode_z: the same point in unconstrained coordinates (equal to
            ``mode`` when unbounded).
        cov: Laplace covariance in unconstrained space — the inverse of the
            negative box-log-kernel Hessian, eigenvalue-clamped to PD.
        cov_sqrt: a matrix square root ``S`` with ``S @ S.T == cov``.
        log_post: box log-kernel value at the mode (includes the
            log-Jacobian term when bounded).
        grad_norm: gradient norm at the mode — convergence indicator.
        restart_log_posts: best box log-kernel per restart (spread here
            means restarts found different modes).
    """

    mode: Any
    mode_z: Any
    cov: Any
    cov_sqrt: Any
    log_post: Any
    grad_norm: Any
    restart_log_posts: Any
    unravel: Any = None   # pytree-input runs: unravel flat mode/draws
    _codes: Any = dataclasses.field(repr=False, default=None)
    _lb: Any = dataclasses.field(repr=False, default=None)
    _ub: Any = dataclasses.field(repr=False, default=None)
    _vals_bound: bool = dataclasses.field(repr=False, default=False)

    def _to_user(self, z):
        if not self._vals_bound:
            return z
        return bounds_mod.inv_transform(z, self._codes, self._lb, self._ub)

    def draw_init(self, key, n_chains: int, scale: float = 2.0):
        """Overdispersed initial positions: ``n_chains`` draws from the
        Laplace Gaussian widened by ``scale``, mapped back to constrained
        space — feed directly as a sampler's ``initial_vals``. ``key`` is a
        seed or a ``torch.Generator`` on the mode's device."""
        gen = _generator(key, self.mode_z.device)
        xi = torch.randn((int(n_chains), self.mode_z.shape[0]),
                         generator=gen, dtype=self.mode_z.dtype,
                         device=self.mode_z.device)
        return self._to_user(self.mode_z + scale * (xi @ self.cov_sqrt.T))

    @property
    def log_evidence(self):
        """Laplace approximation to the log marginal likelihood:
        ``log p(mode) + d/2·log 2π + ½·log|Σ|`` (exact when the box
        posterior is Gaussian). Requires ``log_kernel`` to be the
        *normalized* joint ``log prior + log lik``."""
        d = self.mode_z.shape[0]
        _, logdet = torch.linalg.slogdet(self.cov)
        return self.log_post + 0.5 * d * math.log(2.0 * math.pi) \
            + 0.5 * logdet

    def init_box(self, scale: float = 2.0):
        """Curvature-matched initial box ``(lb, ub)`` in *constrained*
        space: ``mode_z ± scale * sd`` built in unconstrained coordinates
        (where ``cov`` lives) and mapped back — feed to the population
        samplers' ``initial_lb``/``initial_ub``."""
        sd = torch.sqrt(torch.diagonal(self.cov))
        return (self._to_user(self.mode_z - scale * sd),
                self._to_user(self.mode_z + scale * sd))


def _adam_search(neg, z0, n_steps, learning_rate):
    """Batched Adam on ``neg`` (``(R, d) -> (R,)``) from ``z0``, tracking
    each row's best finite iterate; returns the last iterate, ``best_z``
    and ``best_f``. Adam's update is ``optax.adam``'s, term for term."""
    z = z0.detach().clone()
    mu = torch.zeros_like(z)
    nu = torch.zeros_like(z)
    best_z = z.clone()
    best_f = torch.full(z.shape[:1], math.inf, dtype=z.dtype,
                        device=z.device)
    value_and_grad = value_and_grad_of(neg)
    for t in range(1, int(n_steps) + 1):
        f, g = value_and_grad(z)
        # a non-finite iterate (overshoot) must not poison best-so-far
        better = torch.isfinite(f) & (f < best_f)
        best_z = common.where_chains(better, z, best_z)
        best_f = torch.where(better, f, best_f)
        g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        upd, mu, nu = adam_direction(g, mu, nu, t)
        z = z + (-learning_rate) * upd
    return z, best_z, best_f


def _torch_search(neg, z0, n_steps, factory):
    """The same search under a user's PyTorch optimizer: one parameter,
    the ``(R, d)`` batch, whose loss is the sum over restarts."""
    z = z0.detach().clone().requires_grad_(True)
    opt = factory([z])
    best_z = z.detach().clone()
    best_f = torch.full(z.shape[:1], math.inf, dtype=z.dtype,
                        device=z.device)
    for _ in range(int(n_steps)):
        opt.zero_grad()
        with torch.enable_grad():
            f = neg(z)
            f.sum().backward()
        f = f.detach()
        better = torch.isfinite(f) & (f < best_f)
        best_z = common.where_chains(better, z.detach(), best_z)
        best_f = torch.where(better, f, best_f)
        z.grad = torch.where(torch.isfinite(z.grad), z.grad,
                             torch.zeros_like(z.grad))
        opt.step()
    return z.detach(), best_z, best_f


def _laplace_at(box, z_star):
    """Covariance pieces at ``z_star``: the negative Hessian of ``box``,
    symmetrized and eigenvalue-clamped, and the gradient norm there."""
    hess = -torch.func.hessian(lambda v: box(v[None])[0])(z_star)
    hess = 0.5 * (hess + hess.T)
    eigval, eigvec = torch.linalg.eigh(hess)
    # Directions with non-positive (or numerically zero) curvature are not
    # identified by the quadratic approximation (saddle/flat/ridge). Give
    # them the TIGHTEST direction's variance rather than a tiny eigenvalue
    # floor, which would launch chains astronomically far from the mode.
    max_abs = torch.clamp_min(eigval.abs().max(), 1.0)
    degenerate = eigval <= max_abs * 1e-8
    eigval = torch.where(degenerate, max_abs, eigval)
    cov = (eigvec / eigval) @ eigvec.T
    cov_sqrt = eigvec / torch.sqrt(eigval)
    return cov, cov_sqrt, torch.linalg.norm(grad_of(box)(z_star[None])[0])


def map_laplace(initial_vals, log_kernel, settings=None, *, n_steps=500,
                learning_rate=0.05, n_restarts=4, restart_scale=1.0,
                key=None, optimizer=None, dtype=None,
                device=None) -> LaplaceResult:
    """Find the posterior mode and its Laplace approximation.

    ``log_kernel(params: (n, d)) -> (n,)`` is the batched function the
    samplers take; ``settings`` is an :class:`AlgoSettings` (only its
    ``vals_bound`` / ``lower_bounds`` / ``upper_bounds`` and
    ``rng_seed_value`` fields are read) or ``None``. ``n_restarts`` batched
    Adam runs start from ``initial_vals`` plus ``restart_scale``-sized
    Gaussian jitter in unconstrained space (restart 0 is unjittered); the
    best-objective iterate ever visited wins, so a final-step oscillation
    cannot lose the mode.

    ``optimizer`` (deviation from the JAX package, which takes an optax
    transformation): a factory ``optimizer([z]) -> torch.optim.Optimizer``
    for the one ``(n_restarts, d)`` parameter, minimizing the sum of the
    restarts' negative log-kernels (per-coordinate optimizers such as SGD,
    Adam or RMSprop keep the restarts independent); ``None`` runs the
    written-out Adam at ``learning_rate``. ``key`` is a seed or a
    ``torch.Generator`` (``None``: the settings' ``rng_seed_value``);
    ``device`` defaults to that of ``initial_vals``, else the card.
    """
    if settings is None:
        settings = AlgoSettings()
    if not isinstance(settings, AlgoSettings):
        raise TypeError(
            f"settings must be AlgoSettings or None; got "
            f"{type(settings).__name__}")
    initial_vals, (log_kernel,), unravel = coerce_model(
        initial_vals, log_kernel, device=device)
    n_restarts = int(n_restarts)
    if n_restarts < 1:
        raise ValueError(f"n_restarts must be >= 1, got {n_restarts}")

    prob = common.setup_problem(initial_vals, log_kernel, settings,
                                n_chains=n_restarts, dtype=dtype,
                                device=device)
    gen = resolve_key(key, settings, prob.device)
    z0 = prob.first_draw                                  # (n_restarts, d)
    jitter = torch.randn(z0.shape, generator=gen, dtype=z0.dtype,
                         device=z0.device) * restart_scale
    jitter[0] = 0.0
    return _solve(prob, z0 + jitter, n_steps, learning_rate, optimizer,
                  unravel)


def _solve(prob, z0, n_steps, learning_rate, optimizer, unravel=None):
    """The search from the jittered starts ``z0`` and the Laplace pieces at
    its best iterate (the JAX package's jitted ``solve``)."""
    box = prob.box_log_kernel
    neg = lambda z: -box(z)
    if optimizer is None:
        zf, best_z, best_f = _adam_search(neg, z0, n_steps, learning_rate)
    else:
        zf, best_z, best_f = _torch_search(neg, z0, n_steps, optimizer)
    with torch.no_grad():
        ff = neg(zf)
    final_better = torch.isfinite(ff) & (ff < best_f)
    best_z = common.where_chains(final_better, zf, best_z)
    best_f = torch.where(final_better, ff, best_f)
    z_star = best_z[torch.argmin(best_f)]
    cov, cov_sqrt, grad_norm = _laplace_at(box, z_star)
    log_posts = -best_f
    mode = z_star
    if prob.vals_bound:
        mode = bounds_mod.inv_transform(z_star, prob.codes,
                                        prob.lower_bounds, prob.upper_bounds)
    return LaplaceResult(
        mode=mode, mode_z=z_star, cov=cov, cov_sqrt=cov_sqrt,
        log_post=log_posts.max(), grad_norm=grad_norm,
        restart_log_posts=log_posts, unravel=unravel,
        _codes=prob.codes, _lb=prob.lower_bounds, _ub=prob.upper_bounds,
        _vals_bound=prob.vals_bound,
    )
