"""Metric constructors for Riemannian-manifold HMC (PyTorch port of
``mcmc_tpu.metrics``).

:func:`softabs_metric` builds a positive-definite metric from the local
Hessian of any twice-differentiable log-kernel (Betancourt 2013, "A general
metric for Riemannian manifold Hamiltonian Monte Carlo"):

    H(theta) = -d^2 logK = Q diag(lambda) Q^T,
    G(theta) =  Q diag(lambda * coth(alpha * lambda)) Q^T,

each Hessian eigenvalue pushed through the smooth absolute value
``f(l) = l coth(alpha l)``.

Differentiation: RM-HMC needs ``dG/dtheta``, which the sampler takes with
``torch.func.jvp``. Autograd through ``torch.linalg.eigh`` is infinite or
NaN wherever eigenvalues coincide, and symmetric targets hit exact
degeneracies, so the map ``H -> G`` is a ``torch.autograd.Function`` whose
``jvp`` is the smooth rule for spectral functions of symmetric matrices
(Daleckii-Krein): with ``M = Q^T dH Q``,

    dG = Q (J o M) Q^T,   J_ij = (f(l_i) - f(l_j)) / (l_i - l_j),
                          J_ii = f'(l_i),

coincident pairs taking the limit ``(f'(l_i) + f'(l_j)) / 2``. The tangent
``dH`` reaching it is the nested JVP of the Hessian, which is itself ``d``
forward-mode JVPs of the gradient of the batched log-kernel's sum (forward
over reverse, batched over the basis vectors by ``torch.func.vmap``; chains
are independent, so each column is each chain's own).

On the card ``torch.linalg.eigh`` reads its ``info`` back (it has no
``_ex`` form): one host synchronisation per metric evaluation.
"""

from __future__ import annotations

import torch

__all__ = ["softabs_metric"]


def _softabs_f(lam, alpha):
    """f(l) = l coth(alpha l), elementwise; series ``(1 + (alpha l)^2 / 3)
    / alpha`` below the cutoff (the direct form is 0/0 at l = 0)."""
    a = alpha * lam
    big = torch.abs(a) > 1e-3
    safe = torch.where(big, a, 1.0)
    return torch.where(big, lam / torch.tanh(safe),
                       (1.0 + a * a / 3.0) / alpha)


def _softabs_fprime(lam, alpha):
    """f'(l) = coth(alpha l) - (alpha l) csch^2(alpha l); series
    ``2 alpha l / 3`` below the cutoff. Written in tanh so that a large
    ``|alpha l|`` saturates to sign(l) instead of overflowing sinh."""
    a = alpha * lam
    big = torch.abs(a) > 1e-3
    safe = torch.where(big, a, 1.0)
    t = torch.tanh(safe)
    return torch.where(big, 1.0 / t - safe * (1.0 - t * t) / (t * t),
                       2.0 * a / 3.0)


class _SoftAbsMap(torch.autograd.Function):
    """``H (..., d, d) -> G = Q diag(f(lambda)) Q^T`` with the
    Daleckii-Krein forward derivative; returns ``(G, lambda, Q)``, the last
    two not differentiable. No transform reaches inside ``forward``, so
    nothing differentiates ``eigh``."""

    @staticmethod
    def forward(H, alpha):
        # a non-finite Hessian (a point where the log-kernel overflows) gets
        # NaN, as the JAX package's eigh returns it; torch's eigh would
        # raise on it, so it decomposes the identity there instead
        finite = torch.isfinite(H).all(dim=-1).all(dim=-1)
        eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
        lam, Q = torch.linalg.eigh(torch.where(finite[..., None, None], H,
                                               eye))
        lam = torch.where(finite[..., None], lam, torch.nan)
        Q = torch.where(finite[..., None, None], Q, torch.nan)
        G = (Q * _softabs_f(lam, alpha)[..., None, :]) @ Q.transpose(-1, -2)
        return G, lam, Q

    @staticmethod
    def setup_context(ctx, inputs, output):
        _G, lam, Q = output
        ctx.alpha = inputs[1]
        ctx.mark_non_differentiable(lam, Q)
        ctx.save_for_forward(lam, Q)

    @staticmethod
    def jvp(ctx, dH, _dalpha):
        lam, Q = ctx.saved_tensors
        f = _softabs_f(lam, ctx.alpha)
        fp = _softabs_fprime(lam, ctx.alpha)
        dlam = lam[..., :, None] - lam[..., None, :]
        # relative coincidence threshold; below it the divided difference
        # is replaced by its limit (f'(l_i) + f'(l_j)) / 2
        alam = torch.abs(lam)
        thr = 1e-6 * (alam[..., :, None] + alam[..., None, :] + 1.0)
        apart = torch.abs(dlam) > thr
        safe = torch.where(apart, dlam, 1.0)
        J = torch.where(apart, (f[..., :, None] - f[..., None, :]) / safe,
                        0.5 * (fp[..., :, None] + fp[..., None, :]))
        Qt = Q.transpose(-1, -2)
        dG = Q @ (J * (Qt @ dH @ Q)) @ Qt
        # symmetrize away the eigh round-off asymmetry
        dG = 0.5 * (dG + dG.transpose(-1, -2))
        return dG, None, None


def softabs_metric(log_kernel, alpha=1.0):
    """Metric function for :func:`mcmc_tpu_torch.rmhmc` from the SoftAbs map
    of the batched log-kernel's Hessian (Betancourt 2013): RM-HMC on any
    twice-differentiable target, no hand-derived Fisher information.

    ``alpha`` sets the sharpness of the smooth absolute value applied to the
    Hessian eigenvalues: eigenvalues with ``|l| >> 1/alpha`` pass through as
    ``|l|``; smaller ones are floored at ``1/alpha``.

    Returns a batched ``metric_fn(params (c, d)) -> (c, d, d)`` (a single
    ``(d,)`` gives ``(d, d)``) whose forward derivative, as
    ``torch.func.jvp`` takes it, stays finite at coincident Hessian
    eigenvalues (module docstring).
    """
    alpha = float(alpha)
    if not alpha > 0.0:
        raise ValueError(f"alpha must be > 0, got {alpha}")
    neg_grad = torch.func.grad(lambda x: -log_kernel(x).sum())

    def hess_fn(x):
        eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
        # the d JVPs along the basis vectors, batched by vmap (one set of
        # launches for all d): (i, ..., a) = d^2 U / dx_a dx_i
        cols = torch.func.vmap(lambda e: torch.func.jvp(
            neg_grad, (x,), (e.expand_as(x),))[1])(eye)
        H = cols.movedim(0, -1)
        # eigh reads one triangle; the JAX package's eigh symmetrizes first
        return 0.5 * (H + H.transpose(-1, -2))

    def metric_fn(x):
        return _SoftAbsMap.apply(hess_fn(x), alpha)[0]

    return metric_fn
