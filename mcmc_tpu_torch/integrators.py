"""Leapfrog integration shared by the Hamiltonian family (PyTorch port of
``mcmc_tpu.integrators``).

The reference's two half-kicks both add ``+eps/2 * grad`` with the position
drift ``z += eps * M^{-1} p`` between them (src/hmc.cpp:164-176); that
structure is preserved exactly. Positions and momenta are chain batches
``(n_chains, n_vals)``; gradients come from :func:`torch.autograd.grad` of
the summed batched log-kernel — chains are independent, so the gradient of
the sum is each chain's own gradient.

Gradient modes for bounded problems:

- ``"reference"`` (default): the momentum kick uses
  ``J(z) * grad_x logK(inv_transform(z))`` — the diagonal inverse-Jacobian
  chain rule of the reference (src/hmc.cpp:108-122), which *omits* the
  gradient of the log-Jacobian term. The accept step still uses the full box
  kernel, so the chain remains a valid MH sampler.
- ``"exact"``: the gradient of the box kernel itself — the exact
  Hamiltonian on the unconstrained space.

For unbounded problems the two modes coincide.
"""

from __future__ import annotations

import torch

from mcmc_tpu_torch import bounds as bounds_mod

__all__ = ["grad_of", "make_kick_grad", "leapfrog", "kinetic_energy"]


def grad_of(log_kernel):
    """``grad_fn(z) -> (n_chains, n_vals)``: per-chain gradient of a batched
    log-kernel, by autograd of its sum. The result carries no graph."""
    def grad_fn(z):
        with torch.enable_grad():
            zz = z.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(log_kernel(zz).sum(), zz,
                                       allow_unused=True)
        return torch.zeros_like(z) if g is None else g

    return grad_fn


def make_kick_grad(prob, mode: str = "reference"):
    """Return ``grad_fn(z) -> (n_chains, n_vals)`` used in momentum
    half-kicks."""
    if not prob.vals_bound or mode == "exact":
        return grad_of(prob.box_log_kernel)
    if mode != "reference":
        raise ValueError(f"unknown bounded_grad mode: {mode!r}")

    user_grad = grad_of(prob.log_kernel)

    def grad_fn(z):
        x = bounds_mod.inv_transform(z, prob.codes, prob.lower_bounds,
                                     prob.upper_bounds)
        jac = bounds_mod.inv_jacobian_diag(z, prob.codes, prob.lower_bounds,
                                           prob.upper_bounds)
        return jac * user_grad(x)

    return grad_fn


def leapfrog(grad_fn, inv_mv, step_size, n_steps, position, momentum):
    """``n_steps`` leapfrog steps (reference src/hmc.cpp:164-176).

    ``inv_mv`` applies the inverse preconditioner M^{-1} to each row.
    ``step_size`` is a float or a per-chain ``(n_chains,)`` tensor.

    The gradient at the step boundary is carried from one step to the next:
    the reference evaluates it twice per step, but the second half-kick's
    gradient is the next step's first at the unchanged position, so
    carrying it is bit-identical while costing ``n_steps + 1`` gradient
    evaluations instead of ``2 * n_steps``."""
    if torch.is_tensor(step_size) and step_size.ndim == 1:
        step_size = step_size[:, None]
    z, p = position, momentum
    g = grad_fn(z)
    for _ in range(int(n_steps)):
        p = p + 0.5 * step_size * g
        z = z + step_size * inv_mv(p)
        g = grad_fn(z)
        p = p + 0.5 * step_size * g
    return z, p


def kinetic_energy(momentum, inv_mv):
    """K = p^T M^{-1} p / 2 per chain (reference src/hmc.cpp:156-160)."""
    return 0.5 * (momentum * inv_mv(momentum)).sum(dim=-1)
