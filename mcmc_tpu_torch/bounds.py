"""Box-constraint stack (PyTorch port of ``mcmc_tpu.bounds``): bounds
classification, unconstraining transforms, log-Jacobian corrections.

Every function is elementwise over a per-dimension integer code vector, so a
``(n_chains, n_vals)`` batch broadcasts against ``(n_vals,)`` codes and
bounds. Bound-type codes (same encoding as the reference,
include/misc/determine_bounds_type.hpp:27-57):
    1 — unbounded
    2 — lower bound only:  z = log(x - lb + eps)
    3 — upper bound only:  z = -log(ub - x + eps)
    4 — two-sided:         z = log(x - lb + eps) - log(ub - x + eps)
"""

from __future__ import annotations

import torch

__all__ = [
    "determine_bounds_type",
    "transform",
    "inv_transform",
    "log_jacobian",
    "inv_jacobian_diag",
    "make_box_log_kernel",
]


def _eps(x):
    return torch.finfo(x.dtype).eps


def _select(codes, x1, x2, x3, x4):
    return torch.where(codes == 1, x1, torch.where(
        codes == 2, x2, torch.where(codes == 3, x3, x4)))


def _bound(b, like):
    return torch.as_tensor(b, dtype=like.dtype, device=like.device).expand_as(like)


def determine_bounds_type(vals_bound: bool, n_vals: int, lower_bounds,
                          upper_bounds, device=None):
    """Per-dimension bound-type codes (int32): finite lb & ub -> 4, finite lb
    only -> 2, finite ub only -> 3, else 1. ``vals_bound=False``
    short-circuits to all-1."""
    if not vals_bound:
        return torch.ones((n_vals,), dtype=torch.int32, device=device)
    lb = torch.as_tensor(lower_bounds, device=device)
    ub = torch.as_tensor(upper_bounds, device=device)
    lb_fin = torch.isfinite(lb)
    ub_fin = torch.isfinite(ub)
    codes = torch.where(lb_fin & ub_fin, 4,
                        torch.where(lb_fin, 2, torch.where(ub_fin, 3, 1)))
    return codes.to(torch.int32)


def transform(x, codes, lower_bounds, upper_bounds):
    """Constrained -> unconstrained map (reference transform_vals.hpp:25-60).
    Only applied to initial values, so no gradient-safety tricks needed."""
    eps = _eps(x)
    lb = _bound(lower_bounds, x)
    ub = _bound(upper_bounds, x)
    z2 = torch.log(x - lb + eps)
    z3 = -torch.log(ub - x + eps)
    return _select(codes, x, z2, z3, z2 + z3)


def inv_transform(z, codes, lower_bounds, upper_bounds):
    """Unconstrained -> constrained map (reference transform_vals.hpp:62-119).

    Matches the reference's non-finite clamping semantics:
      code 2: non-finite z -> lb + eps
      code 3: non-finite z -> ub - eps
      code 4: NaN -> (ub - lb)/2 (reference quirk, transform_vals.hpp:96-97);
              +/-inf or overflowed output -> clamped just inside the bound.
    """
    eps = _eps(z)
    lb = _bound(lower_bounds, z)
    ub = _bound(upper_bounds, z)

    finite = torch.isfinite(z)
    zs = torch.where(finite, z, 0.0)  # safe operand for exp

    # Branch-local finite stand-ins for the bounds AND for z: unselected
    # branches see +/-inf bounds, and reverse-mode AD multiplies cotangents
    # by these constants (inf * 0 = NaN), so they must be sanitized per
    # branch. z itself must be sanitized per branch too: a code-2 lane with
    # z = -100 overflows the code-3 branch's exp(-z) to inf, and the
    # gradient of that unselected branch is 0 * inf = NaN — torch.where
    # has the same trap as jnp.where.
    lb2 = torch.where(codes == 2, lb, 0.0)
    ub3 = torch.where(codes == 3, ub, 0.0)
    lb4 = torch.where(codes == 4, lb, 0.0)
    ub4 = torch.where(codes == 4, ub, 1.0)
    zs2 = torch.where(codes == 2, zs, 0.0)
    zs3 = torch.where(codes == 3, zs, 0.0)

    x2 = torch.where(finite, lb2 + eps + torch.exp(zs2), lb2 + eps)
    x3 = torch.where(finite, ub3 - eps - torch.exp(-zs3), ub3 - eps)

    # (lb - eps) * sigmoid(-z) + (ub + eps) * sigmoid(z), clipped inside.
    sig = torch.sigmoid(zs)
    x4 = (lb4 - eps) * (1.0 - sig) + (ub4 + eps) * sig
    x4 = torch.minimum(torch.maximum(x4, lb4 + eps), ub4 - eps)
    x4 = torch.where(finite, x4, torch.where(z < 0, lb4 + eps, ub4 - eps))
    x4 = torch.where(torch.isnan(z), (ub4 - lb4) / 2, x4)

    return _select(codes, z, x2, x3, x4)


def log_jacobian(z, codes, lower_bounds, upper_bounds):
    """Additive log|dx/dz| correction (reference log_jacobian.hpp:25-58),
    summed over the last axis: ``(n_chains, n_vals) -> (n_chains,)``.

    code 2: +z; code 3: -z; code 4: log(ub-lb) + z - 2*softplus(z).
    Gradient-safe."""
    lb = _bound(lower_bounds, z)
    ub = _bound(upper_bounds, z)
    j4 = torch.log(torch.where(codes == 4, ub - lb, 1.0)) + z \
        - 2.0 * torch.logaddexp(z, torch.zeros_like(z))
    per_dim = _select(codes, torch.zeros_like(z), z, -z, j4)
    return per_dim.sum(dim=-1)


def inv_jacobian_diag(z, codes, lower_bounds, upper_bounds):
    """Diagonal of the reference's ``inv_jacobian_adjust`` matrix
    (reference inv_jacobian_adjust.hpp:25-56), kept as a vector.

    code 1: 1; code 2: exp(-z); code 3: exp(z);
    code 4: (e^z + 1)^2 / (e^z (ub - lb))."""
    lb = _bound(lower_bounds, z)
    ub = _bound(upper_bounds, z)
    width = torch.where(codes == 4, ub - lb, 1.0)
    # branch-local z stand-ins, same AD-safety rationale as inv_transform
    z2 = torch.where(codes == 2, z, 0.0)
    z3 = torch.where(codes == 3, z, 0.0)
    z4 = torch.where(codes == 4, z, 0.0)
    j4 = (torch.exp(z4) + 2.0 + torch.exp(-z4)) / width
    return _select(codes, torch.ones_like(z), torch.exp(-z2), torch.exp(z3), j4)


def make_box_log_kernel(log_kernel, vals_bound, codes, lower_bounds,
                        upper_bounds):
    """Wrap a batched user log-kernel so it acts on unconstrained
    coordinates (reference src/rwmh.cpp:82-93): evaluate the user kernel at
    ``inv_transform(z)`` and add the log-Jacobian."""
    if not vals_bound:
        return log_kernel

    def box_log_kernel(z):
        x = inv_transform(z, codes, lower_bounds, upper_bounds)
        return log_kernel(x) + log_jacobian(z, codes, lower_bounds,
                                            upper_bounds)

    return box_log_kernel
