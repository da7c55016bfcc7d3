"""Fused HMC trajectories for GLM posteriors (PyTorch port of the K1 path of
``mcmc_tpu.ops.fused_logreg``; logistic regression is the flagship).

Under plain tensor code each gradient of the GLM log-posterior writes the
``(n_chains, n_data)`` linear predictor to device memory between two large
matmuls. The fused trajectory runs all ``n_leap`` leapfrog steps for a tile
of chains in one CUDA kernel (``csrc/fused_glm_trajectory.cu``): positions,
momenta and gradients stay on chip, the design matrix is streamed in row
tiles, and the linear predictor never leaves the SM.

Precision contract (the JAX package's): matmuls take bf16 operands — the
position rounded to bf16 before ``eta = z X^T`` and the residual rounded to
bf16 before ``g = r X`` — with f32 accumulation; positions, momenta and the
potential are f32. The potential the trajectory returns is computed from the
bf16-path ``eta`` (ROADMAP C2, kept for parity with the reference).

On a CPU tensor the trajectory runs :func:`_fused_trajectory_plain`, the
plain PyTorch version of the kernel; on a CUDA tensor it launches the kernel
or raises.

The public entry is :func:`make_fused_hmc_step`, a batched HMC transition
for ``(n_chains, dim)`` chain blocks with the semantics of
:func:`mcmc_tpu_torch.hmc` (reference src/hmc.cpp:150-196: momentum refresh,
leapfrog, min(0.01, .) accept clamp, +inf guard).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["FusedHMCState", "make_fused_trajectory", "make_fused_hmc_step",
           "studentt_link", "fused_trajectory", "fused_trajectory_cuda"]

# data rows per tile of the kernel's streamed design matrix: the padded row
# count is a multiple of it (the JAX package pads to the TPU's 512)
ROW_TILE = 64


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class FusedHMCState(NamedTuple):
    position: torch.Tensor   # (n_chains, dim_padded) f32; padding columns zero
    potential: torch.Tensor  # (n_chains,) f32


_LINKS = ("logistic", "poisson", "linear", "probit")

# f32 floor for probit tail probabilities: below eta ~ -11 the f32 normal
# CDF underflows; clipping makes ll finite with a capped tail penalty
# (log(1e-30) ~ -69) so far-tail proposals are strongly rejected instead of
# NaN-poisoning the trajectory.
_PROBIT_TINY = 1e-30


def _erf_poly(x):
    """erf via Abramowitz & Stegun 7.1.26 (exp-only, |error| <= 1.5e-7).
    The probit family uses this polynomial, not ``torch.erf``, in the
    kernel, its plain version and the reference potential alike, as the JAX
    package does: the approximated likelihood IS the model, which keeps the
    MH accept exact for it."""
    a1, a2, a3, a4, a5 = (0.254829592, -0.284496736, 1.421413741,
                          -1.453152027, 1.061405429)
    p = 0.3275911
    ax = torch.abs(x)
    t = 1.0 / (1.0 + p * ax)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    y = 1.0 - poly * torch.exp(-ax * ax)
    return torch.sign(x) * y


def _softplus(x):
    # logaddexp(x, 0), the JAX package's softplus, in the kernel's form
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _link_eval_fns(link):
    """Per-family ``(mu_eff, ll_terms)`` from the linear predictor. The
    gradient contract is ``d ll / d eta = y - mu_eff`` — exactly the mean
    function for canonical links (logistic/poisson/linear); for the
    non-canonical ``probit`` and :func:`studentt_link` families
    ``mu_eff = y - score`` encodes the true score in the same slot. A
    callable ``link(eta, y) -> (mu_eff, ll_terms)`` plugs any family
    written in torch into the same trajectory."""
    def link_eval(eta, yv):
        if callable(link):
            return link(eta, yv)
        if link == "logistic":
            return torch.sigmoid(eta), yv * eta - _softplus(eta)
        if link == "poisson":
            mu = torch.exp(eta)
            return mu, yv * eta - mu
        if link == "probit":
            # stable Bernoulli-probit score: phi/Phi for y=1, -phi/(1-Phi)
            # for y=0 (inverse Mills ratios), Phi clipped at the f32 floor
            phi = torch.exp(-0.5 * eta * eta) * (1.0 / math.sqrt(2.0 * math.pi))
            cdf = torch.clamp(
                0.5 * (1.0 + _erf_poly(eta * (1.0 / math.sqrt(2.0)))),
                _PROBIT_TINY, 1.0 - 1e-7)
            score = yv * phi / cdf - (1.0 - yv) * phi / (1.0 - cdf)
            ll = yv * torch.log(cdf) + (1.0 - yv) * torch.log(1.0 - cdf)
            return yv - score, ll
        return eta, -0.5 * (yv - eta) ** 2
    return link_eval


def studentt_link(nu: float = 4.0):
    """Student-t robust-regression link for the fused GLM trajectory:
    ``y | eta ~ t_nu(eta, 1)``. Returns a callable for the ``link=``
    parameter of :func:`make_fused_trajectory` and
    :func:`make_fused_hmc_step`. Score ``(nu+1)(y-eta)/(nu+(y-eta)^2)``
    is bounded — the robustness property — and is encoded in the
    ``mu_eff = y - score`` slot of the gradient contract. A callable link
    runs through the plain version on CPU tensors only (ROADMAP B)."""
    nu = float(nu)

    def link(eta, yv):
        r = yv - eta
        score = (nu + 1.0) * r / (nu + r * r)
        ll = -0.5 * (nu + 1.0) * torch.log1p(r * r / nu)
        return yv - score, ll

    return link


def _fused_trajectory_plain(z, p, Xb, y, mask, inv_pv, step_size, n_leap,
                            link):
    """Plain PyTorch version of the fused trajectory kernel, with its
    signature and its rounding points: ``z`` and ``p`` ``(n_chains, Dp)``
    f32, ``Xb`` ``(Np, Dp)`` bf16, ``y`` and ``mask`` ``(Np,)`` f32.
    Returns ``(z_new, p_new, U_new)``."""
    link_eval = _link_eval_fns(link)
    Xf = Xb.float()            # exact: every bf16 value is an f32 value
    half_eps = 0.5 * step_size
    eps = float(step_size)

    def grad_of(z, want_u):
        eta = z.bfloat16().float() @ Xf.T
        mu, ll_terms = link_eval(eta, y)
        r = (y - mu) * mask
        g = r.bfloat16().float() @ Xf - z * inv_pv
        u = None
        if want_u:
            ll = (mask * ll_terms).sum(dim=1)
            u = -(ll - 0.5 * (z * z).sum(dim=1) * inv_pv)
        return g, u

    # gradient hoisted across steps: n_leap + 1 evaluations
    u_out = None
    g, _ = grad_of(z, False)
    for k in range(n_leap):
        p = p + half_eps * g
        z = z + eps * p
        g, u_out = grad_of(z, k == n_leap - 1)
        p = p + half_eps * g
    return z, p, u_out


def fused_trajectory_cuda(z, p, Xb, y, mask, inv_pv, step_size, n_leap,
                          link):
    """Launch the fused trajectory kernel (``csrc/fused_glm_trajectory.cu``)
    on the card: same signature and result as
    :func:`_fused_trajectory_plain`. Counts its launches in
    ``fused_trajectory_cuda.launches``."""
    if callable(link):
        raise NotImplementedError(
            "a callable link (e.g. studentt_link) has no CUDA kernel yet "
            "(ROADMAP B); run it on CPU tensors")
    if link not in _LINKS:
        raise ValueError(f"link must be callable or one of {_LINKS}, got {link!r}")
    from mcmc_tpu_torch.ops import _cuda

    n_chains, dp = z.shape
    n_rows = Xb.shape[0]
    dev = z.device
    if dev.type != "cuda":
        raise ValueError(f"fused trajectory kernel takes CUDA tensors; got {dev}")
    expect = [(z, torch.float32, (n_chains, dp)),
              (p, torch.float32, (n_chains, dp)),
              (Xb, torch.bfloat16, (n_rows, dp)),
              (y, torch.float32, (n_rows,)),
              (mask, torch.float32, (n_rows,))]
    for t, dt, shape in expect:
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"fused trajectory kernel takes contiguous {dt} {shape} on "
                f"{dev}; got {t.dtype} {tuple(t.shape)} on {t.device}")
    if dp not in _cuda.DIM_PADDED or n_rows % ROW_TILE or n_chains < 1:
        raise ValueError(
            f"fused trajectory kernel takes dim_padded in {_cuda.DIM_PADDED}, "
            f"a row count that is a multiple of {ROW_TILE} and at least one "
            f"chain; got {dp}, {n_rows}, {n_chains}")
    lib = _cuda.load()
    z_out = torch.empty_like(z)
    p_out = torch.empty_like(p)
    u_out = torch.empty((n_chains,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.fused_glm_trajectory_launch(
            z.data_ptr(), p.data_ptr(), Xb.data_ptr(), y.data_ptr(),
            mask.data_ptr(), z_out.data_ptr(), p_out.data_ptr(),
            u_out.data_ptr(), n_chains, n_rows, dp, int(n_leap),
            0.5 * step_size, float(step_size), float(inv_pv),
            _LINKS.index(link), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("fused trajectory kernel launch failed: "
                           + lib.fused_glm_error_string(rc).decode())
    fused_trajectory_cuda.launches += 1
    return z_out, p_out, u_out


fused_trajectory_cuda.launches = 0


def fused_trajectory(z, p, Xb, y, mask, inv_pv, step_size, n_leap, link):
    """The fused trajectory on the tensors' device: the plain version for
    CPU tensors, the kernel for CUDA tensors."""
    if z.device.type == "cpu":
        return _fused_trajectory_plain(z, p, Xb, y, mask, inv_pv, step_size,
                                       n_leap, link)
    if z.device.type == "cuda":
        return fused_trajectory_cuda(z, p, Xb, y, mask, inv_pv, step_size,
                                     n_leap, link)
    raise ValueError(f"no fused trajectory for device {z.device}")


def _padded_glm(X, y, device):
    """``(Xb, y, mask, dim)``: X zero-padded to ``(Np, Dp)`` in bf16, y and
    the row mask zero-padded to ``(Np,)``."""
    X = torch.as_tensor(X, dtype=torch.float32, device=device)
    y = torch.as_tensor(y, dtype=torch.float32, device=device)
    n_data, dim = X.shape
    Np = _round_up(n_data, ROW_TILE)
    Dp = _round_up(dim, 128)
    Xp = torch.zeros((Np, Dp), dtype=torch.float32, device=device)
    Xp[:n_data, :dim] = X
    yrow = torch.zeros((Np,), dtype=torch.float32, device=device)
    yrow[:n_data] = y
    mask = torch.zeros((Np,), dtype=torch.float32, device=device)
    mask[:n_data] = 1.0
    return Xp.to(torch.bfloat16), yrow, mask, dim


def make_fused_trajectory(X, y, prior_scale: float, step_size: float,
                          n_leap: int, block_chains: int = 256,
                          link="logistic", device=None):
    """Build ``traj(z, p) -> (z_new, p_new, U_new)`` over padded tensors.

    ``X`` is (n_data, dim); internally padded to ``(Np, Dp)``, ``Dp =
    round_up(dim, 128)`` as in the JAX package and ``Np`` a multiple of the
    kernel's row tile, with a row mask so padded data rows contribute
    exactly zero to both gradient and log-density. ``link`` selects the GLM
    family (or is a callable ``link_fn(eta, y) -> (mu, ll_terms)``, see
    :func:`_link_eval_fns`). ``device`` defaults to ``X``'s. ``block_chains``
    is kept from the JAX package's API: the chain count must be a multiple
    of it; the kernel tiles chains its own way."""
    if not callable(link) and link not in _LINKS:
        raise ValueError(f"link must be callable or one of {_LINKS}, got {link!r}")
    if int(n_leap) < 1:
        raise ValueError(f"n_leap must be >= 1, got {n_leap}")
    if device is None:
        device = X.device if torch.is_tensor(X) else "cpu"
    Xb, yrow, mask, dim = _padded_glm(X, y, device)
    inv_pv = 1.0 / (prior_scale * prior_scale)

    def traj(z, p):
        n_chains = z.shape[0]
        if n_chains % block_chains != 0:
            raise ValueError(
                f"n_chains={n_chains} must be a multiple of "
                f"block_chains={block_chains}"
            )
        return fused_trajectory(z, p, Xb, yrow, mask, inv_pv, step_size,
                                n_leap, link)

    traj.dim = dim
    traj.dim_padded = Xb.shape[1]
    # the padded operands, for calling the kernel and its plain version
    # directly (tests, chip_smoke.py)
    traj.Xb, traj.y, traj.mask, traj.inv_pv = Xb, yrow, mask, inv_pv
    return traj


def make_fused_hmc_step(X, y, prior_scale=10.0, step_size=0.01, n_leap=4,
                        block_chains: int = 256, link="logistic",
                        device=None):
    """Batched HMC transition ``step(gen, state) -> (state, info)`` with the
    trajectory fused; each transition draws its momenta and uniforms for all
    chains from the one ``torch.Generator`` ``gen``. ``step.init(positions)``
    pads ``(n_chains, dim)`` positions and computes their f32 potential."""
    if device is None:
        device = X.device if torch.is_tensor(X) else "cpu"
    traj = make_fused_trajectory(X, y, prior_scale, step_size, n_leap,
                                 block_chains, link, device)
    dim, Dp = traj.dim, traj.dim_padded

    X32 = torch.as_tensor(X, dtype=torch.float32, device=device)
    y32 = torch.as_tensor(y, dtype=torch.float32, device=device)
    inv_pv = 1.0 / (prior_scale * prior_scale)
    link_eval_ = _link_eval_fns(link)

    def reference_potential(zp):
        # same per-family ll_terms the kernel computes, so the initial U is
        # consistent with in-trajectory U for every link (incl. callables)
        z = zp[:, :dim]
        _mu, ll_terms = link_eval_(z @ X32.T, y32)
        ll = ll_terms.sum(dim=1)
        return -(ll - 0.5 * (z ** 2).sum(dim=1) * inv_pv)

    def init(positions):
        positions = torch.as_tensor(positions, dtype=torch.float32,
                                    device=device)
        zp = torch.zeros((positions.shape[0], Dp), dtype=torch.float32,
                         device=device)
        zp[:, :dim] = positions
        return FusedHMCState(position=zp, potential=reference_potential(zp))

    col_mask = (torch.arange(Dp, device=device) < dim).to(torch.float32)

    def step(gen, state: FusedHMCState):
        n_chains = state.position.shape[0]
        p0 = torch.randn((n_chains, Dp), generator=gen, dtype=torch.float32,
                         device=device) * col_mask
        prev_K = 0.5 * (p0 * p0).sum(dim=1)

        z_new, p_new, prop_U = traj(state.position, p0)
        prop_U = torch.where(torch.isfinite(prop_U), prop_U, torch.inf)
        prop_K = 0.5 * (p_new * p_new).sum(dim=1)

        comp = torch.clamp_max(-(prop_U + prop_K) + (state.potential + prev_K),
                               0.01)
        u = torch.rand((n_chains,), generator=gen, dtype=torch.float32,
                       device=device)
        accepted = u < torch.exp(comp)

        new_state = FusedHMCState(
            position=torch.where(accepted[:, None], z_new, state.position),
            potential=torch.where(accepted, prop_U, state.potential),
        )
        return new_state, {"accepted": accepted}

    step.init = init
    step.dim = dim
    step.dim_padded = Dp
    return step
