"""Pathfinder — L-BFGS-path variational initialization (PyTorch port of
``mcmc_tpu.pathfinder``).

Pathfinder (Zhang, Carpenter, Gelman & Vehtari 2022, JMLR 23(306); Stan's
default initializer) follows an L-BFGS optimization path toward the
posterior mode, wraps the quadratic (inverse-Hessian) Gaussian approximation
around *every* iterate, scores each by a Monte-Carlo ELBO, and draws from the
best — typically an iterate in the typical set, before the path collapses
into the mode. Multi-path mode runs several independent paths and
Pareto-smoothed-importance-resamples the pooled draws.

The port's design:

- all ``n_paths`` L-BFGS paths are one ``(n_paths, d)`` batch, with
  per-path masks where the JAX package ``vmap``s. Each iteration is
  ``optax.lbfgs(memory_size=J)`` as optax 0.2.6 computes it: the two-loop
  recursion over the ``(J, d)`` difference memory with the scaled-identity
  initial preconditioner (the capped reciprocal gradient norm at the first
  step), then ``scale_by_zoom_linesearch(max_linesearch_steps=20,
  initial_guess_strategy='one')`` (slope_rtol 1e-4, curv_rtol 0.9, increase
  factor 2, approx_dec_rtol 1e-6, stepsize_precision 1e-5): the interval
  search and the zoom with its cubic, quadratic and bisection candidates and
  its safeguards, every path's state masked once it is done. A line search
  reads one ``.any()`` over the paths back per iteration, its only host
  synchronisation (counted in :attr:`PathfinderResult.host_syncs`);
- beside the optimizer the path carries Pathfinder's own ``(J, d)`` ring of
  accepted curvature pairs (``s.y > _CURV_EPS |s||y|``, shifted in) and the
  diagonal-BFGS ``alpha``; a rejected (non-finite) step does not poison the
  carried point;
- the ELBO phase evaluates ALL iterates at once: each iterate's factored
  covariance ``Sigma = diag(alpha) + U M U^T`` via a batched thin QR and a
  ``(2J, 2J)`` ``eigh``, and ``n_elbo_draws`` per iterate scored in one
  batched log-kernel call per chunk of paths;
- the pooled draws are resampled by the framework's own Pareto smoothing
  (:func:`mcmc_tpu_torch.model_compare._psis_smooth_one`) and a Gumbel
  top-k draw without replacement (:func:`mcmc_tpu_torch.stats.gumbel_topk`).

Sampling uses ``Sigma = sqrt(alpha) (I + W diag(lam) W^T) sqrt(alpha)``:
``x = mu + sqrt(alpha) * (z + W ((sqrt(1+lam)-1) * W^T z))``, ``log|Sigma| =
sum log alpha + sum log1p(lam)``. Non-PD iterates are excluded from the
ELBO argmax. Bounded problems run in unconstrained space on the box kernel;
returned draws are back-transformed.

API differences: ``log_kernel`` is batched; ``key`` is a seed or a
``torch.Generator`` (the jitter, the ELBO normals, the final normals and the
Gumbel uniforms are drawn from it in that order); the line search's value
and gradient at the accepted step are those the next iteration starts from
(the JAX package evaluates the same point again).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from mcmc_tpu_torch import bounds as bounds_mod
from mcmc_tpu_torch import stats
from mcmc_tpu_torch.integrators import value_and_grad_of
from mcmc_tpu_torch.model_compare import _psis_smooth_one
from mcmc_tpu_torch.pytree import coerce_model
from mcmc_tpu_torch.samplers import common
from mcmc_tpu_torch.samplers._resolve import resolve_key
from mcmc_tpu_torch.settings import AlgoSettings

__all__ = ["pathfinder", "PathfinderResult"]

_CURV_EPS = 1e-12       # curvature-pair acceptance s.y > eps*|s||y|
_PD_EPS = 1e-8          # eigenvalue floor for 1 + lam
_LOG_2PI = math.log(2.0 * math.pi)

# optax.lbfgs's default zoom line search (optax 0.2.6)
_LS_MAX_STEPS = 20
_LS_INCREASE = 2.0
_LS_SLOPE_RTOL = 1e-4
_LS_CURV_RTOL = 0.9
_LS_APPROX_DEC_RTOL = 1e-6
_LS_INTERVAL_THRESHOLD = 1e-5

# rows of one batched log-kernel call in the ELBO phase
_ELBO_ROWS = 1 << 16


@dataclasses.dataclass
class PathfinderResult:
    """Pathfinder output.

    Attributes:
        draws: ``(n_draws, n_vals)`` PSIS-resampled draws, constrained
            space — feed directly as overdispersed ``initial_vals``.
        log_p: box log-kernel at each draw (unconstrained-space density).
        log_q: the generating path-Gaussian's log-density at each draw.
        pareto_k: GPD shape of the pooled importance weights (k < 0.7: the
            draws are a usable posterior approximation).
        elbo: ``(n_paths,)`` best ELBO per path.
        best_iter: ``(n_paths,)`` index of the winning L-BFGS iterate.
        n_lbfgs_iters: iterations each path actually improved.
        host_syncs: host synchronisations of the line searches (one per
            line-search iteration; port only).
    """

    draws: Any
    log_p: Any
    log_q: Any
    pareto_k: Any
    elbo: Any
    best_iter: Any
    n_lbfgs_iters: Any
    unravel: Any = None   # pytree-input runs: unravel_draws(draws, unravel)
    host_syncs: int = 0
    _draws_z: Any = dataclasses.field(repr=False, default=None)
    _codes: Any = dataclasses.field(repr=False, default=None)
    _lb: Any = dataclasses.field(repr=False, default=None)
    _ub: Any = dataclasses.field(repr=False, default=None)
    _vals_bound: bool = dataclasses.field(repr=False, default=False)

    def _to_user(self, z):
        if not self._vals_bound:
            return z
        return bounds_mod.inv_transform(z, self._codes, self._lb, self._ub)

    def draw_init(self, key, n_chains: int):
        """``n_chains`` rows resampled (with replacement) from ``draws`` —
        chain initialization in constrained space. ``key`` is a seed or a
        ``torch.Generator`` on the draws' device."""
        gen = key if isinstance(key, torch.Generator) else \
            torch.Generator(device=self.draws.device).manual_seed(int(key))
        ix = torch.randint(0, self.draws.shape[0], (int(n_chains),),
                           generator=gen, device=self.draws.device)
        return self.draws[ix]

    @property
    def center(self):
        """Posterior-bulk center: the unconstrained draw mean mapped back
        to constrained space (the analog of ``LaplaceResult.mode`` for the
        population samplers)."""
        return self._to_user(self._draws_z.mean(dim=0))

    def init_box(self, scale: float = 2.0):
        """Spread-matched initial box ``(lb, ub)`` in constrained space,
        ``mean ± scale·sd`` of the unconstrained draws mapped back (the
        contract of ``LaplaceResult.init_box``)."""
        zm = self._draws_z.mean(dim=0)
        sd = self.spread_z
        return self._to_user(zm - scale * sd), self._to_user(zm + scale * sd)

    @property
    def spread_z(self):
        """Per-dimension standard deviation of the unconstrained draws —
        the walker-ball spread for the stretch ensemble."""
        return self._draws_z.std(dim=0, unbiased=False)


def _vdot(a, b):
    return (a * b).sum(dim=-1)


def _diag_bfgs_update(alpha, s, y, ok):
    """Elementwise diagonal-BFGS update of the inverse-Hessian diagonal
    (Zhang et al. 2022, eq. 10), on every row of a batch: with b = 1/alpha,
    ``b' = b + y^2/(y.s) - (b s)^2 / (s.(b s))``."""
    b = 1.0 / alpha
    sy = _vdot(s, y)[..., None]
    bs = b * s
    b_new = b + y * y / sy - bs * bs / _vdot(s, bs)[..., None]
    b_new = torch.clamp_min(b_new, 1e-12)
    return torch.where(ok[..., None], 1.0 / b_new, alpha)


# -- optax.lbfgs, batched over paths ----------------------------------------

class LBFGSState(NamedTuple):
    """``optax.scale_by_lbfgs``'s state for a batch of paths: the iteration
    ``count`` (a host integer, equal across paths), the last ``params`` and
    ``updates`` (gradients), and the difference memories ``(P, J, d)`` with
    their weights ``(P, J)``."""

    count: int
    params: Any
    updates: Any
    diff_params: Any
    diff_updates: Any
    weights: Any


def lbfgs_init(x, memory):
    P, d = x.shape
    z = x.new_zeros((P, int(memory), d))
    return LBFGSState(0, torch.zeros_like(x), torch.zeros_like(x), z,
                      z.clone(), x.new_zeros((P, int(memory))))


def lbfgs_direction(state, x, grad):
    """One ``scale_by_lbfgs`` update then ``scale(-1)``: the descent
    direction at ``x`` and the new state."""
    J = state.weights.shape[-1]
    mem_idx, prev_idx = state.count % J, (state.count - 1) % J
    dw = x - state.params
    du = grad - state.updates
    vd = _vdot(du, dw)
    if state.count > 0:
        weight = torch.where(vd == 0.0, torch.zeros_like(vd), 1.0 / vd)
    else:   # differences undefined at the first iteration
        dw, du = torch.zeros_like(dw), torch.zeros_like(du)
        vd, weight = torch.zeros_like(vd), torch.zeros_like(vd)
    mem_w, mem_u = state.diff_params.clone(), state.diff_updates.clone()
    rho = state.weights.clone()
    mem_w[:, prev_idx], mem_u[:, prev_idx], rho[:, prev_idx] = dw, du, weight
    if state.count > 0:
        den = _vdot(du, du)
        scale = torch.where(den > 0.0, vd / den, torch.ones_like(vd))
    else:   # the capped reciprocal gradient norm
        scale = torch.clamp_max(1.0 / torch.linalg.vector_norm(grad, dim=-1),
                                1.0)
    indices = [(mem_idx + i) % J for i in range(J)]
    vec, alphas = grad, {}
    for i in reversed(indices):
        a = rho[:, i] * _vdot(mem_w[:, i], vec)
        vec = vec + (-a)[:, None] * mem_u[:, i]
        alphas[i] = a
    vec = scale[:, None] * vec
    for i in indices:
        beta = rho[:, i] * _vdot(mem_u[:, i], vec)
        vec = vec + (alphas[i] - beta)[:, None] * mem_w[:, i]
    new = LBFGSState(state.count + 1, x, grad, mem_w, mem_u, rho)
    return -1.0 * vec, new


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (optax's ``_cubicmin``); NaN where there is none."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    e1 = fb - fa - C * db
    e2 = fc - fa - C * dc
    A = (dc ** 2 * e1 + (-(db ** 2)) * e2) / denom
    B = ((-(dc ** 3)) * e1 + db ** 3 * e2) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a (optax's ``_quadmin``)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    err = value - value_init - _LS_SLOPE_RTOL * stepsize * slope_init
    approx = slope - (2 * _LS_SLOPE_RTOL - 1.0) * slope_init
    delta = value - value_init - _LS_APPROX_DEC_RTOL * value_init.abs()
    err = torch.minimum(torch.maximum(approx, delta), err)
    err = torch.clamp_min(err, 0.0)
    return torch.where(torch.isnan(err), torch.full_like(err, math.inf), err)


def _curvature_error(slope, slope_init):
    err = torch.clamp_min(slope.abs() - _LS_CURV_RTOL * slope_init.abs(),
                          0.0)
    return torch.where(torch.isnan(err), torch.full_like(err, math.inf), err)


def zoom_linesearch(value_and_grad, x, u, value, grad,
                    max_steps=_LS_MAX_STEPS):
    """``optax.scale_by_zoom_linesearch`` with ``initial_guess_strategy=
    'one'``, for every row of a batch at once: each row runs its own
    search, frozen once it is done or has failed. Returns ``(stepsize,
    value, grad, count, n_syncs)``: each row's accepted step, value and
    gradient there, and its iterations."""
    f32 = dict(dtype=x.dtype, device=x.device)
    P = x.shape[0]
    slope0 = _vdot(u, grad)
    zero = torch.zeros(P, **f32)
    st = dict(count=torch.zeros(P, dtype=torch.int32, device=x.device),
              stepsize=zero, value=value, grad=grad, slope=slope0,
              decrease_error=torch.full((P,), math.inf, **f32),
              interval_found=torch.zeros(P, dtype=torch.bool,
                                         device=x.device),
              low=zero, value_low=value, slope_low=slope0,
              high=zero, value_high=value, slope_high=slope0,
              cubic_ref=zero, value_cubic_ref=value,
              safe_stepsize=zero, safe_value=value, safe_grad=grad)
    active = torch.ones(P, dtype=torch.bool, device=x.device)
    n_syncs = 0
    while True:
        st, active = _linesearch_iteration(value_and_grad, x, u, value,
                                           slope0, st, active, max_steps)
        n_syncs += 1
        if not bool(active.any()):
            break
    return st["stepsize"], st["value"], st["grad"], st["count"], n_syncs


def _linesearch_iteration(value_and_grad, x, u, value_init, slope_init, st,
                          active, max_steps):
    """One iteration of the batched zoom line search: the interval search
    on rows without an interval, the zoom on rows with one, one batched
    evaluation of the objective, then the safe step on rows that failed.
    Rows that are no longer ``active`` keep their state."""
    count, found = st["count"], st["interval_found"]
    low, high = st["low"], st["high"]
    v_low, s_low = st["value_low"], st["slope_low"]
    v_high = st["value_high"]
    # the search's next trial step: the guess 1, then doubling
    new_step = torch.where(count == 0, torch.ones_like(low),
                           _LS_INCREASE * st["stepsize"])
    # the zoom's: cubic, else quadratic, else bisection of [low, high]
    delta = (high - low).abs()
    left, right = torch.minimum(high, low), torch.maximum(high, low)
    cubic = _cubicmin(low, v_low, s_low, high, v_high, st["cubic_ref"],
                      st["value_cubic_ref"])
    use_cubic = (cubic > left + 0.2 * delta) & (cubic < right - 0.2 * delta)
    quad = _quadmin(low, v_low, s_low, high, v_high)
    use_quad = ~use_cubic & (quad > left + 0.1 * delta) \
        & (quad < right - 0.1 * delta)
    middle = torch.where(use_cubic, cubic, st["cubic_ref"])
    middle = torch.where(use_quad, quad, middle)
    middle = torch.where(~use_cubic & ~use_quad, (low + high) / 2.0, middle)
    step = torch.where(found, middle, new_step)

    v_new, g_new = value_and_grad(x + step[:, None] * u)
    s_new = _vdot(g_new, u)
    dec = _decrease_error(step, v_new, s_new, value_init, slope_init)
    curv = _curvature_error(s_new, slope_init)
    done = torch.maximum(dec, curv) <= 0.0
    last = count + 1 >= max_steps

    # interval search (rows without an interval)
    high_to_new = (dec > 0.0) | ((v_new >= st["value"]) & (count > 0))
    low_to_new = (s_new >= 0.0) & ~high_to_new
    a_low = torch.where(low_to_new, step, st["stepsize"])
    a_vlow = torch.where(low_to_new, v_new, st["value"])
    a_slow = torch.where(low_to_new, s_new, st["slope"])
    a_high = torch.where(low_to_new, st["stepsize"], step)
    a_vhigh = torch.where(low_to_new, st["value"], v_new)
    a_shigh = torch.where(low_to_new, st["slope"], s_new)
    a_found = high_to_new | low_to_new | done
    a_safe = dec <= 0.0

    # zoom (rows with an interval)
    z_safe = (dec <= 0.0) & (v_new < st["safe_value"])
    high_to_mid = (dec > 0.0) | (v_new >= v_low)
    high_to_low = (s_new * (high - low) >= 0.0) & ~high_to_mid
    z_high = torch.where(high_to_low, low, torch.where(high_to_mid, step,
                                                       high))
    z_vhigh = torch.where(high_to_low, v_low,
                          torch.where(high_to_mid, v_new, v_high))
    z_shigh = torch.where(high_to_low, s_low,
                          torch.where(high_to_mid, s_new, st["slope_high"]))
    z_low = torch.where(high_to_mid, low, step)
    z_vlow = torch.where(high_to_mid, v_low, v_new)
    z_slow = torch.where(high_to_mid, s_low, s_new)
    z_ref_high = high_to_mid | high_to_low
    z_ref = torch.where(z_ref_high, high, low)
    z_vref = torch.where(z_ref_high, v_high, v_low)

    pick = lambda zoom, search: torch.where(found, zoom, search)
    take_safe = pick(z_safe, a_safe)
    safe_step = torch.where(take_safe, step, st["safe_stepsize"])
    safe_value = torch.where(take_safe, v_new, st["safe_value"])
    safe_grad = common.where_chains(take_safe, g_new, st["safe_grad"])
    too_small = delta <= _LS_INTERVAL_THRESHOLD
    failed = pick(last | (too_small & (safe_step > 0.0)), last) & ~done

    new = dict(
        count=count + 1, stepsize=step, value=v_new, grad=g_new,
        slope=s_new, decrease_error=dec,
        interval_found=pick(found, a_found),
        low=pick(z_low, a_low), value_low=pick(z_vlow, a_vlow),
        slope_low=pick(z_slow, a_slow),
        high=pick(z_high, a_high), value_high=pick(z_vhigh, a_vhigh),
        slope_high=pick(z_shigh, a_shigh),
        cubic_ref=pick(z_ref, a_low), value_cubic_ref=pick(z_vref, a_vlow),
        safe_stepsize=safe_step, safe_value=safe_value, safe_grad=safe_grad)
    # a failed row falls back to the safe step (sufficient decrease only),
    # or to it anyway when the trial left the domain
    fall_back = failed & ((safe_step > 0.0) | torch.isinf(dec))
    new["stepsize"] = torch.where(fall_back, safe_step, step)
    new["value"] = torch.where(fall_back, safe_value, v_new)
    new["grad"] = common.where_chains(fall_back, safe_grad, g_new)
    st = {k: (common.where_chains(active, v, st[k]) if torch.is_tensor(v)
              else v) for k, v in new.items()}
    return st, active & ~(done | failed)


def lbfgs_step(value_and_grad, state, x, value, grad):
    """One ``optax.lbfgs`` iteration for every path: the direction, the
    zoom line search along it, the step. Returns ``(x_new, value_new,
    grad_new, state, n_syncs)``."""
    u, state = lbfgs_direction(state, x, grad)
    lr, v_new, g_new, _count, n_syncs = zoom_linesearch(
        value_and_grad, x, u, value, grad)
    return x + lr[:, None] * u, v_new, g_new, state, n_syncs


def _lbfgs_path(box, x0, max_iters, memory):
    """``max_iters`` L-BFGS iterations of every path from ``x0`` (``(P,
    d)``), carrying the ``(J, d)`` rings of accepted curvature pairs and
    the diagonal ``alpha``. Returns the per-iterate stacks ``(P, T, ...)``
    of theta, g (grad of box = grad log p), S, Y, alpha, pair mask and ok,
    and the line searches' host synchronisations."""
    P, d = x0.shape
    J = int(memory)
    vg = value_and_grad_of(lambda z: -box(z))
    x = x0
    val, grad = vg(x)
    opt = lbfgs_init(x, J)
    S = x.new_zeros((P, J, d))
    Y = x.new_zeros((P, J, d))
    alpha = torch.ones_like(x)
    pmask = torch.zeros((P, J), dtype=torch.bool, device=x.device)
    outs, syncs = [], 0
    for _ in range(int(max_iters)):
        x_new, val_new, grad_new, opt, n = lbfgs_step(vg, opt, x, val, grad)
        syncs += n
        s = x_new - x
        y = grad_new - grad          # gradients of NEGATIVE log p
        finite = torch.isfinite(val_new) \
            & torch.isfinite(x_new).all(dim=-1) \
            & torch.isfinite(grad_new).all(dim=-1)
        curv_ok = _vdot(s, y) > _CURV_EPS * torch.linalg.vector_norm(
            s, dim=-1) * torch.linalg.vector_norm(y, dim=-1)
        ok = finite & curv_ok
        # shift-in the accepted pair (the oldest drops off row 0)
        S = common.where_chains(ok, torch.cat([S[:, 1:], s[:, None]], 1), S)
        Y = common.where_chains(ok, torch.cat([Y[:, 1:], y[:, None]], 1), Y)
        pmask = common.where_chains(
            ok, torch.cat([pmask[:, 1:], torch.ones_like(pmask[:, :1])], 1),
            pmask)
        alpha = _diag_bfgs_update(alpha, s, y, ok)
        # a rejected step must not poison the carried point
        x = common.where_chains(finite, x_new, x)
        val = torch.where(finite, val_new, val)
        grad = common.where_chains(finite, grad_new, grad)
        outs.append((x, -grad, S, Y, alpha, pmask, ok))
    stacked = [torch.stack(v, dim=1) for v in zip(*outs)]
    return stacked, syncs


def _compact_pieces(S, Y, alpha, pmask):
    """The compact representation's pieces, batched: ``(G, mid)`` with
    ``G = R^{-1}`` and ``mid = G^T (diag(D) + E) G``."""
    J = S.shape[-2]
    dt = S.dtype
    STY = S @ Y.transpose(-1, -2)                     # (..., J, J)
    unit = torch.where(pmask, 0.0, 1.0).to(dt)
    R = torch.triu(STY) + torch.diag_embed(unit)
    D = torch.diagonal(STY, dim1=-2, dim2=-1) * pmask
    E = Y @ (alpha[..., :, None] * Y.transpose(-1, -2))
    eye = torch.eye(J, dtype=dt, device=S.device).expand(R.shape)
    G = torch.linalg.solve_triangular(R, eye, upper=True)
    mid = G.transpose(-1, -2) @ (torch.diag_embed(D) + E) @ G
    return G, mid


def _gauss_pieces(S, Y, alpha, pmask):
    """Each iterate's Gaussian factorization from its ``(J, d)`` buffers
    (any leading batch).

    Returns ``(W, lam, logdet, ok)`` with ``W (..., d, K)`` orthonormal
    columns, ``K = min(d, 2J)``: ``Sigma = sqrt(a)(I + W diag(lam) W^T)
    sqrt(a)``. Masked (absent) pairs have zero rows in S/Y, so their
    contribution vanishes; R gets unit diagonal there to stay invertible.
    A non-finite input gives ``ok`` False (and zero W, lam) where the JAX
    package's factorisations would carry NaN."""
    G, mid = _compact_pieces(S, Y, alpha, pmask)
    zeros = torch.zeros_like(G)
    M2 = torch.cat([torch.cat([mid, -G.transpose(-1, -2)], -1),
                    torch.cat([-G, zeros], -1)], -2)      # (..., 2J, 2J)
    U = torch.cat([S.transpose(-1, -2),
                   alpha[..., :, None] * Y.transpose(-1, -2)], -1)
    Ahat = U / torch.sqrt(alpha)[..., :, None]            # (..., d, 2J)
    finite = torch.isfinite(Ahat).flatten(-2).all(-1) \
        & torch.isfinite(M2).flatten(-2).all(-1)
    Ahat = torch.where(finite[..., None, None], Ahat, torch.zeros_like(Ahat))
    Q, Ra = torch.linalg.qr(Ahat, mode="reduced")
    C = Ra @ torch.where(finite[..., None, None], M2,
                         torch.zeros_like(M2)) @ Ra.transpose(-1, -2)
    C = 0.5 * (C + C.transpose(-1, -2))
    lam, V = torch.linalg.eigh(C)
    W = Q @ V
    ok = finite & torch.isfinite(lam).all(-1) \
        & torch.isfinite(W).flatten(-2).all(-1) \
        & (1.0 + lam > _PD_EPS).all(-1) \
        & torch.isfinite(alpha).all(-1) & (alpha > 0).all(-1)
    lam = torch.where(ok[..., None], lam, torch.zeros_like(lam))
    W = torch.where(ok[..., None, None], W, torch.zeros_like(W))
    logdet = torch.log(alpha).sum(-1) + torch.log1p(lam).sum(-1)
    return W, lam, logdet, ok


def _sigma_mv(v, alpha, S, Y, pmask):
    """Sigma @ v through the compact representation (the Newton shift
    mu = theta + Sigma grad), batched; same masking as
    :func:`_gauss_pieces`."""
    G, mid = _compact_pieces(S, Y, alpha, pmask)
    u1 = (S @ v[..., :, None])[..., 0]                    # (..., J)
    u2 = (Y @ (alpha * v)[..., :, None])[..., 0]
    t1 = (mid @ u1[..., None])[..., 0] \
        - (G.transpose(-1, -2) @ u2[..., None])[..., 0]
    t2 = -(G @ u1[..., None])[..., 0]
    return alpha * v + (S.transpose(-1, -2) @ t1[..., None])[..., 0] \
        + alpha * (Y.transpose(-1, -2) @ t2[..., None])[..., 0]


def _sample_gauss(z, mu, alpha, W, lam):
    """Draws and their log-q from N(mu, Sigma) in factored form, from the
    standard normals ``z`` (``(..., n, d)``; ``mu``, ``alpha`` ``(...,
    d)``, ``W`` ``(..., d, K)``, ``lam`` ``(..., K)``)."""
    d = mu.shape[-1]
    scale = torch.sqrt(1.0 + lam) - 1.0                   # (..., K)
    proj = (z @ W) * scale[..., None, :]
    x = mu[..., None, :] + torch.sqrt(alpha)[..., None, :] \
        * (z + proj @ W.transpose(-1, -2))
    logdet = torch.log(alpha).sum(-1) + torch.log1p(lam).sum(-1)
    logq = -0.5 * d * _LOG_2PI - 0.5 * logdet[..., None] \
        - 0.5 * (z * z).sum(-1)
    return x, logq


def _finite_or_neg_inf(v):
    return torch.where(torch.isfinite(v), v, torch.full_like(v, -math.inf))


def _box_rows(box, x):
    """``box`` over the rows of ``x`` (``(..., d)``), at most
    ``_ELBO_ROWS`` rows a call."""
    flat = x.reshape(-1, x.shape[-1])
    out = torch.cat([box(flat[i:i + _ELBO_ROWS])
                     for i in range(0, flat.shape[0], _ELBO_ROWS)])
    return out.reshape(x.shape[:-1])


def _best_iterates(box, path, z_elbo):
    """Score every iterate of every path by its Monte-Carlo ELBO from the
    normals ``z_elbo`` (``(P, T, M, d)``) and pick each path's best.
    Returns ``(mu, alpha, W, lam)`` at the best iterates, the best ELBO
    and its index, both ``(P,)``."""
    theta, g, S, Y, alpha, pmask, ok_it = path
    W, lam, _logdet, ok_g = _gauss_pieces(S, Y, alpha, pmask)
    mu = theta + _sigma_mv(g, alpha, S, Y, pmask)
    valid = ok_it & ok_g & torch.isfinite(mu).all(-1)
    xs, logqs = _sample_gauss(z_elbo, mu, alpha, W, lam)    # (P,T,M,d)
    logps = _finite_or_neg_inf(_box_rows(box, xs))
    elbo = (logps - logqs).mean(-1)
    elbo = torch.where(valid & torch.isfinite(elbo), elbo,
                       torch.full_like(elbo, -math.inf))
    best = torch.argmax(elbo, dim=-1)
    rows = torch.arange(best.shape[0], device=best.device)
    return (mu[rows, best], alpha[rows, best], W[rows, best],
            lam[rows, best], elbo[rows, best], best)


def pathfinder(initial_vals, log_kernel, settings=None, *, n_paths=8,
               n_draws=1000, n_draws_per_path=None, max_iters=60, memory=6,
               n_elbo_draws=25, jitter_scale=2.0, key=None, dtype=None,
               device=None) -> PathfinderResult:
    """Multi-path Pathfinder (module docstring).

    ``initial_vals`` seeds path 0; the other ``n_paths - 1`` paths start
    from Gaussian ``jitter_scale``-sized perturbations in unconstrained
    space. ``memory`` is the L-BFGS history J (covariance rank <= 2J).
    Draws: each path contributes ``n_draws_per_path`` (default
    ``ceil(2 * n_draws / n_paths)``, at least 25) from its best-ELBO
    iterate; the pool is Pareto-smoothed and resampled to ``n_draws``
    without replacement (Gumbel top-k). ``log_kernel`` is batched;
    ``key`` is a seed or a ``torch.Generator`` (``None``: the settings'
    ``rng_seed_value``); ``device`` defaults to that of ``initial_vals``,
    else the card.
    """
    if settings is None:
        settings = AlgoSettings()
    if not isinstance(settings, AlgoSettings):
        raise TypeError(f"settings must be AlgoSettings or None; got "
                        f"{type(settings).__name__}")
    initial_vals, (log_kernel,), unravel = coerce_model(
        initial_vals, log_kernel, device=device)
    n_paths = int(n_paths)
    if n_paths < 1:
        raise ValueError(f"n_paths must be >= 1, got {n_paths}")
    if n_draws_per_path is None:
        n_draws_per_path = max(-(-2 * int(n_draws) // n_paths), 25)
    pool = n_paths * int(n_draws_per_path)
    if pool < int(n_draws):
        raise ValueError(
            f"resampling pool {pool} (= n_paths * n_draws_per_path) is "
            f"smaller than n_draws={n_draws}")

    prob = common.setup_problem(initial_vals, log_kernel, settings,
                                n_chains=n_paths, dtype=dtype, device=device)
    box = prob.box_log_kernel
    d = prob.n_vals
    f32 = dict(dtype=prob.dtype, device=prob.device)
    gen = resolve_key(key, settings, prob.device)

    jit = torch.randn((n_paths, d), generator=gen, **f32) * jitter_scale
    jit[0] = 0.0
    path, syncs = _lbfgs_path(box, prob.first_draw + jit, max_iters, memory)
    with torch.no_grad():
        z_elbo = torch.randn((n_paths, int(max_iters), int(n_elbo_draws), d),
                             generator=gen, **f32)
        mu, alpha, W, lam, elbos, bests = _best_iterates(box, path, z_elbo)
        z_fin = torch.randn((n_paths, int(n_draws_per_path), d),
                            generator=gen, **f32)
        xs, logq = _sample_gauss(z_fin, mu, alpha, W, lam)
        logp = _finite_or_neg_inf(_box_rows(box, xs))

        # pooled PSIS resampling without replacement (Gumbel top-k)
        lw = (logp - logq).reshape(-1)
        S_pool = lw.shape[0]
        M_tail = int(min(0.2 * S_pool, 3.0 * math.sqrt(S_pool)))
        if M_tail >= 5:
            lw_smooth, khat = _psis_smooth_one(lw, M_tail)
        else:
            lw_smooth = lw - torch.logsumexp(lw, dim=0)
            khat = torch.tensor(math.inf, **f32)
        take = stats.gumbel_topk(gen, lw_smooth, int(n_draws))

    draws_z = xs.reshape(-1, d)[take]
    return PathfinderResult(
        draws=common.finalize_draws(draws_z, prob),
        log_p=lw[take] + logq.reshape(-1)[take],
        log_q=logq.reshape(-1)[take], pareto_k=khat,
        elbo=elbos, best_iter=bests, n_lbfgs_iters=path[6].sum(dim=-1),
        unravel=unravel, host_syncs=syncs, _draws_z=draws_z,
        _codes=prob.codes, _lb=prob.lower_bounds, _ub=prob.upper_bounds,
        _vals_bound=prob.vals_bound,
    )
