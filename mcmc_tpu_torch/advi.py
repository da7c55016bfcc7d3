"""ADVI — automatic differentiation variational inference (PyTorch port of
``mcmc_tpu.advi``).

No reference analog — MCMCLib is sampling-only. This is the classic
fixed-form Gaussian VI of Kucukelbir et al. (2017, JMLR; Stan's
``variational`` mode): maximize the reparameterized Monte-Carlo ELBO

    ELBO(phi) = E_{z~N(0,I)}[ box_log_kernel(mu + L z) ] + entropy(q)

over an unconstrained-space Gaussian ``q`` — mean-field (diagonal, the
default) or full-rank (Cholesky). The entropy is closed-form
(``sum log sd + d/2 log 2*pi*e``), the expectation a ``n_mc`` per-step
sample average; bounded problems reuse the samplers' transform +
log-Jacobian stack so ``q`` lives exactly where the chains do. The final
ELBO is a lower bound on ``log Z`` (tight exactly when q matches the
posterior), cross-checkable against ``thermo_evidence`` and
``nested_sampling``.

The optimisation is a Python loop of Adam steps (``optax.adam`` under
``optax.exponential_decay(learning_rate, n_steps, 0.01)``, written out in
:mod:`mcmc_tpu_torch._optim`), each drawing its ``(n_mc, d)``
reparameterization batch from the run's ``torch.Generator`` and evaluating
the batched log-kernel on it once; the step count, the learning rate and
the tail average's counter are host numbers and the ELBO trace is written
into a preallocated tensor, so nothing waits for the card until the
result is read. Full-rank parameterizes ``L`` as a strict lower triangle
(``torch.tril_indices(d, d, -1)``, row-major as ``jnp.tril_indices(d,
k=-1)``) plus an exp-reparameterized diagonal.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from mcmc_tpu_torch import bounds as bounds_mod
from mcmc_tpu_torch._optim import adam_init, adam_step, exponential_decay
from mcmc_tpu_torch.pytree import coerce_model
from mcmc_tpu_torch.samplers import common
from mcmc_tpu_torch.samplers._resolve import resolve_key
from mcmc_tpu_torch.settings import AlgoSettings

__all__ = ["advi", "ADVIResult"]


@dataclasses.dataclass
class ADVIResult:
    """Fitted Gaussian variational approximation (unconstrained space).

    Attributes:
        mean_z: variational mean in unconstrained coordinates.
        mean: the same point mapped to constrained space.
        sd_z: marginal standard deviations (diag of ``L L^T``, sqrt).
        chol: the full Cholesky factor ``L`` (diagonal matrix when
            mean-field).
        elbo: final smoothed ELBO — a lower bound on ``log Z`` when
            ``log_kernel`` is a normalized joint.
        elbo_trace: per-step MC ELBO estimates (monitor convergence; a
            still-rising tail means raise ``n_steps``).
    """

    mean_z: Any
    mean: Any
    sd_z: Any
    chol: Any
    elbo: Any
    elbo_trace: Any
    unravel: Any = None   # pytree-input runs: unravel_draws(draw(...), .)
    _codes: Any = dataclasses.field(repr=False, default=None)
    _lb: Any = dataclasses.field(repr=False, default=None)
    _ub: Any = dataclasses.field(repr=False, default=None)
    _vals_bound: bool = dataclasses.field(repr=False, default=False)

    def draw(self, key, n: int):
        """``n`` draws from q, mapped to constrained space — posterior
        approximation or chain initialization. ``key`` is a seed or a
        ``torch.Generator`` on the result's device."""
        gen = resolve_key(key, AlgoSettings(), self.mean_z.device)
        z = torch.randn((int(n), self.mean_z.shape[0]), generator=gen,
                        dtype=self.mean_z.dtype, device=self.mean_z.device)
        x = self.mean_z + z @ self.chol.T
        if not self._vals_bound:
            return x
        return bounds_mod.inv_transform(x, self._codes, self._lb, self._ub)


def _objective(box, d, full_rank, dtype, device):
    """``(unpack, neg_elbo)`` of the JAX package's ``advi``: ``unpack(phi)
    -> (mu, L, diag)`` and ``neg_elbo(phi, zs)``, the negative MC ELBO of
    the parameter dict ``phi`` on the standard normals ``zs`` ``(n_mc,
    d)``."""
    if full_rank:
        rows, cols = torch.tril_indices(d, d, -1, device=device)
    log_2pi_e = 0.5 * d * (1.0 + math.log(2 * math.pi))

    def unpack(phi):
        mu = phi["mu"]
        diag = torch.exp(phi["log_diag"])
        L = torch.diag(diag)
        if full_rank:
            L = L + torch.zeros((d, d), dtype=dtype, device=device) \
                .index_put((rows, cols), phi["off"])
        return mu, L, diag

    def neg_elbo(phi, zs):
        mu, L, diag = unpack(phi)
        xs = mu + zs @ L.T
        # per-sample masking with safe-input substitution: one bad MC sample
        # (NaN/inf value or backward pass outside support) would otherwise
        # NaN the whole summed gradient. Masking only the output is not
        # enough (0 * NaN-cotangent is NaN), so bad rows are replaced by
        # the variational mean, whose gradient path is cut; the elementwise
        # gradient guard in the step remains the last resort.
        with torch.no_grad():
            ok = torch.isfinite(box(xs.detach()))
        xs_safe = torch.where(ok[:, None], xs, mu.detach()[None, :])
        lps = torch.where(ok, box(xs_safe), torch.zeros((), dtype=dtype,
                                                        device=device))
        mean_lp = lps.sum() / torch.clamp_min(ok.sum(), 1)
        # all-masked batch: only the entropy pulls (widening q until it
        # finds support) — still finite, never NaN
        entropy = torch.log(diag).sum() + log_2pi_e
        return -(mean_lp + entropy)

    return unpack, neg_elbo


def _value_and_grad(neg_elbo, phi, zs):
    """The negative ELBO and its gradient in each entry of ``phi``, the
    non-finite gradient entries zeroed; neither carries a graph."""
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_(True) for k, v in phi.items()}
        loss = neg_elbo(leaves, zs)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    g = {k: torch.where(torch.isfinite(v), v, torch.zeros_like(v))
         for k, v in zip(leaves, grads)}
    return loss.detach(), g


def _optimize(neg_elbo, phi, n_steps, learning_rate, draw):
    """``n_steps`` Adam steps on ``neg_elbo`` from ``phi`` under the
    decayed rate, ``draw(t)`` giving step t's standard normals; returns
    the tail-averaged parameters and the per-step ELBO trace."""
    T = int(n_steps)
    # decayed steps + a Polyak average over the final fifth kill the
    # O(lr) stationary jitter of constant-step stochastic ELBO ascent
    sched = exponential_decay(learning_rate, T, 0.01)
    tail_start = (4 * T) // 5
    opt = adam_init(phi)
    acc = {k: torch.zeros_like(v) for k, v in phi.items()}
    cnt = 0
    p0 = next(iter(phi.values()))
    elbo_trace = torch.empty((T,), dtype=p0.dtype, device=p0.device)
    for t in range(T):
        loss, g = _value_and_grad(neg_elbo, phi, draw(t))
        phi, opt = adam_step(phi, g, opt, sched)
        if t >= tail_start:
            acc = {k: acc[k] + phi[k] for k in acc}
            cnt += 1
        elbo_trace[t] = -loss
    return {k: v / float(max(cnt, 1)) for k, v in acc.items()}, elbo_trace


def advi(initial_vals, log_kernel, settings=None, *, full_rank=False,
         n_steps=2000, n_mc=8, learning_rate=0.05, key=None,
         dtype=None, device=None) -> ADVIResult:
    """Fit a Gaussian variational approximation by reparameterized ELBO
    ascent (module docstring).

    ``log_kernel`` is batched: ``(n_mc, d) -> (n_mc,)``. ``full_rank=False``
    (mean-field) learns per-coordinate scales only — fast, underestimates
    correlated-posterior variances; ``True`` learns the full Cholesky
    (d*(d+1)/2 parameters). ``n_mc`` reparameterization samples per step
    trade gradient variance for cost. ``key`` is a seed or a
    ``torch.Generator`` (``None``: the settings' ``rng_seed_value``);
    ``device`` defaults to that of ``initial_vals``, else the card.
    """
    if settings is None:
        settings = AlgoSettings()
    if not isinstance(settings, AlgoSettings):
        raise TypeError(f"settings must be AlgoSettings or None; got "
                        f"{type(settings).__name__}")
    initial_vals, (log_kernel,), unravel = coerce_model(
        initial_vals, log_kernel, device=device)
    prob = common.setup_problem(initial_vals, log_kernel, settings,
                                n_chains=1, dtype=dtype, device=device)
    gen = resolve_key(key, settings, prob.device)
    d, dt, dev = prob.n_vals, prob.dtype, prob.device
    unpack, neg_elbo = _objective(prob.box_log_kernel, d, full_rank, dt, dev)

    phi = {"mu": prob.first_draw[0].clone(),
           "log_diag": torch.full((d,), -1.0, dtype=dt, device=dev)}
    if full_rank:
        phi["off"] = torch.zeros((d * (d - 1)) // 2, dtype=dt, device=dev)
    phi, elbo_trace = _optimize(
        neg_elbo, phi, n_steps, learning_rate,
        lambda t: torch.randn((int(n_mc), d), generator=gen, dtype=dt,
                              device=dev))

    with torch.no_grad():
        mu, L, diag = unpack(phi)
        sd_z = torch.sqrt((L * L).sum(dim=1))
        mean = mu
        if prob.vals_bound:
            mean = bounds_mod.inv_transform(mu, prob.codes,
                                            prob.lower_bounds,
                                            prob.upper_bounds)
    tail = elbo_trace[-max(int(n_steps) // 20, 1):]
    return ADVIResult(
        mean_z=mu, mean=mean, sd_z=sd_z, chol=L,
        elbo=tail.mean(), elbo_trace=elbo_trace, unravel=unravel,
        _codes=prob.codes, _lb=prob.lower_bounds, _ub=prob.upper_bounds,
        _vals_bound=prob.vals_bound,
    )
