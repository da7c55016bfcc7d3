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

The sampler's fast path: nested ``torch.func`` transforms cost milliseconds
of host dispatch per call whatever the size (hundreds of small launches for
one directional derivative of the 3-d funnel's metric;
``scripts/torch_softabs_metric_cost.py`` times them on the card), and RM-HMC
evaluates the metric ``n_leap (n_fp + 1)`` times a transition. So the returned ``metric_fn`` also carries
``metric_fn.tensor(x)`` (G alone) and ``metric_fn.tensor_and_derivative(x)``
(G and the cube ``(c, i, a, b) = dG_ab / dx_i``), which
:func:`mcmc_tpu_torch.rmhmc` calls in its place. Both take the Hessian (and
its ``d`` directional derivatives, in one ``vmap``) from a CUDA graph on
the card, captured at the first call for each shape (:func:`_graphed`), and
decompose it once with ``eigh``; the cube applies the Daleckii-Krein rule to
all ``d`` tangents at once, where ``d`` calls of ``torch.func.jvp`` on
``metric_fn`` decompose the same Hessian ``d`` times. The values are those
of ``metric_fn`` and its JVPs, the same operations in another order.
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
        return _softabs_eig(H, alpha)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _G, lam, Q = output
        ctx.alpha = inputs[1]
        ctx.mark_non_differentiable(lam, Q)
        ctx.save_for_forward(lam, Q)

    @staticmethod
    def jvp(ctx, dH, _dalpha):
        lam, Q = ctx.saved_tensors
        return _daleckii_krein(lam, Q, dH, ctx.alpha), None, None


def _softabs_eig(H, alpha):
    """``(G, lambda, Q)`` of a batch of symmetric Hessians ``(..., d, d)``:
    ``eigh``, then each eigenvalue through :func:`_softabs_f`."""
    # a non-finite Hessian (a point where the log-kernel overflows) gets
    # NaN, as the JAX package's eigh returns it; torch's eigh would raise
    # on it, so it decomposes the identity there instead
    finite = torch.isfinite(H).all(dim=-1).all(dim=-1)
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    lam, Q = torch.linalg.eigh(torch.where(finite[..., None, None], H, eye))
    lam = torch.where(finite[..., None], lam, torch.nan)
    Q = torch.where(finite[..., None, None], Q, torch.nan)
    G = (Q * _softabs_f(lam, alpha)[..., None, :]) @ Q.transpose(-1, -2)
    return G, lam, Q


def _daleckii_krein(lam, Q, dH, alpha):
    """The derivative ``dG`` of the SoftAbs map along the tangent ``dH``
    at ``H = Q diag(lam) Q^T`` (module docstring); ``dH`` may carry more
    batch dimensions than ``lam`` and ``Q``, which broadcast."""
    f = _softabs_f(lam, alpha)
    fp = _softabs_fprime(lam, alpha)
    dlam = lam[..., :, None] - lam[..., None, :]
    # relative coincidence threshold; below it the divided difference is
    # replaced by its limit (f'(l_i) + f'(l_j)) / 2
    alam = torch.abs(lam)
    thr = 1e-6 * (alam[..., :, None] + alam[..., None, :] + 1.0)
    apart = torch.abs(dlam) > thr
    safe = torch.where(apart, dlam, 1.0)
    J = torch.where(apart, (f[..., :, None] - f[..., None, :]) / safe,
                    0.5 * (fp[..., :, None] + fp[..., None, :]))
    Qt = Q.transpose(-1, -2)
    dG = Q @ (J * (Qt @ dH @ Q)) @ Qt
    # symmetrize away the eigh round-off asymmetry
    return 0.5 * (dG + dG.transpose(-1, -2))


def _graphed(fn):
    """``fn(x) -> tuple of tensors``, replayed on the card from a CUDA
    graph captured at the first call for each shape, dtype and device of
    ``x`` (one warm-up call on a side stream first, as CUDA graphs need);
    elsewhere ``fn`` itself. ``fn`` must launch the same work for every
    ``x`` of a shape and read nothing back to the host. Returns copies of
    the graph's outputs, which the next replay overwrites."""
    graphs = {}

    def call(x):
        if x.device.type != "cuda":
            return fn(x)
        key = (tuple(x.shape), x.dtype, x.device)
        if key not in graphs:
            with torch.cuda.device(x.device):
                static_x = x.detach().clone()
                main = torch.cuda.current_stream()
                side = torch.cuda.Stream()
                side.wait_stream(main)
                with torch.cuda.stream(side):
                    fn(static_x)
                main.wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    static_out = fn(static_x)
            graphs[key] = (graph, static_x, static_out)
        graph, static_x, static_out = graphs[key]
        static_x.copy_(x)
        graph.replay()
        return tuple(t.clone() for t in static_out)

    return call


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
    eigenvalues (module docstring). It carries the sampler's fast path,
    ``metric_fn.tensor`` and ``metric_fn.tensor_and_derivative`` (module
    docstring), which on the card capture ``log_kernel``'s derivatives in
    a CUDA graph: there ``log_kernel`` must read nothing back to the host.
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

    def hess_and_cube(x):
        # H, and its derivative along each coordinate: (c, i, a, b)
        eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
        return torch.func.vmap(
            lambda e: torch.func.jvp(hess_fn, (x,), (e.expand_as(x),)),
            out_dims=(None, 1))(eye)

    hess_graphed = _graphed(lambda x: (hess_fn(x),))
    cube_graphed = _graphed(hess_and_cube)

    def tensor(x):
        """G at the batch ``x (c, d)``: ``metric_fn(x)`` (module
        docstring)."""
        return _softabs_eig(hess_graphed(x)[0], alpha)[0]

    def tensor_and_derivative(x):
        """G at the batch ``x (c, d)`` and its derivative cube ``(c, i, a,
        b) = dG_ab / dx_i``: what ``d`` JVPs of ``metric_fn`` give, from
        one Hessian and one ``eigh`` (module docstring)."""
        H, dH = cube_graphed(x)
        G, lam, Q = _softabs_eig(H, alpha)
        return G, _daleckii_krein(lam[:, None], Q[:, None], dH, alpha)

    metric_fn.tensor = tensor
    metric_fn.tensor_and_derivative = tensor_and_derivative
    return metric_fn
