"""Generated quantities and posterior-predictive sampling (PyTorch port of
``mcmc_tpu.predictive``).

The post-processing step is one batched map over the kept draws (the analog
of Stan's ``generated quantities`` block): ``fn`` is called on the flattened
``(n_keep [* n_chains], n_vals)`` draw array, optionally in chunks of
``batch_size`` draws so that a large predictive never holds more than that
many draws' intermediates at once.

API differences from the JAX package: ``fn`` is batched over draws,
``fn(params: (B, d)) -> pytree of (B, ...)`` tensors; a stochastic ``fn``
takes the run's ``torch.Generator`` first, ``fn(gen, params)``, where the
JAX package hands each draw its own key. A deterministic ``fn`` (one that
treats draws independently) gives the same result chunked or not, bit for
bit; a stochastic one draws the chunks one after another from the one
generator, so its chunked result has the same law as the unchunked one and
repeats bit for bit under one seed and one ``batch_size`` (torch's
generators are not addressable per draw, as JAX's split keys are).
"""

from __future__ import annotations

import torch

from mcmc_tpu_torch.pytree import _flatten
from mcmc_tpu_torch.results import SamplerResult
from mcmc_tpu_torch.samplers._resolve import resolve_device

__all__ = ["generated_quantities", "posterior_predictive"]


def _flat_draws(draws, device):
    if isinstance(draws, SamplerResult):
        draws = draws.draws
    d = torch.as_tensor(draws, device=resolve_device(device, draws))
    if d.ndim == 1:
        d = d[:, None]
    lead = tuple(d.shape[:-1])
    return d.reshape(-1, d.shape[-1]), lead


def _concat(parts):
    """Concatenate the chunks' outputs (pytrees of ``(b, ...)`` tensors)
    along their leading axis."""
    _leaves, rebuild = _flatten(parts[0])
    cols = zip(*(_flatten(p)[0] for p in parts))
    return rebuild([torch.cat(list(c), dim=0) for c in cols])


def generated_quantities(draws, fn, *, key=None, batch_size=None,
                         device=None):
    """Map a batched function over every kept draw.

    ``draws`` is a :class:`SamplerResult` or a draw tensor (``(n_keep,
    n_vals)`` or ``(n_keep, n_chains, n_vals)``, constrained space).
    ``fn(params: (B, n_vals)) -> pytree`` computes any derived quantity
    with a leading draw axis on every leaf; with ``key`` given (a seed or a
    ``torch.Generator`` on the draws' device), ``fn(gen, params)`` also gets
    the generator (stochastic quantities — see
    :func:`posterior_predictive`). Returns the pytree with each leaf led by
    the draw axes of the input (``(n_keep, ...)`` or ``(n_keep, n_chains,
    ...)``).

    ``batch_size`` bounds how many draws are mapped at once (a loop over
    chunks) — use it when ``fn`` produces large intermediates. Draws given
    as a tensor stay on its device; others go to ``device`` (default: the
    card).
    """
    flat, lead = _flat_draws(draws, device)
    n = flat.shape[0]
    if key is not None:
        gen = key if isinstance(key, torch.Generator) else \
            torch.Generator(device=flat.device).manual_seed(int(key))
        call = lambda p: fn(gen, p)
    else:
        call = fn
    b = n if batch_size is None or int(batch_size) >= n else int(batch_size)
    if b < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    parts = [call(flat[i:i + b]) for i in range(0, n, b)]
    out = parts[0] if len(parts) == 1 else _concat(parts)
    leaves, rebuild = _flatten(out)
    return rebuild([x.reshape(lead + tuple(x.shape[1:])) for x in leaves])


def posterior_predictive(draws, predictive_fn, key, *, batch_size=None,
                         device=None):
    """Posterior-predictive sampling: one simulated dataset (or statistic)
    per kept draw. ``predictive_fn(gen, params: (B, d)) -> pytree``
    simulates new data given a batch of posterior draws, drawing from the
    ``torch.Generator`` ``gen`` (made from ``key``, a seed or a generator).
    Equivalent to ``generated_quantities(draws, predictive_fn, key=key)``
    — the named entry point of the workflow (``fit`` ->
    ``posterior_predictive`` -> predictive checks).
    """
    if key is None:
        raise ValueError("posterior_predictive requires a key (a seed or a "
                         "torch.Generator)")
    return generated_quantities(draws, predictive_fn, key=key,
                                batch_size=batch_size, device=device)
