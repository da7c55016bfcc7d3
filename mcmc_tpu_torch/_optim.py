"""Adam and its decayed learning rate, written out as ``optax`` computes them.

The JAX package optimises with ``optax.adam`` (``map_laplace``'s search,
``advi``, ``svgd``). This module is that update term for term, on one
tensor or a dict of tensors, so a converted parameter set follows the same
path: the first and second moments, the bias corrections ``1 - b**t`` in
float32 as host numbers (no device tensor per step, so no host
synchronisation), and ``p + (-lr) * mu_hat / (sqrt(nu_hat) + eps)``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

__all__ = ["ADAM_B1", "ADAM_B2", "ADAM_EPS", "AdamState", "adam_init",
           "adam_direction", "adam_step", "exponential_decay"]

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class AdamState(NamedTuple):
    mu: Any          # first moments, the parameters' structure
    nu: Any          # second moments
    count: int       # updates taken (a host integer)


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: fn(*(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def adam_init(params) -> AdamState:
    zeros = _map(torch.zeros_like, params)
    return AdamState(mu=zeros, nu=_map(torch.zeros_like, params), count=0)


def _bias_correction(decay, t):
    """``1 - decay**t`` in float32, as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(t))


def adam_direction(g, mu, nu, t):
    """One tensor's Adam moments after gradient ``g`` at update ``t``
    (counted from 1) and its bias-corrected direction
    ``mu_hat / (sqrt(nu_hat) + eps)``: returns ``(direction, mu, nu)``."""
    mu = (1 - ADAM_B1) * g + ADAM_B1 * mu
    nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * nu
    upd = (mu / _bias_correction(ADAM_B1, t)) \
        / (torch.sqrt(nu / _bias_correction(ADAM_B2, t)) + ADAM_EPS)
    return upd, mu, nu


def adam_step(params, grads, state: AdamState, learning_rate):
    """``optax.apply_updates(params, adam(lr).update(grads, ...))`` for a
    tensor or a dict of tensors. ``learning_rate`` is a number or a
    schedule ``count -> number`` evaluated at the update count before this
    step (from 0), as ``optax.scale_by_schedule`` does. Returns the new
    parameters and state."""
    t = state.count + 1
    lr = learning_rate(state.count) if callable(learning_rate) \
        else learning_rate
    step = float(np.float32(-1.0) * np.float32(lr))
    out = _map(lambda g, m, v: adam_direction(g, m, v, t), grads, state.mu,
               state.nu)
    pick = lambda i: _map(lambda o: o[i], out) if isinstance(out, dict) \
        else out[i]
    new = _map(lambda p, u: p + step * u, params, pick(0))
    return new, AdamState(mu=pick(1), nu=pick(2), count=t)


def exponential_decay(init_value, transition_steps, decay_rate):
    """``optax.exponential_decay(init_value, transition_steps,
    decay_rate)``: ``count -> init_value * decay_rate ** (count /
    transition_steps)`` in float32 on the host (``init_value`` at count 0
    and below)."""
    T = int(transition_steps)
    if T <= 0 or decay_rate == 0:
        return lambda count: init_value

    def schedule(count):
        if count <= 0:
            return init_value
        p = np.float32(count) / np.float32(T)
        return float(np.float32(init_value)
                     * np.power(np.float32(decay_rate), p))
    return schedule
