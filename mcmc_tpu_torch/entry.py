"""One batched HMC transition of the flagship workload: the port's
counterpart of the JAX package's driver hook ``entry()``.

``entry()`` returns ``(fn, example_args)``: ``fn(gen, state)`` advances
1,024 chains of the 100-dimensional Bayesian logistic regression (1,000
observations, numpy-seeded data) by one HMC transition of 4 leapfrogs at
step 0.01 and returns the new positions and the accept decisions. It runs
on the card unless ``device=`` asks for another device.

    from mcmc_tpu_torch.entry import entry
    fn, args = entry()
    positions, accepted = fn(*args)
"""

from __future__ import annotations

import torch

from mcmc_tpu_torch import integrators, models
from mcmc_tpu_torch.samplers import common
from mcmc_tpu_torch.samplers._resolve import resolve_device
from mcmc_tpu_torch.samplers.hmc import build_hmc_kernel

__all__ = ["entry", "FLAGSHIP_DIM", "FLAGSHIP_DATA", "ENTRY_CHAINS"]

FLAGSHIP_DIM = 100
FLAGSHIP_DATA = 1000
ENTRY_CHAINS = 1024


def entry(device=None, n_chains=ENTRY_CHAINS):
    """``(fn, (gen, state))``: ``fn(gen, state) -> (positions (n_chains,
    100), accepted (n_chains,))``, one batched HMC transition on the
    flagship posterior from starts ``0.1 N(0, 1)``; ``gen`` is the
    transition's ``torch.Generator`` on ``device`` (default: the card)."""
    device = resolve_device(device)
    X, y, _ = models.make_logistic_regression_data(
        0, FLAGSHIP_DATA, FLAGSHIP_DIM, device=device)
    log_kernel = models.logistic_regression_model(X, y)
    precond = common.make_spd(None, FLAGSHIP_DIM, torch.float32, device)
    init, step = build_hmc_kernel(log_kernel,
                                  integrators.grad_of(log_kernel), precond,
                                  step_size=0.01, n_leap_steps=4)
    gen = torch.Generator(device=device).manual_seed(1)
    state = init(0.1 * torch.randn((n_chains, FLAGSHIP_DIM), generator=gen,
                                   device=device))
    gen.manual_seed(2)

    def fn(gen, state):
        with torch.no_grad():
            new_state, info = step(gen, state)
        return new_state.position, info["accepted"]

    return fn, (gen, state)
