"""Carry data and sampler state from the JAX package into this one.

Each function takes arrays as the JAX package holds them — any object
``numpy.asarray`` accepts, so a JAX array works without this package
importing JAX — and returns the port's tensors on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from mcmc_tpu_torch import adaptation
from mcmc_tpu_torch.ops.fused_logreg import FusedHMCState
from mcmc_tpu_torch.samplers.hmc import HMCState

__all__ = ["to_tensor", "glm_data", "fused_state", "hmc_state"]


def to_tensor(a, device=None, dtype=None):
    """One array as a tensor on ``device``, keeping its dtype unless
    ``dtype`` is given."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def glm_data(X, y, device=None):
    """GLM data ``(X (n_data, dim), y (n_data,))`` as float32 tensors."""
    return (to_tensor(X, device, torch.float32),
            to_tensor(y, device, torch.float32))


def fused_state(position, potential, dim_padded, device=None) -> FusedHMCState:
    """A fused HMC state from positions ``(n_chains, dim)`` or already
    padded ``(n_chains, dim_padded)`` and potentials ``(n_chains,)``; the
    position is zero-padded to ``dim_padded`` columns."""
    pos = to_tensor(position, device, torch.float32)
    if pos.shape[1] > dim_padded:
        raise ValueError(f"position has {pos.shape[1]} columns, more than "
                         f"dim_padded={dim_padded}")
    zp = torch.zeros((pos.shape[0], dim_padded), dtype=torch.float32,
                     device=pos.device)
    zp[:, :pos.shape[1]] = pos
    return FusedHMCState(position=zp,
                         potential=to_tensor(potential, device, torch.float32))


def hmc_state(state, device=None) -> HMCState:
    """An :class:`~mcmc_tpu_torch.samplers.hmc.HMCState` from the JAX
    package's chain-batched ``HMCState`` (the vmapped ``init`` output), or
    any object with the same fields."""
    da = state.da
    return HMCState(
        position=to_tensor(state.position, device),
        potential=to_tensor(state.potential, device),
        da=adaptation.DualAveraging(*[to_tensor(v, device) for v in da]),
        draw_ind=to_tensor(state.draw_ind, device, torch.int32),
        inv_mass=to_tensor(state.inv_mass, device),
        mass_chol=to_tensor(state.mass_chol, device),
        w_count=to_tensor(state.w_count, device, torch.int32),
        w_mean=to_tensor(state.w_mean, device),
        w_m2=to_tensor(state.w_m2, device),
    )
