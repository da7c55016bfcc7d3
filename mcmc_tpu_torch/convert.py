"""Carry data and sampler state from the JAX package into this one.

Each function takes arrays as the JAX package holds them — any object
``numpy.asarray`` accepts, so a JAX array works without this package
importing JAX — and returns the port's tensors on ``device`` (default: the
card; the CPU for callers that pass ``device="cpu"``).
"""

from __future__ import annotations

import numpy as np
import torch

from mcmc_tpu_torch import adaptation
from mcmc_tpu_torch.ops.fused_logreg import FusedHMCState
from mcmc_tpu_torch.samplers._resolve import resolve_device
from mcmc_tpu_torch.samplers.chees import ChEESState
from mcmc_tpu_torch.samplers.de import DEState
from mcmc_tpu_torch.samplers.ghmc import GHMCState
from mcmc_tpu_torch.samplers.hmc import HMCState
from mcmc_tpu_torch.samplers.mala import MALAState
from mcmc_tpu_torch.samplers.mclmc import MAMSState, MCLMCState
from mcmc_tpu_torch.samplers.rmhmc import RMHMCState
from mcmc_tpu_torch.samplers.rwmh import RWMHState

__all__ = ["to_tensor", "glm_data", "gaussian_target", "fused_state",
           "hmc_state", "chees_state", "ghmc_state", "mclmc_state",
           "mams_state", "rwmh_state", "mala_state", "rmhmc_state",
           "de_state"]


def to_tensor(a, device=None, dtype=None):
    """One array as a tensor on ``device``, keeping its dtype unless
    ``dtype`` is given."""
    return torch.tensor(np.asarray(a), dtype=dtype,
                        device=resolve_device(device))


def glm_data(X, y, device=None):
    """GLM data ``(X (n_data, dim), y (n_data,))`` as float32 tensors."""
    return (to_tensor(X, device, torch.float32),
            to_tensor(y, device, torch.float32))


def gaussian_target(precision, mean=None, device=None):
    """A Gaussian target ``N(mean, P^{-1})`` as float32 tensors ``(precision,
    mean)`` for the fused Gaussian factories: ``precision`` ``(dim, dim)`` or
    a ``(dim,)`` diagonal, kept in the shape given (the factories pad it);
    ``mean`` ``(dim,)``, or ``None``, which stays ``None`` (zero mean)."""
    P = to_tensor(precision, device, torch.float32)
    if P.ndim not in (1, 2) or (P.ndim == 2 and P.shape[0] != P.shape[1]):
        raise ValueError(f"precision must be (dim, dim) or (dim,), got "
                         f"{tuple(P.shape)}")
    m = None if mean is None else to_tensor(mean, device, torch.float32)
    if m is not None and tuple(m.shape) != (P.shape[0],):
        raise ValueError(f"mean must be ({P.shape[0]},), got {tuple(m.shape)}")
    return P, m


def fused_state(position, potential, dim_padded, device=None) -> FusedHMCState:
    """A fused HMC state from positions ``(n_chains, dim)`` or already
    padded ``(n_chains, dim_padded)`` and potentials ``(n_chains,)``; the
    position is zero-padded to ``dim_padded`` columns."""
    device = resolve_device(device)
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


# state fields that are themselves named tuples, and the int32 counters
_NESTED = {"da": adaptation.DualAveraging, "wv": adaptation.WindowedVariance}
_INT32 = ("draw_ind", "count", "gen_ind")


def _sampler_state(cls, state, device):
    """A chain-batched state of the port's ``cls`` from the JAX package's
    state of the same fields (the vmapped ``init`` or ``step`` output)."""
    def conv(name, v):
        if name in _NESTED:
            sub = _NESTED[name]
            return sub(**{f: conv(f, getattr(v, f)) for f in sub._fields})
        return to_tensor(v, device, torch.int32 if name in _INT32 else None)
    return cls(**{f: conv(f, getattr(state, f)) for f in cls._fields})


def chees_state(state, device=None) -> ChEESState:
    """A :class:`~mcmc_tpu_torch.samplers.chees.ChEESState` from the JAX
    package's chain-batched ``ChEESState``, or any object with its fields."""
    return _sampler_state(ChEESState, state, device)


def ghmc_state(state, device=None) -> GHMCState:
    """A :class:`~mcmc_tpu_torch.samplers.ghmc.GHMCState` from the JAX
    package's chain-batched ``GHMCState``."""
    return _sampler_state(GHMCState, state, device)


def mclmc_state(state, device=None) -> MCLMCState:
    """A :class:`~mcmc_tpu_torch.samplers.mclmc.MCLMCState` from the JAX
    package's chain-batched ``MCLMCState``."""
    return _sampler_state(MCLMCState, state, device)


def mams_state(state, device=None) -> MAMSState:
    """A :class:`~mcmc_tpu_torch.samplers.mclmc.MAMSState` from the JAX
    package's chain-batched ``MAMSState``."""
    return _sampler_state(MAMSState, state, device)


def rwmh_state(state, device=None) -> RWMHState:
    """A :class:`~mcmc_tpu_torch.samplers.rwmh.RWMHState` from the JAX
    package's chain-batched ``RWMHState``."""
    return _sampler_state(RWMHState, state, device)


def mala_state(state, device=None) -> MALAState:
    """A :class:`~mcmc_tpu_torch.samplers.mala.MALAState` from the JAX
    package's chain-batched ``MALAState``."""
    return _sampler_state(MALAState, state, device)


def rmhmc_state(state, device=None) -> RMHMCState:
    """A :class:`~mcmc_tpu_torch.samplers.rmhmc.RMHMCState` from the JAX
    package's chain-batched ``RMHMCState``."""
    return _sampler_state(RMHMCState, state, device)


def de_state(state, device=None) -> DEState:
    """A :class:`~mcmc_tpu_torch.samplers.de.DEState` from the JAX
    package's ``DEState`` (the population on the leading axis, the
    generation counter a scalar)."""
    return _sampler_state(DEState, state, device)
