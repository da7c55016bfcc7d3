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
from mcmc_tpu_torch._optim import AdamState
from mcmc_tpu_torch.evidence import _EvState
from mcmc_tpu_torch.laplace import LaplaceResult
from mcmc_tpu_torch.nested import _NSState
from mcmc_tpu_torch.ops.fused_logreg import FusedHMCState
from mcmc_tpu_torch.pathfinder import PathfinderResult
from mcmc_tpu_torch.samplers._resolve import resolve_device
from mcmc_tpu_torch.samplers.aees import AEESState
from mcmc_tpu_torch.samplers.barker import BarkerState
from mcmc_tpu_torch.samplers.chees import ChEESState
from mcmc_tpu_torch.samplers.de import DEState
from mcmc_tpu_torch.samplers.demcz import DEMCZState
from mcmc_tpu_torch.samplers.ellipse import EllipticalSliceState
from mcmc_tpu_torch.samplers.gibbs import GibbsState
from mcmc_tpu_torch.samplers.ghmc import GHMCState
from mcmc_tpu_torch.samplers.hmc import HMCState
from mcmc_tpu_torch.samplers.mala import MALAState
from mcmc_tpu_torch.samplers.mclmc import MAMSState, MCLMCState
from mcmc_tpu_torch.samplers.mmala import MMALAState
from mcmc_tpu_torch.samplers.pt import PTState
from mcmc_tpu_torch.samplers.rmhmc import RMHMCState
from mcmc_tpu_torch.samplers.rwmh import RWMHState
from mcmc_tpu_torch.samplers.sgld import SGHMCState, SGLDState
from mcmc_tpu_torch.samplers.slice import SliceState
from mcmc_tpu_torch.samplers.smc import SMCState
from mcmc_tpu_torch.samplers.stretch import StretchState

__all__ = ["to_tensor", "glm_data", "gaussian_target", "fused_state",
           "hmc_state", "chees_state", "ghmc_state", "mclmc_state",
           "mams_state", "rwmh_state", "mala_state", "rmhmc_state",
           "de_state", "pt_state", "aees_state", "smc_state",
           "stretch_state", "demcz_state", "barker_state", "mmala_state",
           "slice_state", "elliptical_state", "sgld_state", "sghmc_state",
           "gibbs_state", "laplace_result", "pathfinder_result",
           "evidence_state", "nested_state", "advi_phi", "adam_state"]


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


def _host_counter(v, name):
    """A counter the port keeps on the host: JAX's scalar, or its batched
    copies, which must all be equal."""
    a = np.asarray(v).reshape(-1)
    if a.size == 0 or not (a == a[0]).all():
        raise ValueError(f"{name} differs across the batch: {a}")
    return int(a[0])


def _with_host_counters(cls, state, device, counters, batch_ndim=None):
    """A state of the port's ``cls`` from the JAX package's, the fields in
    ``counters`` as host integers. With ``batch_ndim`` (field -> the rank
    of one replica's array), an unbatched JAX state (one run) gains the
    leading run axis the port always carries."""
    out = {}
    for f in cls._fields:
        v = getattr(state, f)
        if f in counters:
            out[f] = _host_counter(v, f)
            continue
        t = to_tensor(v, device)
        if batch_ndim is not None and t.ndim == batch_ndim[f]:
            t = t[None]
        out[f] = t
    return cls(**out)


def pt_state(state, device=None) -> PTState:
    """A :class:`~mcmc_tpu_torch.samplers.pt.PTState` from the JAX
    package's chain-batched ``PTState`` (the draw counter, equal across
    chains, as a host integer)."""
    return _with_host_counters(PTState, state, device, ("draw_ind",))


def aees_state(state, device=None) -> AEESState:
    """An :class:`~mcmc_tpu_torch.samplers.aees.AEESState` from the JAX
    package's ``AEESState``, of one ladder or batched over runs (the draw
    counter as a host integer)."""
    return _with_host_counters(
        AEESState, state, device, ("draw_ind",),
        {"X": 2, "cur_kv": 1, "kv2": 2, "hist_kv": 2, "hist_draws": 3})


def smc_state(state, device=None) -> SMCState:
    """An :class:`~mcmc_tpu_torch.samplers.smc.SMCState` from the JAX
    package's ``SMCState``, without its key (the port draws from its run's
    generator); the stage count as a host integer."""
    return _with_host_counters(SMCState, state, device, ("stage",))


def stretch_state(state, device=None) -> StretchState:
    """A :class:`~mcmc_tpu_torch.samplers.stretch.StretchState` from the JAX
    package's ``StretchState``."""
    return _sampler_state(StretchState, state, device)


def demcz_state(state, device=None) -> DEMCZState:
    """A :class:`~mcmc_tpu_torch.samplers.demcz.DEMCZState` from the JAX
    package's ``DEMCZState``, of one run or batched over runs (the archive's
    fill count and the generation counter as host integers)."""
    return _with_host_counters(DEMCZState, state, device,
                               ("m_total", "gen_ind"),
                               {"X": 2, "kernel_vals": 1, "Z": 2})


def barker_state(state, device=None) -> BarkerState:
    """A :class:`~mcmc_tpu_torch.samplers.barker.BarkerState` from the JAX
    package's chain-batched ``BarkerState``."""
    return _sampler_state(BarkerState, state, device)


def mmala_state(state, device=None) -> MMALAState:
    """A :class:`~mcmc_tpu_torch.samplers.mmala.MMALAState` from the JAX
    package's chain-batched ``MMALAState``."""
    return _sampler_state(MMALAState, state, device)


def slice_state(state, device=None) -> SliceState:
    """A :class:`~mcmc_tpu_torch.samplers.slice.SliceState` from the JAX
    package's chain-batched ``SliceState`` (the draw counter, equal across
    chains, as a host integer)."""
    wv = state.wv
    return SliceState(
        position=to_tensor(state.position, device),
        log_prob=to_tensor(state.log_prob, device),
        wv=adaptation.WindowedVariance(
            count=to_tensor(wv.count, device, torch.int32),
            mean=to_tensor(wv.mean, device), m2=to_tensor(wv.m2, device),
            var=to_tensor(wv.var, device)),
        draw_ind=_host_counter(state.draw_ind, "draw_ind"))


def elliptical_state(state, device=None) -> EllipticalSliceState:
    """An :class:`~mcmc_tpu_torch.samplers.ellipse.EllipticalSliceState`
    from the JAX package's chain-batched ``EllipticalSliceState``."""
    return _sampler_state(EllipticalSliceState, state, device)


def sgld_state(state, device=None) -> SGLDState:
    """An :class:`~mcmc_tpu_torch.samplers.sgld.SGLDState` from the JAX
    package's chain-batched ``SGLDState`` (the draw counter as a host
    integer)."""
    return _with_host_counters(SGLDState, state, device, ("draw_ind",))


def sghmc_state(state, device=None) -> SGHMCState:
    """An :class:`~mcmc_tpu_torch.samplers.sgld.SGHMCState` from the JAX
    package's chain-batched ``SGHMCState`` (the draw counter as a host
    integer)."""
    return _with_host_counters(SGHMCState, state, device, ("draw_ind",))


# a Gibbs block's sub-state by the fields that tell the kinds apart
_GIBBS_SUBSTATES = ((("potential",), hmc_state), (("pchol",), rwmh_state),
                    (("wv", "log_prob"), slice_state))


def gibbs_state(state, device=None) -> GibbsState:
    """A :class:`~mcmc_tpu_torch.samplers.gibbs.GibbsState` from the JAX
    package's chain-batched ``GibbsState``: each block's sub-state by its
    kind (HMC, RWMH or slice; an exact block's empty array as a ``(c,
    0)`` tensor)."""
    subs = []
    for sub in state.substates:
        fields = getattr(sub, "_fields", ())
        for names, conv in _GIBBS_SUBSTATES:
            if all(n in fields for n in names):
                subs.append(conv(sub, device))
                break
        else:
            subs.append(to_tensor(sub, device))
    return GibbsState(position=to_tensor(state.position, device),
                      substates=tuple(subs))


def _box_fields(res, device):
    """The bound fields of a Laplace or Pathfinder result: transform codes
    as int32, bounds as tensors, ``vals_bound`` as a bool."""
    return dict(_codes=to_tensor(res._codes, device, torch.int32),
                _lb=to_tensor(res._lb, device), _ub=to_tensor(res._ub, device),
                _vals_bound=bool(res._vals_bound))


def laplace_result(res, device=None) -> LaplaceResult:
    """A :class:`~mcmc_tpu_torch.laplace.LaplaceResult` from the JAX
    package's ``LaplaceResult`` (or any object with its fields): the mode,
    covariance and factor as tensors, so that the port's ``draw_init``,
    ``init_box`` and ``log_evidence`` run on JAX's pieces."""
    return LaplaceResult(
        mode=to_tensor(res.mode, device), mode_z=to_tensor(res.mode_z, device),
        cov=to_tensor(res.cov, device),
        cov_sqrt=to_tensor(res.cov_sqrt, device),
        log_post=to_tensor(res.log_post, device),
        grad_norm=to_tensor(res.grad_norm, device),
        restart_log_posts=to_tensor(res.restart_log_posts, device),
        **_box_fields(res, device))


def pathfinder_result(res, device=None) -> PathfinderResult:
    """A :class:`~mcmc_tpu_torch.pathfinder.PathfinderResult` from the JAX
    package's ``PathfinderResult`` (or any object with its fields): the
    draws (constrained and unconstrained) and their diagnostics as tensors,
    so that the port's ``draw_init``, ``center``, ``init_box`` and
    ``spread_z`` run on JAX's draws."""
    return PathfinderResult(
        draws=to_tensor(res.draws, device), log_p=to_tensor(res.log_p, device),
        log_q=to_tensor(res.log_q, device),
        pareto_k=to_tensor(res.pareto_k, device),
        elbo=to_tensor(res.elbo, device),
        best_iter=to_tensor(res.best_iter, device, torch.int64),
        n_lbfgs_iters=to_tensor(res.n_lbfgs_iters, device, torch.int64),
        _draws_z=to_tensor(res._draws_z, device), **_box_fields(res, device))


def evidence_state(state, device=None) -> _EvState:
    """The evidence ladder's ``_EvState`` from the JAX package's
    chain-batched one (``X`` ``(c, K, d)``, ``ll`` and ``lp`` ``(c, K)``,
    the dual averaging over ``(c, K)``; the draw counter, equal across
    chains, as a host integer)."""
    return _EvState(
        X=to_tensor(state.X, device), ll=to_tensor(state.ll, device),
        lp=to_tensor(state.lp, device),
        da=adaptation.DualAveraging(*[to_tensor(v, device)
                                      for v in state.da]),
        draw_ind=_host_counter(state.draw_ind, "draw_ind"))


def nested_state(loop_state, device=None) -> _NSState:
    """The nested sampler's round state from the JAX package's
    ``lax.while_loop`` carry ``(live_u, live_L, logX, logZ, h, r, done,
    key, scale, dead_u, dead_L, dead_logw, acc)``: the live set, its
    scalars and the dead-point buffers (the key dropped; the round count
    as a host integer)."""
    (live_u, live_L, logX, logZ, h, r, _done, _key, scale, dead_u, dead_L,
     dead_logw, acc) = loop_state
    t = lambda v: to_tensor(v, device)
    return _NSState(live_u=t(live_u), live_L=t(live_L), logX=t(logX),
                    logZ=t(logZ), h=t(h), scale=t(scale), acc=t(acc),
                    rounds=_host_counter(r, "r"), dead_u=t(dead_u),
                    dead_L=t(dead_L), dead_logw=t(dead_logw))


def advi_phi(phi, device=None) -> dict:
    """ADVI's variational parameters ``{"mu", "log_diag"[, "off"]}`` (the
    strict lower triangle ``off`` in ``jnp.tril_indices(d, k=-1)``'s
    row-major order, which ``torch.tril_indices(d, d, -1)`` shares)."""
    return {k: to_tensor(v, device) for k, v in phi.items()}


def adam_state(opt_state, device=None) -> AdamState:
    """The written-out Adam's state from ``optax.adam``'s (its
    ``ScaleByAdamState`` first: ``count``, ``mu``, ``nu``, each moment an
    array or a dict of arrays)."""
    adam = opt_state[0]
    conv = lambda m: {k: to_tensor(v, device) for k, v in m.items()} \
        if isinstance(m, dict) else to_tensor(m, device)
    return AdamState(mu=conv(adam.mu), nu=conv(adam.nu),
                     count=int(np.asarray(adam.count)))
