"""Settings/generator resolution shared by sampler entry points."""

from __future__ import annotations

import torch

from mcmc_tpu_torch.settings import AlgoSettings

__all__ = ["resolve_settings", "resolve_key"]


def resolve_settings(settings, attr_name, per_algo_cls):
    """Accept an :class:`AlgoSettings` umbrella, a bare per-sampler settings
    object, or ``None`` (all defaults) — the analog of the reference's
    4-arg / 5-arg overload pair (reference src/rwmh.cpp:176-199)."""
    if settings is None:
        algo = AlgoSettings()
        return algo, getattr(algo, attr_name)
    if isinstance(settings, AlgoSettings):
        return settings, getattr(settings, attr_name)
    if isinstance(settings, per_algo_cls):
        return AlgoSettings(), settings
    raise TypeError(
        f"settings must be AlgoSettings, {per_algo_cls.__name__}, or None; "
        f"got {type(settings).__name__}"
    )


def resolve_key(key, algo: AlgoSettings, device) -> torch.Generator:
    """The run's ``torch.Generator`` on ``device``, in place of a JAX key.

    ``key`` may be a ``torch.Generator`` (used as is; it must live on
    ``device``'s type), an integer seed, or ``None`` (seed
    ``algo.rng_seed_value``). The same seed on the same device gives
    bit-identical draws."""
    device = torch.device(device)
    if isinstance(key, torch.Generator):
        if key.device.type != device.type:
            raise ValueError(f"generator lives on {key.device}, the run on "
                             f"{device}")
        return key
    seed = int(algo.rng_seed_value) if key is None else int(key)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen
