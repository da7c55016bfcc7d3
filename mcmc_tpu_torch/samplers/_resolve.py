"""Settings/generator resolution shared by sampler entry points."""

from __future__ import annotations

import numpy as np
import torch

from mcmc_tpu_torch.settings import AlgoSettings

__all__ = ["resolve_settings", "resolve_key", "resolve_device", "key_seed",
           "stream_generator"]


def resolve_device(device, *args) -> torch.device:
    """The device an entry point runs on: an explicit ``device`` wins; else
    the device of the first of ``args`` that is a tensor; else the card,
    ``torch.device("cuda")``. The CPU is never a default: callers ask for it
    with ``device="cpu"`` or by passing CPU tensors, and on a machine
    without a card the first allocation raises torch's own error."""
    if device is not None:
        return torch.device(device)
    for a in args:
        if torch.is_tensor(a):
            return a.device
    return torch.device("cuda")


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


def key_seed(key) -> int:
    """An integer seed from ``key``: an integer as is; from a
    ``torch.Generator``, one 62-bit integer drawn from it (advancing it; on
    the card one host synchronisation)."""
    if isinstance(key, torch.Generator):
        return int(torch.randint(0, 2 ** 62, (1,), generator=key,
                                 device=key.device))
    return int(key)


def stream_generator(seed: int, *stream, device) -> torch.Generator:
    """The generator of one named stream of ``seed`` on ``device``: seeded
    from numpy's ``SeedSequence(seed, spawn_key=stream)``, so streams with
    different ``stream`` tuples are independent and none replays another
    (where JAX splits a key into disjoint subkeys)."""
    ss = np.random.SeedSequence(int(seed) % 2 ** 128,
                                spawn_key=tuple(int(i) for i in stream))
    state = ss.generate_state(2, np.uint32)
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return gen
