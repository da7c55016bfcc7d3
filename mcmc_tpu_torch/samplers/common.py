"""Shared sampler machinery (PyTorch port of ``mcmc_tpu.samplers.common``).

The reference repeats a run skeleton in every sampler translation unit
(reference src/rwmh.cpp:64-167): classify bounds, build a box log-kernel
closure, transform initial values, run a sequential draw loop, back-transform
kept draws, report acceptance. Here that skeleton is :func:`setup_problem`
plus :func:`run_sampler_loop`, a Python loop over draws of a *batched*
transition kernel ``step(gen, state) -> (state, info)`` that carries the
chain batch on the leading axis of every tensor (the JAX package vmaps a
single-chain kernel and scans it instead).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from mcmc_tpu_torch import bounds as bounds_mod
from mcmc_tpu_torch.samplers._resolve import resolve_device

__all__ = ["SPD", "make_spd", "Problem", "setup_problem", "run_sampler_loop",
           "tally_accepts", "thin_step", "make_population_runner",
           "population_accept_diag", "population_accept_diag_totals",
           "run_checkpointed", "attach_resume", "finalize_draws",
           "where_chains", "chain_col"]


@dataclass(frozen=True)
class SPD:
    """A symmetric-positive-definite matrix M specialised by kind.

    Provides the products every Metropolis/Hamiltonian kernel needs
    (reference precomputes the same trio once per run, src/hmc.cpp:57-59),
    each applied to every row of a ``(n_chains, n_vals)`` batch: ``mv``
    (M v), ``inv_mv`` (M^{-1} v), ``sqrt_mv`` (chol(M) v), ``sqrt_t_mv``
    (chol(M)^T v). The identity and diagonal kinds stay elementwise.
    """

    kind: str  # 'identity' | 'diag' | 'full'
    mv: Callable[[Any], Any]
    inv_mv: Callable[[Any], Any]
    sqrt_mv: Callable[[Any], Any]
    sqrt_t_mv: Callable[[Any], Any]
    mat: Any  # dense/diag representation or None for identity


def make_spd(mat, n_vals: int, dtype, device=None) -> SPD:
    """Build an :class:`SPD` from ``None`` (identity), scalar, 1-D diagonal,
    or 2-D dense input (reference src/rwmh.cpp:58)."""
    if mat is None:
        ident = lambda v: v
        return SPD("identity", ident, ident, ident, ident, None)

    m = torch.as_tensor(mat, dtype=dtype, device=device)
    if m.ndim == 0:
        m = torch.full((n_vals,), float(m), dtype=dtype, device=device)
    if m.ndim == 1:
        if m.shape[0] != n_vals:
            raise ValueError(f"diagonal matrix has size {m.shape[0]}, expected {n_vals}")
        sq = torch.sqrt(m)
        return SPD(
            "diag",
            mv=lambda v: m * v,
            inv_mv=lambda v: v / m,
            sqrt_mv=lambda v: sq * v,
            sqrt_t_mv=lambda v: sq * v,
            mat=m,
        )
    if tuple(m.shape) != (n_vals, n_vals):
        raise ValueError(f"matrix has shape {tuple(m.shape)}, expected ({n_vals},{n_vals})")
    chol, info = torch.linalg.cholesky_ex(m)
    # fail loud at setup: a not-quite-SPD matrix would otherwise silently
    # freeze every proposal downstream
    if int(info) != 0 or not bool(torch.isfinite(chol).all()):
        raise ValueError(
            "matrix is not positive definite at this precision (Cholesky "
            "failed or produced non-finite entries); add diagonal jitter "
            "(e.g. 1e-4 * amplitude**2 for f32 kernel matrices) or use "
            "float64")
    inv = torch.linalg.inv(m)
    # rows of v are vectors: (A v)^T = v^T A^T
    return SPD(
        "full",
        mv=lambda v: v @ m.T,
        inv_mv=lambda v: v @ inv.T,
        sqrt_mv=lambda v: v @ chol.T,
        sqrt_t_mv=lambda v: v @ chol,
        mat=m,
    )


@dataclass(frozen=True)
class Problem:
    """Everything derived from (initial_vals, log_kernel, umbrella settings)."""

    n_vals: int
    dtype: Any
    device: Any
    vals_bound: bool
    codes: Any
    lower_bounds: Any
    upper_bounds: Any
    log_kernel: Callable          # user kernel, constrained space, batched
    box_log_kernel: Callable      # unconstrained space (+ log-Jacobian)
    first_draw: Any               # (n_chains, n_vals) unconstrained
    n_chains: int
    squeeze: bool                 # drop the chain axis in the result


def setup_problem(initial_vals, log_kernel, algo, n_chains: Optional[int],
                  dtype=None, device=None) -> Problem:
    """Common preamble of every sampler (reference src/rwmh.cpp:64-103).

    ``log_kernel`` is batched: ``(n_chains, n_vals) -> (n_chains,)``.
    ``device`` defaults to that of ``initial_vals`` when it is a tensor,
    else the card (:func:`resolve_device`); ``dtype`` defaults to float32 unless ``initial_vals`` is
    already a floating tensor."""
    if callable(initial_vals) and not hasattr(initial_vals, "__array__"):
        raise TypeError(
            "initial_vals is a function — the argument order is "
            "(initial_vals, log_kernel, ...), initial values first")
    if not callable(log_kernel):
        raise TypeError(
            f"log_kernel must be callable (a log-density function); got "
            f"{type(log_kernel).__name__}")
    if dtype is None:
        dtype = initial_vals.dtype if (torch.is_tensor(initial_vals) and
                                       initial_vals.is_floating_point()) \
            else torch.float32
    device = resolve_device(device, initial_vals)
    try:
        x0 = torch.as_tensor(initial_vals, dtype=dtype, device=device)
    except (TypeError, ValueError, RuntimeError) as e:
        raise TypeError(
            f"initial_vals must be array-like; got "
            f"{type(initial_vals).__name__}") from e
    squeeze = x0.ndim == 1 and (n_chains is None or n_chains == 1)
    if x0.ndim == 1:
        n = 1 if n_chains is None else int(n_chains)
        x0 = x0.expand(n, x0.shape[0]).clone()
    elif (x0.ndim == 2 and n_chains is not None
          and x0.shape[0] != int(n_chains)):
        raise ValueError(
            f"initial_vals has {x0.shape[0]} rows (one per chain) but "
            f"n_chains={n_chains}; drop n_chains or match the leading axis")
    n_chains_eff, n_vals = x0.shape

    vals_bound = bool(algo.vals_bound)
    inf = torch.full((n_vals,), float("inf"), dtype=dtype, device=device)
    lb, ub = -inf, inf
    if vals_bound and algo.lower_bounds is not None:
        lb = torch.as_tensor(algo.lower_bounds, dtype=dtype, device=device)
    if vals_bound and algo.upper_bounds is not None:
        ub = torch.as_tensor(algo.upper_bounds, dtype=dtype, device=device)

    codes = bounds_mod.determine_bounds_type(vals_bound, n_vals, lb, ub,
                                             device=device)
    box = bounds_mod.make_box_log_kernel(log_kernel, vals_bound, codes, lb, ub)
    first = bounds_mod.transform(x0, codes, lb, ub) if vals_bound else x0

    return Problem(
        n_vals=n_vals, dtype=dtype, device=device, vals_bound=vals_bound,
        codes=codes, lower_bounds=lb, upper_bounds=ub, log_kernel=log_kernel,
        box_log_kernel=box, first_draw=first, n_chains=n_chains_eff,
        squeeze=squeeze,
    )


def where_chains(cond, new, old):
    """Per-chain select: ``cond`` ``(n_chains,)`` picks each chain's row
    of ``new`` or ``old`` (any trailing shape)."""
    return torch.where(cond.reshape(cond.shape + (1,) * (new.ndim - 1)),
                       new, old)


def chain_col(v):
    """A per-chain ``(n_chains,)`` tensor as a column, to scale the rows of
    a ``(n_chains, n_vals)`` batch; a Python number as is."""
    return v[:, None] if torch.is_tensor(v) else v


def tally_accepts(infos):
    """Post-burn-in acceptance count per chain, from either the stacked
    info trace or an accumulated total."""
    if "accepted" in infos:
        return infos["accepted"].to(torch.int64).sum(dim=0)
    return torch.as_tensor(infos["totals"]["accepted"])


def thin_step(step_fn, thin: int):
    """Wrap a batched kernel so each call advances ``thin`` transitions and
    reports one draw (the emcee ``thin_by`` convention).

    Info aggregation over the window: boolean entries (``accepted``,
    ``diverged``) become int32 *counts* over the window's transitions;
    everything else reports the last transition's value."""
    thin = int(thin)
    if thin < 1:
        raise ValueError(f"thin must be >= 1, got {thin}")
    if thin == 1:
        return step_fn

    def step(gen, state):
        counts, info = {}, {}
        for _ in range(thin):
            state, info = step_fn(gen, state)
            for k, v in info.items():
                if v.dtype == torch.bool:
                    counts[k] = counts.get(k, 0) + v.to(torch.int32)
        return state, {**info, **counts}

    return step


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (multi-device chain sharding) is not ported to PyTorch "
            "yet; see ROADMAP A12")


def run_checkpointed(gen, state0, step_fn, n_burnin, n_keep, collect_fn,
                     checkpoint_dir, checkpoint_every=500):
    """``n_burnin`` + ``n_keep`` transitions of ``step_fn`` in restartable
    chunks of ``checkpoint_every`` (:class:`mcmc_tpu_torch.checkpoint.
    ChunkedRunner`): the same ``step_fn(gen, state)`` calls in the same
    order as :func:`run_sampler_loop`'s loops, so the draws equal the
    in-memory run's bit for bit. Returns ``(final_state, draws, totals)``
    with ``draws`` a CPU tensor over the sink file's copy-on-write memmap
    (``(n_keep, *collect_fn(state).shape)``) and ``totals`` the per-chain
    sums of every info entry over the kept draws."""
    from mcmc_tpu_torch.checkpoint import ChunkedRunner
    runner = ChunkedRunner(step_fn, collect_fn, checkpoint_dir)
    final, draws, totals = runner.run(
        gen, state0, n_draws=n_keep, n_burnin=n_burnin,
        chunk_size=checkpoint_every)
    return final, torch.from_numpy(draws), totals


def make_population_runner(sweep):
    """Runner for the population samplers (de so far): ``sweep(gen, state)
    -> (state, info)`` moves the whole population at once, drawing from the
    run's one ``torch.Generator``. Runs ``n_burnin`` discarded sweeps then
    ``n_keep`` kept ones under ``no_grad``, writing ``(state.X,
    info["accepted"])`` of each kept sweep into preallocated tensors.
    Returns ``run(state0, gen, n_burnin, n_keep) -> (final_state, (draws,
    accepted))``, draws ``(n_keep, n_pop, n_vals)``."""

    def run(state0, gen, n_burnin, n_keep):
        state, draws, accepted = state0, None, None
        with torch.no_grad():
            for _ in range(int(n_burnin)):
                state, _info = sweep(gen, state)
            for i in range(int(n_keep)):
                state, info = sweep(gen, state)
                if draws is None:
                    draws = state.X.new_empty((int(n_keep),)
                                              + tuple(state.X.shape))
                    accepted = info["accepted"].new_empty(
                        (int(n_keep),) + tuple(info["accepted"].shape))
                draws[i] = state.X
                accepted[i] = info["accepted"]
        return state, (draws, accepted)

    return run


def population_accept_diag(accepted, thin: int):
    """Population acceptance diagnostics from per-sweep stacked
    ``accepted`` (bool, or int32 window counts under ``thin``): a
    per-walker probability plus the ``thin`` record the ``accept_rate``
    property divides by."""
    diag = {"accept_rate_per_walker":
            accepted.to(torch.float32).mean(dim=0) / int(thin)}
    if int(thin) > 1:
        diag["thin"] = int(thin)
    return diag


def population_accept_diag_totals(per_walker, n_keep: int, thin: int):
    """Same contract as :func:`population_accept_diag`, from the checkpoint
    runner's per-walker transition-count totals."""
    diag = {"accept_rate_per_walker":
            torch.as_tensor(per_walker).to(torch.float32)
            / (int(n_keep) * int(thin))}
    if int(thin) > 1:
        diag["thin"] = int(thin)
    return diag


def run_sampler_loop(gen, state0, step_fn, n_burnin, n_keep, collect_fn,
                     mesh=None, checkpoint_dir=None, checkpoint_every=500,
                     thin=1):
    """Burn-in + keep loops of a batched transition kernel.

    ``state0`` is chain-batched on the leading axis; ``step_fn`` is the
    batched kernel ``(gen, state) -> (state, info)``, drawing every random
    number of a transition from the one ``torch.Generator`` ``gen``;
    ``info`` must contain an ``"accepted"`` entry. Acceptance is only
    tallied in the keep phase, matching the reference
    (src/rwmh.cpp:140-142).

    Returns ``(final_state, draws, infos)`` where ``draws`` stacks
    ``collect_fn(state)`` over kept iterations: shape
    ``(n_keep, n_chains, ...)``; each ``infos`` entry is stacked likewise.
    ``thin=k`` advances ``k`` transitions per draw (see :func:`thin_step`).

    With ``checkpoint_dir``, the run executes in restartable chunks of
    ``checkpoint_every`` (:func:`run_checkpointed`): kept draws stream to
    the native draw sink and a killed run resumes bit-identically. The
    draws are then a CPU tensor over the sink file's memmap (the long runs
    checkpointing targets are the ones whose history does not fit on the
    card), and ``infos`` carries only ``{"totals": {...}}``, per-chain sums
    of every info entry over the kept draws.
    """
    _no_mesh(mesh)
    step_fn = thin_step(step_fn, thin)
    if checkpoint_dir is not None:
        final, draws, totals = run_checkpointed(
            gen, state0, step_fn, n_burnin, n_keep, collect_fn,
            checkpoint_dir, checkpoint_every)
        return final, draws, {"totals": totals}
    state = state0
    draws = None
    infos = {}
    with torch.no_grad():
        for _ in range(int(n_burnin)):
            state, _info = step_fn(gen, state)
        for i in range(int(n_keep)):
            state, info = step_fn(gen, state)
            x = collect_fn(state)
            if draws is None:
                draws = x.new_empty((int(n_keep),) + tuple(x.shape))
            draws[i] = x
            for k, v in info.items():
                infos.setdefault(k, []).append(v)
    infos = {k: torch.stack(v) for k, v in infos.items()}
    return state, draws, infos


def attach_resume(result, assemble, final_state):
    """Attach a warm-continuation closure to a sampler result.

    ``assemble(gen, state0, n_burnin, n_keep) -> (SamplerResult,
    final_state)`` is the entry point's run-and-assemble tail. The attached
    ``result.diagnostics["resume"](gen, n_keep)`` runs ``n_keep`` further
    draws from the final kernel state (no re-warmup, adaptation state
    carried) and itself carries a fresh ``"resume"``."""
    def make(fs):
        def resume(gen, n_keep):
            r2, fs2 = assemble(gen, fs, 0, n_keep)
            r2.diagnostics["resume"] = make(fs2)
            return r2
        return resume
    result.diagnostics["resume"] = make(final_state)
    return result


def finalize_draws(draws, prob: Problem):
    """Back-transform kept draws to constrained space (reference
    src/rwmh.cpp:156-163); a checkpointed run's host draws move to the
    problem's device for it."""
    if prob.vals_bound:
        draws = bounds_mod.inv_transform(
            draws.to(prob.device), prob.codes, prob.lower_bounds,
            prob.upper_bounds)
    return draws
