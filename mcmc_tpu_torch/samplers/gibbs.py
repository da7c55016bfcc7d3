"""Compositional block-Gibbs sampling (PyTorch port of
``mcmc_tpu.samplers.gibbs``).

The parameter vector is partitioned into blocks, each updated in sequence
by its own transition, conditioned on the current values of the others:
Metropolis-within-Gibbs (``"rwmh"``), HMC-within-Gibbs (``"hmc"``),
slice-within-Gibbs (``"slice"``) and exact conditional draws, freely mixed.
The block kernels are the port's own batched builders
(:func:`~mcmc_tpu_torch.samplers.rwmh.build_rwmh_kernel`,
:func:`~mcmc_tpu_torch.samplers.hmc.build_hmc_kernel`,
:func:`~mcmc_tpu_torch.samplers.slice.build_slice_kernel`), built once on
the block's conditional log-density ``lp_b(x_b) = box_log_kernel(full with
block b's columns replaced)``, where ``full`` is the sweep's current chain
batch. The columns are replaced out of place (``index_copy``), so autograd
reaches the HMC block's gradient.

Semantics, as in the JAX package:

- MH and slice blocks run in the unconstrained space (the full box
  log-kernel with its log-Jacobian); exact blocks in the constrained space.
- Each block re-evaluates its cached conditional density at its current
  position once a sweep before it moves (another block has moved since).
- Per-block dual averaging (on by default for rwmh and hmc) runs against
  the moving conditional and freezes after ``n_burnin_draws`` sweeps.

One API difference: an exact conditional is ``fn(gen, full) -> (n_chains,
d_b)``, where ``full`` is the ``(n_chains, d)`` chain batch in the
constrained space and ``gen`` the run's ``torch.Generator`` (the JAX
package's is ``fn(key, full)`` for one chain). A transition is
``step.draw(gen, state)`` (each MH and slice block's random numbers, in
block order, and for each exact block the generator itself, which its
``fn`` draws from when the transition runs) followed by
``step.transition(state, *draws)``.

Block spec: ``blocks=[(indices, method[, opts]), ...]``; ``method`` is
``"rwmh" | "hmc" | "slice"`` or a callable exact conditional; ``opts`` a
per-block dict (``scale``, ``step_size``, ``n_leap_steps``, ``w``,
``max_step_out``, ``max_shrink_steps``, ``adapt``, ``target_accept``).
Blocks must be disjoint and cover every coordinate.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mcmc_tpu_torch import adaptation
from mcmc_tpu_torch import bounds as bounds_mod
from mcmc_tpu_torch.integrators import grad_of
from mcmc_tpu_torch.results import SamplerResult
from mcmc_tpu_torch.settings import GibbsSettings
from mcmc_tpu_torch.samplers import common
from mcmc_tpu_torch.samplers._resolve import resolve_settings, resolve_key
from mcmc_tpu_torch.samplers.hmc import build_hmc_kernel
from mcmc_tpu_torch.samplers.rwmh import build_rwmh_kernel
from mcmc_tpu_torch.samplers.slice import build_slice_kernel

__all__ = ["gibbs", "GibbsState", "build_gibbs_kernel"]


class GibbsState(NamedTuple):
    position: torch.Tensor   # (c, d) unconstrained full vector
    substates: tuple         # per-block kernel states ((c, 0) for exact)


# Per-method option whitelists: an unknown key (a typo, or an option meant
# for another method) raises instead of silently running with defaults.
_ALLOWED_OPTS = {
    "rwmh": {"scale", "adapt", "target_accept"},
    "hmc": {"step_size", "n_leap_steps", "adapt", "target_accept"},
    "slice": {"w", "max_step_out", "max_shrink_steps"},
    "exact": set(),
}


def _parse_blocks(blocks, n_vals):
    """Validate the block spec: disjoint integer index sets covering every
    coordinate. Returns [(np_indices, method, opts), ...]."""
    if not isinstance(blocks, (list, tuple)) or len(blocks) == 0:
        raise ValueError("blocks must be a non-empty list of "
                         "(indices, method[, opts]) tuples")
    parsed = []
    seen = np.zeros(n_vals, dtype=bool)
    for b, spec in enumerate(blocks):
        if not isinstance(spec, (list, tuple)) or len(spec) not in (2, 3):
            raise ValueError(
                f"block {b}: expected (indices, method) or "
                f"(indices, method, opts), got {spec!r}")
        idx = np.atleast_1d(np.asarray(spec[0]))
        if idx.ndim != 1 or idx.size == 0 or not np.issubdtype(
                idx.dtype, np.integer):
            raise ValueError(f"block {b}: indices must be a non-empty 1-D "
                             f"integer array, got {spec[0]!r}")
        if idx.min() < 0 or idx.max() >= n_vals:
            raise ValueError(f"block {b}: indices out of range for "
                             f"{n_vals} parameters: {idx.tolist()}")
        if np.unique(idx).size != idx.size or seen[idx].any():
            raise ValueError(f"block {b}: indices overlap another block "
                             f"(blocks must be disjoint): {idx.tolist()}")
        seen[idx] = True
        method = spec[1]
        if not callable(method) and method not in ("rwmh", "hmc", "slice"):
            raise ValueError(
                f"block {b}: method must be 'rwmh', 'hmc', 'slice', or a "
                f"callable exact conditional, got {method!r}")
        opts = dict(spec[2]) if len(spec) == 3 else {}
        allowed = (_ALLOWED_OPTS["exact"] if callable(method)
                   else _ALLOWED_OPTS[method])
        unknown = sorted(set(opts) - allowed)
        if unknown:
            name = "exact" if callable(method) else method
            raise ValueError(
                f"block {b}: unknown option(s) {unknown} for method "
                f"{name!r}; allowed: {sorted(allowed) or '(none)'}")
        parsed.append((idx, method, opts))
    if not seen.all():
        missing = np.nonzero(~seen)[0].tolist()
        raise ValueError(
            f"blocks must cover every coordinate; missing {missing} "
            f"(freeze a coordinate by giving it an exact block that "
            f"returns it unchanged)")
    return parsed


class _Block(NamedTuple):
    kind: str          # "exact" | "rwmh" | "hmc" | "slice"
    idx: torch.Tensor  # (d_b,) int64 columns
    exact: object      # the user's fn (exact blocks)
    init: object       # the block kernel's init (others)
    step: object       # the block kernel's step
    refresh: object    # sub-state -> sub-state with the conditional re-read
    cell: dict         # {"full": the chain batch the conditional reads}


def _make_blocks(parsed, prob, n_burnin):
    """One :class:`_Block` a block. Each non-exact kernel is built once on
    a conditional log-density that reads the current chain batch from the
    block's ``cell``; non-finite values become -inf (the reference's
    rejection semantics)."""
    box = prob.box_log_kernel
    out = []
    for idx_np, method, opts in parsed:
        idx = torch.as_tensor(idx_np, dtype=torch.int64, device=prob.device)
        if callable(method):
            out.append(_Block("exact", idx, method, None, None, None, None))
            continue
        cell = {}

        def lp(xb, cell=cell, idx=idx):
            v = box(cell["full"].index_copy(1, idx, xb))
            return torch.where(torch.isfinite(v), v, -torch.inf)

        adapt_cfg = None
        if method in ("rwmh", "hmc") and opts.get("adapt", True):
            adapt_cfg = {"n_burnin": n_burnin,
                         "target": opts.get(
                             "target_accept",
                             adaptation.TARGET_ACCEPT[method])}
        refresh = lambda sub, lp=lp: sub._replace(log_prob=lp(sub.position))
        if method == "rwmh":
            init, step = build_rwmh_kernel(lp, lambda v: v,
                                           float(opts.get("scale", 1.0)),
                                           adapt_cfg)
        elif method == "hmc":
            ident = common.make_spd(None, int(idx_np.size), prob.dtype,
                                    prob.device)
            init, step = build_hmc_kernel(
                lp, grad_of(lp), ident, float(opts.get("step_size", 0.1)),
                int(opts.get("n_leap_steps", 10)), adapt_cfg)
            refresh = lambda sub, lp=lp: sub._replace(
                potential=-lp(sub.position))
        else:
            init, step = build_slice_kernel(
                lp, int(idx_np.size), prob.dtype, opts.get("w", 1.0),
                int(opts.get("max_step_out", 8)),
                int(opts.get("max_shrink_steps", 32)))
        out.append(_Block(method, idx, None, init, step, refresh, cell))
    return out


def build_gibbs_kernel(blocks, prob):
    """Batched Gibbs sweep over ``blocks`` (:func:`_make_blocks`): returns
    ``init(positions) -> GibbsState`` and ``step(gen, state) -> (state,
    info)``, info ``accepted`` (every block accepted; exact blocks count as
    accepted, slice blocks when every coordinate found its slice point) and
    ``block_accepted`` ``(c, n_blocks)``. ``step.draw`` and
    ``step.transition`` as in the module docstring."""
    bnds = (prob.codes, prob.lower_bounds, prob.upper_bounds)

    def exact_block(blk, gen, full):
        """The block's new unconstrained columns from its exact
        conditional, which runs in the constrained space."""
        if not prob.vals_bound:
            return torch.as_tensor(blk.exact(gen, full), dtype=full.dtype)
        full_con = bounds_mod.inv_transform(full, *bnds)
        xb_con = torch.as_tensor(blk.exact(gen, full_con), dtype=full.dtype)
        full_con = full_con.index_copy(1, blk.idx, xb_con)
        return bounds_mod.transform(full_con, *bnds)[:, blk.idx]

    def init(position):
        subs = []
        for blk in blocks:
            if blk.kind == "exact":
                subs.append(position.new_zeros((position.shape[0], 0)))
            else:
                blk.cell["full"] = position
                subs.append(blk.init(position[:, blk.idx]))
        return GibbsState(position=position, substates=tuple(subs))

    def draw(gen, state: GibbsState):
        return tuple(gen if blk.kind == "exact"
                     else blk.step.draw(gen, sub)
                     for blk, sub in zip(blocks, state.substates))

    def transition(state: GibbsState, *draws):
        full = state.position
        subs = list(state.substates)
        accepts = []
        for b, blk in enumerate(blocks):
            if blk.kind == "exact":
                full = full.index_copy(1, blk.idx,
                                       exact_block(blk, draws[b], full))
                accepts.append(torch.ones((full.shape[0],), dtype=torch.bool,
                                          device=full.device))
                continue
            blk.cell["full"] = full
            sub, info = blk.step.transition(blk.refresh(subs[b]), *draws[b])
            full = full.index_copy(1, blk.idx, sub.position)
            subs[b] = sub
            accepts.append(info["accepted"])
        block_accepted = torch.stack(accepts, dim=1)
        return (GibbsState(position=full, substates=tuple(subs)),
                {"accepted": block_accepted.all(dim=1),
                 "block_accepted": block_accepted})

    def step(gen, state: GibbsState):
        return transition(state, *draw(gen, state))

    step.draw, step.transition = draw, transition
    return init, step


def gibbs(initial_vals, log_kernel, settings=None, *, blocks,
          n_chains=None, key=None, mesh=None, checkpoint_dir=None,
          checkpoint_every=500, dtype=None, thin=1, return_resume=False,
          device=None) -> SamplerResult:
    """Run compositional block-Gibbs (module docstring). ``log_kernel`` is
    batched: ``(n_chains, n_vals) -> (n_chains,)``.
    ``blocks=[(indices, method[, opts]), ...]`` partitions the parameter
    vector; each sweep updates the blocks in order. An exact conditional is
    ``fn(gen, full_constrained) -> (n_chains, d_b)``.

    ``diagnostics["block_accept_rate"]`` reports each block's post-burn-in
    acceptance (exact blocks 1.0; slice blocks the share of sweeps where
    every coordinate found its slice point). ``key`` is a
    ``torch.Generator`` or an integer seed; ``device`` defaults to that of
    ``initial_vals``, else the card. ``mesh`` shards the chains over its ranks
    (:mod:`mcmc_tpu_torch.parallel`);
    ``checkpoint_dir`` runs in restartable chunks
    (:mod:`mcmc_tpu_torch.checkpoint`)."""
    algo, s = resolve_settings(settings, "gibbs_settings", GibbsSettings)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")

    prob = common.setup_problem(initial_vals, log_kernel, algo, n_chains,
                                dtype, device)
    gen = resolve_key(key, algo, prob.device)
    parsed = _parse_blocks(blocks, prob.n_vals)
    init, step = build_gibbs_kernel(
        _make_blocks(parsed, prob, s.n_burnin_draws), prob)
    state0 = init(prob.first_draw)
    methods = ["exact" if callable(m) else m for _i, m, _o in parsed]

    def assemble(key, state0, n_burnin, n_keep):
        final_state, draws, infos = common.run_sampler_loop(
            resolve_key(key, algo, prob.device), state0, step, n_burnin,
            n_keep, collect_fn=lambda st: st.position, mesh=mesh,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, thin=thin)
        n_accept = common.tally_accepts(infos)
        draws = common.finalize_draws(draws, prob)
        if "block_accepted" in infos:
            rate = infos["block_accepted"].to(torch.float32).mean(dim=0) \
                / int(thin)
        else:       # checkpointed run: the per-chain totals
            rate = torch.as_tensor(infos["totals"]["block_accepted"]).to(
                torch.float32) / (n_keep * int(thin))
        diagnostics = {"block_methods": methods, "block_accept_rate": rate}
        if prob.squeeze:
            draws = draws[:, 0, :]
            n_accept = n_accept[0]
            diagnostics["block_accept_rate"] = \
                diagnostics["block_accept_rate"][0]
        if thin > 1:   # accept_rate divides by n_keep*thin
            diagnostics["thin"] = int(thin)
        return SamplerResult(draws=draws, n_accept_draws=n_accept,
                             diagnostics=diagnostics), final_state

    result, final_state = assemble(gen, state0, s.n_burnin_draws,
                                   s.n_keep_draws)
    if return_resume:
        common.attach_resume(result, assemble, final_state)
    return result
