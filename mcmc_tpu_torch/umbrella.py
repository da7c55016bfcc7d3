"""The one-call surface (PyTorch port of the umbrella in
``mcmc_tpu/__init__.py``): :func:`sample`, a dispatcher over the samplers,
and :func:`fit`, a posterior fit with automatic warmup, optional Laplace or
Pathfinder starts, pytree models and run-until-converged extension.

API differences from the JAX package: log-kernels are batched
(``(n_chains, d) -> (n_chains,)``; a pytree log-kernel gets leaves with a
leading chain axis); ``key`` is an integer seed or a ``torch.Generator``;
``device=`` as in the samplers (default: the device of ``initial_vals``,
else the card). ``mesh=`` shards the chains over the mesh's ranks
(:mod:`mcmc_tpu_torch.parallel`); ``checkpoint_dir=`` runs the sampler in
restartable chunks.
"""

from __future__ import annotations

import math

import torch

from mcmc_tpu_torch import diagnostics
from mcmc_tpu_torch.laplace import map_laplace
from mcmc_tpu_torch.pathfinder import pathfinder
from mcmc_tpu_torch.pytree import _is_tree, bounds_like, ravel_model
from mcmc_tpu_torch.results import SamplerResult
from mcmc_tpu_torch.samplers import common
from mcmc_tpu_torch.samplers._resolve import (key_seed, resolve_device,
                                              stream_generator)
from mcmc_tpu_torch.samplers.barker import barker
from mcmc_tpu_torch.samplers.chees import chees
from mcmc_tpu_torch.samplers.aees import aees
from mcmc_tpu_torch.samplers.de import de
from mcmc_tpu_torch.samplers.demcz import demcz
from mcmc_tpu_torch.samplers.ellipse import elliptical_slice
from mcmc_tpu_torch.samplers.ghmc import ghmc
from mcmc_tpu_torch.samplers.gibbs import gibbs
from mcmc_tpu_torch.samplers.hmc import hmc
from mcmc_tpu_torch.samplers.mala import mala
from mcmc_tpu_torch.samplers.mclmc import mams, mclmc
from mcmc_tpu_torch.samplers.mmala import mmala
from mcmc_tpu_torch.samplers.nuts import nuts
from mcmc_tpu_torch.samplers.pt import pt
from mcmc_tpu_torch.samplers.rmhmc import rmhmc
from mcmc_tpu_torch.samplers.rwmh import rwmh
from mcmc_tpu_torch.samplers.sgld import sghmc, sgld
from mcmc_tpu_torch.samplers.slice import slice_sampler
from mcmc_tpu_torch.samplers.smc import smc
from mcmc_tpu_torch.samplers.stretch import stretch
from mcmc_tpu_torch.settings import (AlgoSettings, BarkerSettings,
                                     ChEESSettings, DEMCZSettings,
                                     GHMCSettings, GibbsSettings,
                                     HMCSettings, MALASettings, MAMSSettings,
                                     MCLMCSettings, NUTSSettings, PTSettings,
                                     SliceSettings, StretchSettings)

__all__ = ["sample", "fit"]

_SAMPLERS = {
    "rwmh": rwmh, "mala": mala, "hmc": hmc, "ghmc": ghmc, "nuts": nuts,
    "chees": chees,
    "rmhmc": rmhmc, "de": de, "demcz": demcz, "aees": aees, "pt": pt,
    "smc": smc,
    "stretch": stretch, "sgld": sgld, "sghmc": sghmc,
    "elliptical": elliptical_slice,
    "slice": slice_sampler,
    "gibbs": gibbs,
    "mclmc": mclmc, "mams": mams,
    "barker": barker, "mmala": mmala,
}

# fit's algorithms; the chain samplers start every chain from the
# Laplace or Pathfinder draws, the population samplers from a box or a ball
_CHAIN_ALGOS = ("nuts", "chees", "hmc", "ghmc", "mala", "barker", "slice",
                "mclmc", "mams", "pt", "gibbs")
_FIT_ALGOS = _CHAIN_ALGOS + ("stretch", "demcz")

# fit's disjoint generator streams (stream_generator's stream tuples): the
# Laplace / Pathfinder search, the initial draw, the run, extension round r
_SEARCH, _INIT, _RUN, _EXTEND = 0, 1, 2, 3


def sample(algorithm, initial_vals, log_kernel, settings=None, **kwargs):
    """One-call dispatcher over the samplers.

    ``sample("nuts", x0, log_kernel, settings, n_chains=..., ...)`` is
    equivalent to calling the named entry point directly. RM-HMC and mMALA
    require a ``metric_fn=`` keyword; SGLD and SGHMC interpret
    ``log_kernel`` as the log-PRIOR and require ``log_lik=`` and ``data=``
    keywords; ``"elliptical"`` interprets ``log_kernel`` as the
    log-LIKELIHOOD only (the Gaussian prior via ``prior_mean=`` /
    ``prior_cov=``); ``"gibbs"`` requires ``blocks=``.
    """
    try:
        fn = _SAMPLERS[algorithm]
    except KeyError:
        raise ValueError(
            f"unknown algorithm {algorithm!r}; choose from {sorted(_SAMPLERS)}"
        ) from None
    if algorithm in ("rmhmc", "mmala"):
        metric_fn = kwargs.pop("metric_fn", None)
        if metric_fn is None:
            raise ValueError(f"{algorithm} requires metric_fn=")
        return fn(initial_vals, log_kernel, metric_fn, settings, **kwargs)
    if algorithm == "gibbs" and "blocks" not in kwargs:
        raise ValueError("gibbs requires blocks= (the block partition is "
                         "model structure: [(indices, method[, opts]), ...])")
    if algorithm in ("sgld", "sghmc"):
        log_lik = kwargs.pop("log_lik", None)
        data = kwargs.pop("data", None)
        if log_lik is None or data is None:
            raise ValueError(f"{algorithm} requires log_lik= and data= "
                             f"(log_kernel is the log-prior)")
        return fn(initial_vals, log_kernel, log_lik, data, settings, **kwargs)
    return fn(initial_vals, log_kernel, settings, **kwargs)


def _fit_ravel(initial_vals, log_kernel, lower_bounds, upper_bounds, device):
    """Pytree front-end for :func:`fit`: structured initial values (a dict,
    or anything ``torch.as_tensor`` rejects) ravel through
    :func:`ravel_model`; bounds given as bound trees map through
    :func:`bounds_like`. Returns ``(x0, log_kernel, lb, ub, unravel)`` with
    ``unravel=None`` for plain flat input (and for the classic
    ``(log_kernel, initial_vals)`` swap, which the sampler's set-up then
    refuses with its argument-order TypeError)."""
    if not _is_tree(initial_vals):
        return initial_vals, log_kernel, lower_bounds, upper_bounds, None
    x0, lk, unravel = ravel_model(initial_vals, log_kernel, device)
    if lower_bounds is not None:
        lower_bounds = bounds_like(initial_vals, lower_bounds, -math.inf,
                                   device)
    if upper_bounds is not None:
        upper_bounds = bounds_like(initial_vals, upper_bounds, math.inf,
                                   device)
    return x0, lk, lower_bounds, upper_bounds, unravel


def _validate(algorithm, init, blocks, dense_mass, mesh):
    """fit's argument checks, all before any work, with the JAX package's
    exception types."""
    common.check_mesh(mesh)
    if algorithm == "demcz" and mesh is not None:
        raise ValueError(
            "fit(algorithm='demcz') does not take mesh: the population is "
            "deliberately tiny (scale by replicating runs instead)")
    if init not in (None, "laplace", "pathfinder"):
        raise ValueError(f"fit init must be None, 'laplace', or "
                         f"'pathfinder', got {init!r}")
    if algorithm == "gibbs" and blocks is None:
        raise ValueError(
            "fit(algorithm='gibbs') requires blocks=[(indices, method"
            "[, opts]), ...] — the block partition is the model "
            "structure only you know (see mcmc_tpu_torch.gibbs)")
    if algorithm != "gibbs" and blocks is not None:
        raise ValueError(f"blocks= is gibbs-only, got "
                         f"algorithm={algorithm!r}")
    if algorithm not in _FIT_ALGOS:
        raise ValueError(
            f"fit algorithm must be 'nuts', 'chees', 'hmc', 'ghmc', "
            f"'mala', 'barker', 'mclmc', 'mams', 'pt', 'gibbs', "
            f"'stretch', 'slice', or 'demcz', got {algorithm!r}")
    if dense_mass and algorithm == "barker":
        raise ValueError(
            "fit(algorithm='barker') supports per-coordinate "
            "(diagonal) scales only (dense_mass=False)")
    if dense_mass and algorithm in ("mclmc", "mams"):
        raise ValueError(
            f"fit(algorithm={algorithm!r}) supports diagonal "
            "preconditioning only (dense_mass=False)")
    if dense_mass and algorithm == "gibbs":
        raise ValueError(
            "fit(algorithm='gibbs') has no dense mass — "
            "preconditioning is per-block (pass per-block opts "
            "via blocks=)")


def fit(initial_vals, log_kernel, *, n_chains=8, n_warmup=1000, n_draws=1000,
        key=None, mesh=None, algorithm="nuts", dense_mass=False,
        target_accept=None, max_tree_depth=10, n_leap_steps=16, init=None,
        lower_bounds=None, upper_bounds=None,
        rhat_target=None, min_ess=None, max_rounds=8,
        checkpoint_dir=None, thin=1, blocks=None, warmup_tree_depth=6,
        device=None):
    """One-call posterior fit with full automatic warmup (the JAX package's
    ``fit``; see its docstring for every algorithm's protocol).

    ``algorithm="nuts"`` (default) runs NUTS with pooled dual averaging,
    windowed mass adaptation (diagonal, or dense with ``dense_mass=True``),
    the learned depth budget as the sampling tree's static size and
    ``warmup_tree_depth`` capping the first half of warmup; ``"chees"``,
    ``"hmc"`` (``n_leap_steps``), ``"ghmc"``, ``"mala"``, ``"barker"``,
    ``"mclmc"``, ``"mams"``, ``"pt"``, ``"gibbs"`` (``blocks=``),
    ``"slice"``, ``"stretch"`` and ``"demcz"`` run those samplers with
    their adaptation on. Gradient samplers use the exact unconstrained-space
    gradient (``bounded_grad="exact"``).

    ``init="laplace"`` starts every chain from an overdispersed draw of the
    Laplace Gaussian at the MAP (:func:`map_laplace`); ``init="pathfinder"``
    from PSIS-resampled multi-path Pathfinder draws (:func:`pathfinder`).
    ``lower_bounds``/``upper_bounds`` apply the box-constraint transforms.

    **Pytree models**: ``initial_vals`` may be a parameter pytree with a
    batched ``log_kernel`` taking the same structure (leaves with a leading
    chain axis); fit ravels it (:func:`ravel_model`), bounds may be bound
    trees (:func:`bounds_like`), and ``diagnostics["unravel"]`` maps draws
    back (``unravel_draws(out.draws, out.diagnostics["unravel"])``).

    Run-until-converged: ``rhat_target`` (checked against the max
    rank-normalized split R-hat) and/or ``min_ess`` (the min bulk ESS) keep
    extending the run in warm ``n_draws``-sized segments (no re-warmup,
    adapted state carried) until the gates pass or ``max_rounds`` segments
    have run; ``diagnostics["n_rounds"]`` and ``["converged"]`` record the
    outcome. Every fit attaches ``diagnostics["summary"]``.

    ``checkpoint_dir`` streams kept draws to the native draw sink and
    checkpoints the sampler state and generator so a killed fit resumes
    bit-identically (:mod:`mcmc_tpu_torch.checkpoint`); with the
    convergence gates each extension round re-enters the same directory
    with a larger draw total, and ``out.draws`` is a CPU tensor over the
    sink's file. NUTS then runs without the static sampling depth (its
    state changes shape at the recap).

    ``key`` is a seed or a ``torch.Generator`` (one seed is drawn from it).
    The search, the initial draw, the run and each extension round draw
    from disjoint generators derived from it, so an extension never
    replays the run's stream; with no ``key``, no init and no gate, the
    sampler seeds itself from its settings as the entry points do.
    """
    _validate(algorithm, init, blocks, dense_mass, mesh)
    initial_vals, log_kernel, lower_bounds, upper_bounds, unravel = \
        _fit_ravel(initial_vals, log_kernel, lower_bounds, upper_bounds,
                   device)
    device = resolve_device(device, initial_vals)
    extend = rhat_target is not None or min_ess is not None
    if (extend or init is not None) and key is None:
        key = 0
    seed = None if key is None else key_seed(key)
    stream = lambda *s: stream_generator(seed, *s, device=device)
    bounded = lower_bounds is not None or upper_bounds is not None

    def _algo(inner):
        kw = dict(vals_bound=bounded, lower_bounds=lower_bounds,
                  upper_bounds=upper_bounds) if bounded else {}
        return AlgoSettings(**kw, **inner)

    if init == "laplace":
        lap = map_laplace(initial_vals, log_kernel, _algo({}),
                          key=stream(_SEARCH), device=device)
        approx, draw_init = lap, lambda n: lap.draw_init(stream(_INIT), n)
    elif init == "pathfinder":
        pf = pathfinder(initial_vals, log_kernel, _algo({}),
                        key=stream(_SEARCH), n_draws=256, device=device)
        approx, draw_init = pf, lambda n: pf.draw_init(stream(_INIT), n)
    ckpt = None if checkpoint_dir is None else str(checkpoint_dir)
    if algorithm in _CHAIN_ALGOS and init is not None:
        initial_vals = draw_init(n_chains)
    mass = "dense" if dense_mass else "diag"

    def _run(total_keep, want_resume):
        """One sampler invocation with ``total_keep`` kept draws. In
        checkpointed extension rounds ``total_keep`` grows while the
        directory stays fixed: the chunked runner resumes the stream, and
        the run's generator is derived afresh each time, so every round
        starts from the same state as the first."""
        kw = dict(key=None if seed is None else stream(_RUN), thin=thin,
                  return_resume=want_resume, checkpoint_dir=ckpt,
                  device=device, mesh=mesh)
        grad_kw = dict(bounded_grad="exact")
        if algorithm == "chees":
            cs = ChEESSettings(n_burnin_draws=n_warmup,
                               n_keep_draws=total_keep)
            if target_accept is not None:
                cs.target_accept_rate = target_accept
            return chees(initial_vals, log_kernel,
                         _algo({"chees_settings": cs}), n_chains=n_chains,
                         adapt_mass_matrix=mass, **grad_kw, **kw)
        if algorithm == "nuts":
            s = NUTSSettings(
                n_burnin_draws=n_warmup, n_keep_draws=total_keep,
                n_adapt_draws=n_warmup,
                target_accept_rate=(0.8 if target_accept is None
                                    else target_accept),
                max_tree_depth=max_tree_depth)
            return nuts(initial_vals, log_kernel, _algo({"nuts_settings": s}),
                        n_chains=n_chains, pooled_adaptation=True,
                        adapt_mass_matrix=mass, adapt_depth=True,
                        # the recap changes the state's shape between
                        # warmup and sampling, which a checkpoint cannot
                        static_sampling_depth=ckpt is None,
                        warmup_tree_depth=(
                            None if warmup_tree_depth is None
                            else min(int(warmup_tree_depth),
                                     max_tree_depth)),
                        **grad_kw, **kw)
        if algorithm == "hmc":
            hs = HMCSettings(n_burnin_draws=n_warmup, n_keep_draws=total_keep,
                             n_leap_steps=int(n_leap_steps), step_size=0.1)
            return hmc(initial_vals, log_kernel, _algo({"hmc_settings": hs}),
                       n_chains=n_chains, adapt_step_size=True,
                       target_accept=target_accept, adapt_mass_matrix=mass,
                       **grad_kw, **kw)
        if algorithm == "ghmc":
            gs = GHMCSettings(n_burnin_draws=n_warmup,
                              n_keep_draws=total_keep)
            return ghmc(initial_vals, log_kernel,
                        _algo({"ghmc_settings": gs}), n_chains=n_chains,
                        adapt_step_size=True, target_accept=target_accept,
                        **grad_kw, **kw)
        if algorithm == "mala":
            ms = MALASettings(n_burnin_draws=n_warmup,
                              n_keep_draws=total_keep, step_size=0.1)
            return mala(initial_vals, log_kernel,
                        _algo({"mala_settings": ms}), n_chains=n_chains,
                        adapt_step_size=True, target_accept=target_accept,
                        adapt_precond=mass, pooled_adaptation=True,
                        **grad_kw, **kw)
        if algorithm == "barker":
            bs = BarkerSettings(n_burnin_draws=n_warmup,
                                n_keep_draws=total_keep, step_size=0.5)
            return barker(initial_vals, log_kernel,
                          _algo({"barker_settings": bs}), n_chains=n_chains,
                          adapt_step_size=True, target_accept=target_accept,
                          adapt_precond=True, pooled_adaptation=True, **kw)
        if algorithm == "mclmc":
            ms2 = MCLMCSettings(n_burnin_draws=n_warmup,
                                n_keep_draws=total_keep)
            return mclmc(initial_vals, log_kernel,
                         _algo({"mclmc_settings": ms2}), n_chains=n_chains,
                         adapt_mass=True, **kw)
        if algorithm == "mams":
            as2 = MAMSSettings(n_burnin_draws=n_warmup,
                               n_keep_draws=total_keep)
            if target_accept is not None:
                as2.target_accept_rate = target_accept
            return mams(initial_vals, log_kernel,
                        _algo({"mams_settings": as2}), n_chains=n_chains,
                        adapt_mass=True, **kw)
        if algorithm == "gibbs":
            blocks_eff = blocks
            if target_accept is not None:
                # thread fit's target into every adapted MH block that
                # doesn't set its own
                blocks_eff = []
                for spec in blocks:
                    method = spec[1]
                    opts = dict(spec[2]) if len(spec) == 3 else {}
                    if not callable(method) and method in ("rwmh", "hmc"):
                        opts.setdefault("target_accept", target_accept)
                    blocks_eff.append((spec[0], method, opts) if opts
                                      else (spec[0], method))
            gs = GibbsSettings(n_burnin_draws=n_warmup,
                               n_keep_draws=total_keep)
            return gibbs(initial_vals, log_kernel,
                         _algo({"gibbs_settings": gs}), blocks=blocks_eff,
                         n_chains=n_chains, **kw)
        if algorithm == "pt":
            ps = PTSettings(n_burnin_draws=n_warmup, n_keep_draws=total_keep,
                            adapt_temps=True)
            return pt(initial_vals, log_kernel, _algo({"pt_settings": ps}),
                      n_chains=n_chains, **kw)
        if algorithm == "slice":
            sls = SliceSettings(n_burnin_draws=n_warmup,
                                n_keep_draws=total_keep)
            return slice_sampler(initial_vals, log_kernel,
                                 _algo({"slice_settings": sls}),
                                 n_chains=n_chains, **kw)
        if algorithm == "stretch":
            dim = int(torch.as_tensor(initial_vals).shape[-1])
            n_walkers = max(int(n_chains), 2 * dim, 32)
            n_walkers += n_walkers % 2
            if mesh is not None:   # two shardable halves per device
                m = 2 * int(mesh.size())
                n_walkers = ((n_walkers + m - 1) // m) * m
            ss = StretchSettings(n_walkers=n_walkers, n_burnin_draws=n_warmup,
                                 n_keep_draws=total_keep)
            iv = initial_vals
            if init == "laplace":
                # the ensemble centers on the MAP with curvature-matched
                # spread (the walker ball lives in unconstrained space)
                iv = lap.mode
                ss.init_spread = torch.sqrt(torch.diagonal(lap.cov))
            elif init == "pathfinder":
                iv = pf.center
                ss.init_spread = pf.spread_z
            return stretch(iv, log_kernel, _algo({"stretch_settings": ss}),
                           **kw)
        # demcz
        zs = DEMCZSettings(n_pop=max(int(n_chains), 4),
                           n_burnin_draws=n_warmup, n_keep_draws=total_keep)
        iv = initial_vals
        if init is not None:
            # the initial box is curvature- (Laplace) or spread-matched
            # (Pathfinder), built in unconstrained space and mapped back
            iv = lap.mode if init == "laplace" else pf.center
            zs.initial_lb, zs.initial_ub = approx.init_box(2.0)
        kw.pop("mesh")
        return demcz(iv, log_kernel, _algo({"demcz_settings": zs}), **kw)

    def _gates_ok(d):
        ok = (rhat_target is None
              or float(diagnostics.rank_normalized_rhat(d).max())
              <= rhat_target)
        if ok and min_ess is not None:
            ok = float(diagnostics.bulk_ess(d).min()) >= min_ess
        return ok

    if not extend:
        out = _run(n_draws, False)
    elif ckpt is not None:
        # checkpointed extension: re-enter the same directory with a grown
        # total — the chunked runner resumes the carried generator and
        # state, so each round computes only the new draws (bit-identical
        # to one long run); the gates read the whole sink
        rounds = 1
        while True:
            out = _run(n_draws * rounds, False)
            ok = _gates_ok(out.draws)
            if ok or rounds >= max_rounds:
                break
            rounds += 1
        out.diagnostics["n_rounds"] = rounds
        out.diagnostics["converged"] = ok
    else:
        out = _run(n_draws, True)
        resume = out.diagnostics.pop("resume")
        segs, accepts, rounds = [out.draws], [out.n_accept_draws], 1
        while True:
            d = torch.cat(segs, dim=0) if len(segs) > 1 else segs[0]
            ok = _gates_ok(d)
            if ok or rounds >= max_rounds:
                break
            out = resume(stream(_EXTEND, rounds), n_draws)
            resume = out.diagnostics.pop("resume")
            segs.append(out.draws)
            accepts.append(out.n_accept_draws)
            rounds += 1
        n_acc = accepts[0]
        for a in accepts[1:]:
            n_acc = n_acc + a
        out = SamplerResult(
            draws=d, n_accept_draws=n_acc,
            diagnostics={**out.diagnostics, "n_rounds": rounds,
                         "converged": ok})
    if unravel is not None:
        out.diagnostics["unravel"] = unravel
    out.diagnostics["summary"] = diagnostics.summary(out.draws)
    return out
