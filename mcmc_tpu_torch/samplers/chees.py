"""ChEES-HMC: adaptive-trajectory HMC without tree building (PyTorch port
of ``mcmc_tpu.samplers.chees``).

No reference analog. ChEES-HMC (Hoffman, Radul & Sountsov, AISTATS 2021)
runs plain leapfrog trajectories whose *shared* length ``T`` is learned by
stochastic gradient ascent (Adam on ``log T``) on the ChEES criterion, the
change in the expected squared jump distance, estimated across the chain
batch; the step size is dual-averaged toward 0.651 on the pooled
acceptance; optional windowed mass adaptation, diagonal or dense. See the
JAX module's docstring for the construction; the semantics carry over.

The JAX kernel is single-chain under ``vmap`` with a ``while_loop`` over
leapfrogs; here the chain batch runs in lockstep:

- The leapfrog count ``steps`` comes from pooled quantities (the Halton
  point of the draw, ``T``, the step size), so it is the same in every
  chain. Its smallest and largest values are read to the host once per
  draw, the draw's one host synchronisation; the loop runs to the largest,
  and a chain whose own count is reached keeps its state (the values the
  ``vmap``'d ``while_loop`` gives).
- Pooled expectations (``lax.pmean`` over the named chain axis) are means
  over the chain axis.
- A transition is a draw of its random numbers from the run's one
  ``torch.Generator`` (``step.draw``: the momentum noise, then the accept
  uniform, for all chains) followed by a function of those draws
  (``step.transition``), so the same seed repeats bit for bit and a test can
  feed the draws the JAX step takes from its keys.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mcmc_tpu_torch import adaptation, integrators
from mcmc_tpu_torch.results import SamplerResult
from mcmc_tpu_torch.settings import ChEESSettings
from mcmc_tpu_torch.samplers import common
from mcmc_tpu_torch.samplers._resolve import resolve_settings, resolve_key
from mcmc_tpu_torch.samplers.common import where_chains

__all__ = ["chees", "ChEESState", "build_chees_kernel"]

_U32 = 0xFFFFFFFF


def _vdc_base2(n):
    """Base-2 van der Corput point of positive int32 ``n`` in (0, 1):
    bit-reverse as a binary fraction (the Halton jitter sequence). The bit
    reversal runs in int64 under a 32-bit mask (torch's CPU build has no
    right shift for uint32); the result is the JAX package's f32 value."""
    v = n.to(torch.int64) & _U32
    v = ((v >> 1) & 0x55555555) | ((v & 0x55555555) << 1)
    v = ((v >> 2) & 0x33333333) | ((v & 0x33333333) << 2)
    v = ((v >> 4) & 0x0F0F0F0F) | ((v & 0x0F0F0F0F) << 4)
    v = ((v >> 8) & 0x00FF00FF) | ((v & 0x00FF00FF) << 8)
    v = (v >> 16) | ((v << 16) & _U32)
    # uint32 -> float via two 16-bit halves (f32 keeps ~24 bits)
    hi = (v >> 16).to(torch.float32)
    lo = (v & 0xFFFF).to(torch.float32)
    return (hi * 65536.0 + lo) * (2.0 ** -32)


def _leap_count(t_len, eps, max_steps):
    """``clip(round(t_len / eps), 1, max_steps)`` as int32, with the JAX
    package's float -> int32 cast: NaN counts 0 (so 1 step), +inf saturates
    (so ``max_steps``). Clamped in floating point before the cast, which in
    torch would send NaN and +inf to INT32_MIN."""
    r = torch.nan_to_num(torch.round(t_len / eps), nan=0.0)
    return torch.clamp(r, 1, max_steps).to(torch.int32)


class ChEESState(NamedTuple):
    """Chain-batched ChEES state; every field has the chain batch ``c`` on
    its leading axis, as the JAX package's ``vmap``'d state does."""
    position: torch.Tensor   # (c, d)
    potential: torch.Tensor  # (c,) U = -box_log_kernel(position)
    da: adaptation.DualAveraging   # step-size tuning, (c,) each
    log_T: torch.Tensor      # (c,) log trajectory length (pooled: equal)
    adam_m: torch.Tensor     # (c,) Adam first/second moments for log_T
    adam_v: torch.Tensor
    wv: adaptation.WindowedVariance  # optional diagonal mass
    mSigma: torch.Tensor     # dense mass: posterior covariance ((c, 1) diag)
    mchol: torch.Tensor      # its Cholesky factor ((c, 1) in diag mode)
    mm2: torch.Tensor        # dense outer-product accumulator ((c, 1) diag)
    draw_ind: torch.Tensor   # (c,) int32


def build_chees_kernel(box_log_kernel, grad_fn, cfg: ChEESSettings,
                       n_adapt: int, adapt_mass=False, mass_cfg=None):
    """Batch-pooled ChEES transition: returns ``init(positions) ->
    ChEESState`` and ``step(gen, state) -> (state, info)``.

    ``box_log_kernel`` and ``grad_fn`` are batched (``(c, d) -> (c,)`` and
    ``(c, d) -> (c, d)``). ``adapt_mass``: False / True / "diag" / "dense"
    (``mass_cfg`` from :func:`mcmc_tpu_torch.adaptation.make_precond_cfg`
    supplies the window schedule). ``step.draw(gen, state) -> (noise, u)``
    and ``step.transition(state, noise, u)`` are its two halves;
    ``step.counts`` tallies draws, leapfrogs and host synchronisations.
    """
    max_steps = int(cfg.max_leap_steps)
    adam_lr = float(cfg.adam_learning_rate)
    target = float(cfg.target_accept_rate)
    mass_mode = {False: None, True: "diag"}.get(adapt_mass, adapt_mass)
    if mass_mode not in (None, "diag", "dense"):
        raise ValueError(f"adapt_mass must be False/True/'diag'/'dense', "
                         f"got {adapt_mass!r}")
    dense = mass_mode == "dense"
    adapt_mass = mass_mode is not None

    def potential(z):
        u = -box_log_kernel(z)
        return torch.where(torch.isfinite(u), u, torch.inf)

    def sigma_mv(sigma, v):
        return (sigma @ v[:, :, None])[:, :, 0]

    counts = {"draws": 0, "leapfrogs": 0, "syncs": 0}

    def draw(gen, state: ChEESState):
        pos = state.position
        kw = {"generator": gen, "dtype": pos.dtype, "device": pos.device}
        return (torch.randn(pos.shape, **kw),
                torch.rand(pos.shape[:1], **kw))

    def transition(state: ChEESState, noise, u):
        pos = state.position
        c, dim = pos.shape

        adapting = state.draw_ind < n_adapt
        eps = torch.exp(torch.where(adapting, state.da.log_eps,
                                    state.da.log_eps_bar))
        inv_mass = state.wv.var if (adapt_mass and not dense) \
            else torch.ones_like(pos)

        # shared jittered trajectory length -> shared leapfrog count
        h = _vdc_base2(state.draw_ind + 1).to(pos.dtype)
        T = torch.exp(state.log_T)
        steps = _leap_count(h * T, eps, max_steps)

        if dense:
            # Sigma = L L^T; p ~ N(0, Sigma^{-1})
            p0 = torch.linalg.solve_triangular(
                state.mchol.transpose(1, 2), noise[:, :, None],
                upper=True)[:, :, 0]
            prev_K = 0.5 * (p0 * sigma_mv(state.mSigma, p0)).sum(-1)
        else:
            p0 = noise * torch.rsqrt(inv_mass)
            prev_K = 0.5 * (p0 * p0 * inv_mass).sum(-1)

        # the draw's one host synchronisation: the loop's length
        lo, hi = torch.stack(torch.aminmax(steps)).tolist()
        counts["syncs"] += 1
        counts["draws"] += 1
        counts["leapfrogs"] += hi
        half_eps, eps_c = (0.5 * eps)[:, None], eps[:, None]
        z, p, g = pos, p0, grad_fn(pos)
        for i in range(hi):
            p_half = p + half_eps * g
            if dense:
                z_new = z + eps_c * sigma_mv(state.mSigma, p_half)
            else:
                z_new = z + eps_c * (inv_mass * p_half)
            g_new = grad_fn(z_new)
            p_new = p_half + half_eps * g_new
            if i < lo:
                z, p, g = z_new, p_new, g_new
            else:   # chains whose own count is reached keep their state
                go = i < steps
                z, p, g = (where_chains(go, z_new, z),
                           where_chains(go, p_new, p),
                           where_chains(go, g_new, g))
        z_prop, p_prop = z, p

        prop_U = potential(z_prop)
        if dense:
            prop_K = 0.5 * (p_prop * sigma_mv(state.mSigma, p_prop)).sum(-1)
        else:
            prop_K = 0.5 * (p_prop * p_prop * inv_mass).sum(-1)
        log_alpha = torch.clamp_max(
            -(prop_U + prop_K) + (state.potential + prev_K), 0.0)
        alpha = torch.where(torch.isnan(log_alpha), 0.0, torch.exp(log_alpha))
        accepted = u < alpha

        position = where_chains(accepted, z_prop, pos)
        pot_out = torch.where(accepted, prop_U, state.potential)

        # --- ChEES gradient for T, pooled over the chains; distances in the
        # mass-matrix metric (see the JAX module for why)
        mu0 = pos.mean(dim=0)
        mu1 = z_prop.mean(dim=0)
        if dense:
            # ||d||_M^2 = ||L^{-1} d||^2 with Sigma = L L^T
            w1 = torch.linalg.solve_triangular(
                state.mchol, (z_prop - mu1)[:, :, None], upper=False)
            w0 = torch.linalg.solve_triangular(
                state.mchol, (pos - mu0)[:, :, None], upper=False)
            d_sq = (w1 * w1).sum((1, 2)) - (w0 * w0).sum((1, 2))
        else:
            d_sq = ((z_prop - mu1) ** 2 / inv_mass).sum(-1) \
                - ((pos - mu0) ** 2 / inv_mass).sum(-1)
        g_chain = alpha * d_sq * ((z_prop - mu1) * p_prop).sum(-1)
        # one overflowed trajectory must not poison the pooled gradient:
        # divergent chains contribute zero
        g_chain = torch.where(torch.isfinite(g_chain), g_chain, 0.0)
        accept_stat = alpha.mean().expand(c)
        denom = torch.clamp_min(accept_stat, 1e-4)
        g_T = g_chain.mean() / denom * h
        g_logT = torch.clamp(g_T * T, -1e6, 1e6)   # guard overflow into Adam

        t_adam = state.draw_ind.to(pos.dtype) + 1.0
        m_new = 0.9 * state.adam_m + 0.1 * g_logT
        v_new = 0.999 * state.adam_v + 0.001 * g_logT ** 2
        m_hat = m_new / (1.0 - 0.9 ** t_adam)
        v_hat = v_new / (1.0 - 0.999 ** t_adam)
        log_T_new = state.log_T + adam_lr * m_hat / (torch.sqrt(v_hat) + 1e-8)
        # keep T within sane bounds of the current step size
        log_T_new = torch.clamp(log_T_new, torch.log(eps),
                                torch.log(eps * max_steps))

        log_T_out = torch.where(adapting, log_T_new, state.log_T)
        adam_m_out = torch.where(adapting, m_new, state.adam_m)
        adam_v_out = torch.where(adapting, v_new, state.adam_v)

        # step size: dual averaging on the pooled acceptance
        da_new = adaptation.da_update(state.da, accept_stat, target)
        da = adaptation.DualAveraging(*[torch.where(adapting, new, old)
                                        for new, old in zip(da_new, state.da)])

        wv = state.wv
        mSigma, mchol, mm2 = state.mSigma, state.mchol, state.mm2
        if adapt_mass and not dense:
            wv, _ = adaptation.windowed_precond_step(
                wv, da, position, state.draw_ind, mass_cfg, reset_da=False)
        elif dense:
            wv, da, mSigma, mchol, mm2 = adaptation.windowed_dense_step(
                state.wv, da, mSigma, mchol, mm2,
                position, state.draw_ind, mass_cfg, reset_da=False)

        new_state = ChEESState(
            position=position, potential=pot_out, da=da,
            log_T=log_T_out, adam_m=adam_m_out, adam_v=adam_v_out,
            wv=wv, mSigma=mSigma, mchol=mchol, mm2=mm2,
            draw_ind=state.draw_ind + 1,
        )
        info = {
            "accepted": accepted,
            "accept_stat": alpha,
            "n_leap": steps,
            "trajectory_length": T,
            "step_size": eps,
        }
        return new_state, info

    def step(gen, state: ChEESState):
        return transition(state, *draw(gen, state))

    def init(position):
        c, dim = position.shape
        kw = {"dtype": position.dtype, "device": position.device}
        eps0 = torch.full((c,), float(cfg.step_size), **kw)
        if dense:
            eye = torch.eye(dim, **kw).expand(c, dim, dim)
            mSigma, mchol = eye.clone(), eye.clone()
            mm2 = torch.zeros((c, dim, dim), **kw)
        else:
            mSigma = mchol = mm2 = torch.ones((c, 1), **kw)
        with torch.no_grad():
            pot = potential(position)
        zero = torch.zeros((c,), **kw)
        return ChEESState(
            position=position,
            potential=pot,
            da=adaptation.da_init(eps0),
            log_T=torch.log(eps0 * cfg.init_leap_steps),
            adam_m=zero, adam_v=zero.clone(),
            wv=adaptation.wv_init(dim, position.dtype, c, position.device),
            mSigma=mSigma, mchol=mchol, mm2=mm2,
            draw_ind=torch.zeros((c,), dtype=torch.int32,
                                 device=position.device),
        )

    step.draw, step.transition, step.counts = draw, transition, counts
    return init, step


def chees(initial_vals, log_kernel, settings=None, *, n_chains=None, key=None,
          mesh=None, checkpoint_dir=None, checkpoint_every=500, dtype=None,
          bounded_grad="reference", adapt_mass_matrix=False,
          thin=1, return_resume=False, device=None) -> SamplerResult:
    """Run ChEES-HMC (see module docstring). Requires ``n_chains`` >= ~16:
    the trajectory-length criterion pools cross-chain expectations.

    Returns kept draws plus diagnostics: per-draw trajectory length, leap
    counts, step size, accept statistic, and the adapted values (per
    chain). ``log_kernel`` is batched: ``(n_chains, n_vals) -> (n_chains,)``.
    ``key`` is a ``torch.Generator`` or an integer seed (``None``: the
    settings' ``rng_seed_value``); ``device`` defaults to that of
    ``initial_vals``, else the card. ``return_resume=True`` attaches
    ``diagnostics["resume"](key, n_keep)``, a warm continuation from the
    final kernel state. ``mesh`` is not ported yet and raises;
    ``checkpoint_dir`` runs in restartable chunks
    (:mod:`mcmc_tpu_torch.checkpoint`)."""
    algo, s = resolve_settings(settings, "chees_settings", ChEESSettings)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")

    prob = common.setup_problem(initial_vals, log_kernel, algo, n_chains,
                                dtype, device)
    if prob.n_chains < 2:
        raise ValueError("chees needs n_chains >= 2 (cross-chain pooling); "
                         "use hmc/nuts for single-chain runs")
    gen = resolve_key(key, algo, prob.device)
    grad_fn = integrators.make_kick_grad(prob, bounded_grad)

    mass_cfg = None
    if adapt_mass_matrix:
        mass_cfg = adaptation.make_precond_cfg(s.n_burnin_draws, pooled=True,
                                               device=prob.device)

    init, step = build_chees_kernel(prob.box_log_kernel, grad_fn, s,
                                    s.n_burnin_draws, adapt_mass_matrix,
                                    mass_cfg)
    state0 = init(prob.first_draw)

    def assemble(key, state0, n_burnin, n_keep):
        final_state, draws, infos = common.run_sampler_loop(
            resolve_key(key, algo, prob.device), state0, step, n_burnin,
            n_keep, collect_fn=lambda st: st.position, mesh=mesh,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            thin=thin,
        )

        n_accept = common.tally_accepts(infos)
        draws = common.finalize_draws(draws, prob)
        if "accepted" in infos:
            diagnostics = {
                "accept_stat": infos["accept_stat"],
                "n_leap": infos["n_leap"],
                "trajectory_length": infos["trajectory_length"],
                "step_size": infos["step_size"],
            }
        else:
            # checkpointed run: the per-chain totals as means
            totals = infos["totals"]
            diagnostics = {
                "mean_accept_stat": torch.as_tensor(totals["accept_stat"])
                / n_keep,
                "mean_n_leap": torch.as_tensor(totals["n_leap"]) / n_keep,
            }
        diagnostics["adapted_step_size"] = torch.exp(
            final_state.da.log_eps_bar)
        diagnostics["adapted_trajectory_length"] = torch.exp(
            final_state.log_T)
        if prob.squeeze:
            draws = draws[:, 0, :]
            n_accept = n_accept[0]
            diagnostics = {k: (v[:, 0] if v.ndim == 2 else v[0])
                           for k, v in diagnostics.items()}
        if thin > 1:   # accept_rate divides by n_keep*thin
            diagnostics["thin"] = int(thin)
        return SamplerResult(draws=draws, n_accept_draws=n_accept,
                             diagnostics=diagnostics), final_state

    result, final_state = assemble(gen, state0, s.n_burnin_draws,
                                   s.n_keep_draws)
    if return_resume:
        common.attach_resume(result, assemble, final_state)
    return result
