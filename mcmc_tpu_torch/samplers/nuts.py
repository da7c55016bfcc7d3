"""No-U-Turn sampler with dual-averaging step-size adaptation (PyTorch port
of ``mcmc_tpu.samplers.nuts``).

Reference src/nuts.cpp:30-359 + include/mcmc/nuts.ipp:30-241, rebuilt in
the JAX package as an iterative tree (a doubling loop over subtrees, each a
loop over leaves with progressive U-turn checks against a checkpoint buffer
of ``max_tree_depth + 1`` boundary states, and a reservoir proposal). See
that module's docstring for the construction, the ``tree_variant``
deviation and the reference quirks, which all carry over unchanged.

The JAX kernel is single-chain with data-dependent ``while_loop``s, run
under ``vmap``: each loop then runs until every lane is done and a finished
lane's carry is frozen. This kernel keeps that rule explicitly, on a chain
batch in lockstep:

- Every chain that is still doubling is at the same ``depth``, and every
  live chain of a subtree at the same leaf ``i``, so both are host
  integers: the checkpoint store happens only at the leaves that store, and
  the U-turn checks visit only the levels that complete at leaf ``i``.
  These are the values of the masked form, with fewer operations.
- Per-chain masks freeze what the loop conditions would have stopped: a
  chain whose subtree stopped (``s == 0``), or one past its own depth
  budget, leaves every carried tensor unchanged.
- The doubling loop ends when no chain is active; that ``.any()`` is the
  only host synchronisation of a draw (none at the first doubling, which
  every chain runs). The leaf loop runs all ``2^depth`` leaves.
- Every random tensor is drawn for all chains, masked or not, from the
  run's one ``torch.Generator``: the stream consumed does not depend on the
  masks, and a seed on one device repeats bit for bit.
- Pooled reductions (``pooled_adaptation``: the initial step size, the
  accept statistic, the depth histogram and the mass estimate) are means
  or sums over the chain axis, where the JAX package uses ``lax.pmean`` /
  ``lax.psum`` over its named chain axis.
- ``draw_ind`` is the same for every chain, so it and the adaptation
  schedule it drives are host values.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from mcmc_tpu_torch import adaptation
from mcmc_tpu_torch import integrators
from mcmc_tpu_torch.parallel.mesh import chain_any, chain_mean, chain_sum
from mcmc_tpu_torch.results import SamplerResult
from mcmc_tpu_torch.settings import NUTSSettings
from mcmc_tpu_torch.samplers import common
from mcmc_tpu_torch.samplers._resolve import resolve_settings, resolve_key
from mcmc_tpu_torch.samplers.common import where_chains

__all__ = ["nuts", "NUTSState", "build_nuts_kernel", "make_subtree_builder"]

_MAX_TUNING_PAR = 1000.0  # Delta_max, reference nuts.ipp:124
_LOG_HALF = math.log(0.5)


class NUTSState(NamedTuple):
    """Chain-batched NUTS state: ``c`` chains of ``d`` values. ``draw_ind``
    and ``adapt_t0`` are the same for every chain, so they are host ints."""
    position: torch.Tensor     # (c, d)
    potential: torch.Tensor    # (c,) U = -box_log_kernel(position)
    step_size: torch.Tensor    # (c,)
    epsilon_bar: torch.Tensor  # (c,)
    h_val: torch.Tensor        # (c,)
    mu_val: torch.Tensor       # (c,) log(10 eps_0); re-centered at window ends
    draw_ind: int              # global draw counter driving adaptation
    adapt_t0: int              # draw index of the last mass-window end
    inv_mass: torch.Tensor     # inverse mass: (c, d) diag or (c, d, d) dense
    mass_chol: torch.Tensor    # chol of inv_mass (dense; (c, 1) otherwise)
    w_count: torch.Tensor      # (c,) int32 Welford count of the window
    w_mean: torch.Tensor       # (c, d)
    w_m2: torch.Tensor         # (c, d) diagonal or (c, d, d) dense
    depth_hist: torch.Tensor   # (c, max_depth + 1) int32 warmup depth counts
    depth_cap: torch.Tensor    # (c,) int32 doubling budget for sampling


def _ctz(x: int) -> int:
    """Count trailing zeros of a positive int (0 for odd x)."""
    return (x & -x).bit_length() - 1


def make_subtree_builder(potential, kinetic, leapfrog1, max_depth,
                         multinomial=False):
    """Batched equivalent of the JAX package's masked-iterative subtree
    (itself the reference's recursive ``nuts_build_tree``, nuts.ipp:99-241).

    ``potential(z)``, ``kinetic(r, inv_mass)`` and ``leapfrog1(z, r, eps,
    inv_mass)`` are the batched Hamiltonian pieces (``eps`` per chain);
    returns ``build_subtree``. ``multinomial=True`` replaces the slice
    weights by Boltzmann weights ``exp(H0 - H)`` (``log_u`` then carries
    ``+H0``) and ``n`` is the float weight sum instead of an int32 count.
    """

    def build_subtree(gen, depth, v, z0, r0, eps, log_u, alpha_base,
                      active=None, inv_mass=None):
        """One subtree of ``2^depth`` leapfrog steps for every chain, chain
        ``k`` in direction ``v[k]`` from ``(z0[k], r0[k])``. ``depth`` is a
        host int; ``v``, ``eps``, ``log_u``, ``alpha_base`` are ``(c,)``;
        chains where ``active`` is false are left as they are. Draws one
        uniform per chain and leaf from ``gen`` for the reservoir.

        Returns a dict with the proposal (``prop_z``/``prop_U``), weight
        ``n``, stop flag ``s``, dual-averaging ``alpha``/``n_alpha``,
        trajectory endpoint (``z``, ``r``), the checkpoint buffers
        ``(c, max_depth + 1, d)`` and the divergence flag ``div``."""
        c, dim = z0.shape
        kw = {"dtype": z0.dtype, "device": z0.device}
        live = torch.ones((c,), dtype=torch.bool, device=z0.device) \
            if active is None else active
        started = live
        step = (v * eps)[:, None]
        v2 = v[:, None]
        z, r = z0, r0
        prop_z = z0
        prop_U = torch.full((c,), torch.inf, **kw)
        # the slice count is kept in the float dtype (exact: at most 2^10
        # leaves) and returned as int32, as the JAX package carries it
        n = torch.zeros((c,), **kw)
        alpha = torch.zeros((c,), **kw)
        n_alpha = torch.zeros((c,), dtype=torch.int32, device=z0.device)
        div = torch.zeros((c,), dtype=torch.bool, device=z0.device)
        ckpt_z = torch.zeros((c, max_depth + 1, dim), **kw)
        ckpt_r = torch.zeros((c, max_depth + 1, dim), **kw)

        for i in range(1 << depth):
            zu = torch.rand((c,), generator=gen, **kw)
            z1, r1 = leapfrog1(z, r, step, inv_mass)
            U = potential(z1)
            H = U + kinetic(r1, inv_mass)
            nan_H = torch.isnan(H)

            if multinomial:
                # Boltzmann leaf weight w = exp(H0 - H); log_u carries +H0
                log_w = torch.where(nan_H, -torch.inf, log_u - H)
                weight = torch.exp(torch.clamp_max(log_w, 80.0))
                diverged = ~(log_w > -_MAX_TUNING_PAR)
            else:
                weight = (log_u <= -H).to(z0.dtype)
                diverged = ~(log_u < _MAX_TUNING_PAR - H)
            n1 = n + weight
            # NaN H contributes alpha = 0, as the reference's
            # std::min(0., NaN) does (nuts.ipp:152); min(0, NaN) is NaN here
            alpha_leaf = torch.where(
                nan_H, 0.0, torch.exp(torch.clamp_max(alpha_base - H, 0.0)))

            # weighted-reservoir proposal: take with prob w_leaf / W_new
            take = live & (zu * n1 < weight)
            live2 = live[:, None]

            # checkpoint store: slot ctz(i) for even i > 0, slot depth for i 0
            if i % 2 == 0:
                slot = depth if i == 0 else _ctz(i)
                ckpt_z[:, slot] = torch.where(live2, z1, ckpt_z[:, slot])
                ckpt_r[:, slot] = torch.where(live2, r1, ckpt_r[:, slot])

            # progressive U-turn checks at the sub-subtrees leaf i completes
            stop = diverged
            for lev in range(1, depth + 1):
                size = 1 << lev
                if (i + 1) % size:
                    break
                j = i + 1 - size
                slot_j = depth if j == 0 else _ctz(j)
                dvec = v2 * (z1 - ckpt_z[:, slot_j])
                # not (a >= 0 and b >= 0): a NaN product stops the chain
                stop = stop | ~(((dvec * ckpt_r[:, slot_j]).sum(-1) >= 0)
                                & ((dvec * r1).sum(-1) >= 0))

            z = torch.where(live2, z1, z)
            r = torch.where(live2, r1, r)
            prop_z = torch.where(take[:, None], z1, prop_z)
            prop_U = torch.where(take, U, prop_U)
            n = torch.where(live, n1, n)
            alpha = torch.where(live, alpha + alpha_leaf, alpha)
            n_alpha = n_alpha + live
            div = div | (live & diverged)
            live = live & ~stop

        return {"z": z, "r": r, "prop_z": prop_z, "prop_U": prop_U,
                "n": n if multinomial else n.to(torch.int32),
                "s": (live | ~started).to(torch.int32),
                "alpha": alpha, "n_alpha": n_alpha,
                "ckpt_z": ckpt_z, "ckpt_r": ckpt_r, "div": div}

    return build_subtree


def find_initial_step_size(potential, kinetic, leapfrog1, z0, r0,
                           inv_mass=None):
    """Per-chain initial step size, reference nuts.ipp:30-93: doubling only
    (the halving branch is unreachable there), the leapfrog continuing from
    the last position, at most 64 doublings. One host synchronisation per
    doubling."""
    H0 = potential(z0) + kinetic(r0, inv_mass)
    eps = torch.ones_like(H0)
    z, r = leapfrog1(z0, r0, eps, inv_mass)
    dH = -(potential(z) + kinetic(r, inv_mass)) + H0
    for _ in range(64):
        go = dH > _LOG_HALF
        if not bool(go.any()):
            break
        eps = torch.where(go, eps * 2.0, eps)
        z1, r1 = leapfrog1(z, r, eps, inv_mass)
        z, r = where_chains(go, z1, z), where_chains(go, r1, r)
        dH = torch.where(go, -(potential(z) + kinetic(r, inv_mass)) + H0, dH)
    return eps


def depth_cap_rule(depth_hist, depth_quantile, max_depth, pooled=False):
    """The sampling phase's doubling budget from warmup depth counts
    ``(c, max_depth + 1)``: the ``depth_quantile`` depth + 1, clamped to
    ``max_depth``; ``pooled`` sums the counts over chains first, so every
    chain gets one budget. Returns ``(c,)`` int32."""
    hist = chain_sum(depth_hist, dim=0, keepdim=True) if pooled \
        else depth_hist
    total = torch.clamp_min(hist.sum(dim=-1, keepdim=True), 1)
    cum = torch.cumsum(hist, dim=-1)
    q_depth = (cum >= depth_quantile * total.to(torch.float32)) \
        .to(torch.uint8).argmax(dim=-1)
    cap = torch.clamp_max(q_depth.to(torch.int32) + 1, max_depth)
    return cap.expand(depth_hist.shape[0]).clone()


def build_nuts_kernel(box_log_kernel, grad_fn, precond: common.SPD,
                      cfg: NUTSSettings, n_adapt: int,
                      pooled_adaptation: bool = False,
                      adapt_mass_matrix=False, adapt_depth=False,
                      depth_quantile: float = 0.98,
                      tree_variant: str = "endpoint",
                      sample_method: str = "slice",
                      warmup_tree_depth=None):
    """Batched NUTS kernel: returns ``init(gen, positions) -> NUTSState``
    and ``step(gen, state) -> (state, info)``. ``step.counts`` accumulates
    the kernel's draws, doublings, leaves and host synchronisations."""
    if tree_variant not in ("endpoint", "reference"):
        raise ValueError(f"tree_variant must be 'endpoint' or 'reference', "
                         f"got {tree_variant!r}")
    if sample_method not in ("slice", "multinomial"):
        raise ValueError(f"sample_method must be 'slice' or 'multinomial', "
                         f"got {sample_method!r}")
    multinomial = sample_method == "multinomial"
    if multinomial and tree_variant == "reference":
        raise ValueError("sample_method='multinomial' is a modern variant; "
                         "it does not combine with tree_variant='reference'")
    max_depth = int(cfg.max_tree_depth)
    # adapt_mass_matrix: False | "diag" (True) | "dense"
    mass_mode = {False: None, True: "diag"}.get(adapt_mass_matrix,
                                                adapt_mass_matrix)
    if mass_mode not in (None, "diag", "dense"):
        raise ValueError(f"adapt_mass_matrix must be False/True/'diag'/'dense', "
                         f"got {adapt_mass_matrix!r}")
    adapt_mass = mass_mode is not None
    if adapt_mass:
        collect, window_end = adaptation.window_schedule(n_adapt, "cpu")
        mass_collect, mass_window_end = collect.tolist(), window_end.tolist()

    def potential(z):
        u = -box_log_kernel(z)
        return torch.where(torch.isfinite(u), u, torch.inf)

    def inv_mv_of(inv_mass):
        if mass_mode == "diag":
            return lambda p: inv_mass * p
        if mass_mode == "dense":
            return lambda p: (inv_mass @ p[:, :, None])[:, :, 0]
        return precond.inv_mv

    def kinetic(r, inv_mass=None):
        if mass_mode == "diag":
            return 0.5 * (r * r * inv_mass).sum(dim=-1)
        if mass_mode == "dense":     # inv_mass = Sigma = M^{-1}
            return 0.5 * (r * (inv_mass @ r[:, :, None])[:, :, 0]).sum(dim=-1)
        return integrators.kinetic_energy(r, precond.inv_mv)

    def leapfrog1(z, r, eps, inv_mass=None):
        return integrators.leapfrog(grad_fn, inv_mv_of(inv_mass), eps, 1,
                                    z, r)

    def sample_momentum(noise, inv_mass, mass_chol):
        if mass_mode == "diag":
            # M = diag(1/inv_mass) => chol(M) = 1/sqrt(inv_mass)
            return noise * torch.rsqrt(inv_mass)
        if mass_mode == "dense":
            # Sigma = L L^T, M = Sigma^{-1} => p = L^{-T} xi ~ N(0, M)
            return torch.linalg.solve_triangular(
                mass_chol.transpose(1, 2), noise[:, :, None],
                upper=True)[:, :, 0]
        return precond.sqrt_mv(noise)

    build_subtree = make_subtree_builder(potential, kinetic, leapfrog1,
                                         max_depth, multinomial)

    def init(gen, position):
        c, dim = position.shape
        kw = {"dtype": position.dtype, "device": position.device}
        if mass_mode == "dense":
            inv_mass0 = torch.eye(dim, **kw).expand(c, dim, dim).clone()
            chol0 = inv_mass0.clone()
            w_m2_0 = torch.zeros((c, dim, dim), **kw)
        else:
            inv_mass0 = torch.ones((c, dim), **kw)
            chol0 = torch.ones((c, 1), **kw)
            w_m2_0 = torch.zeros((c, dim), **kw)
        with torch.no_grad():
            noise = torch.randn((c, dim), generator=gen, **kw)
            r0 = sample_momentum(noise, inv_mass0, chol0)
            eps0 = find_initial_step_size(potential, kinetic, leapfrog1,
                                          position, r0, inv_mass0)
            if pooled_adaptation:
                # geometric mean across chains: one common epsilon_0 / mu
                eps0 = torch.exp(torch.log(eps0).mean()).expand(c).clone()
            potential0 = potential(position)
        izeros = torch.zeros((c,), dtype=torch.int32, device=position.device)
        return NUTSState(
            position=position,
            potential=potential0,
            step_size=eps0,
            epsilon_bar=torch.full((c,), float(cfg.step_size), **kw),
            h_val=torch.zeros((c,), **kw),
            mu_val=torch.log(10.0 * eps0),
            draw_ind=0,
            adapt_t0=0,
            inv_mass=inv_mass0,
            mass_chol=chol0,
            w_count=izeros,
            w_mean=torch.zeros((c, dim), **kw),
            w_m2=w_m2_0,
            depth_hist=torch.zeros((c, max_depth + 1), dtype=torch.int32,
                                   device=position.device),
            depth_cap=torch.full((c,), max_depth, dtype=torch.int32,
                                 device=position.device),
        )

    counts = {"draws": 0, "doublings": 0, "leaves": 0, "syncs": 0}

    def step(gen, state: NUTSState):
        pos = state.position
        c, dim = pos.shape
        kw = {"dtype": pos.dtype, "device": pos.device}
        draw_ind = state.draw_ind

        noise = torch.randn((c, dim), generator=gen, **kw)
        inv_mass = state.inv_mass
        r0 = sample_momentum(noise, inv_mass, state.mass_chol)
        prev_K = kinetic(r0, inv_mass)
        if multinomial:
            # no slice variable: log_u carries +H0 so leaves weight as
            # exp(log_u - H) = exp(H0 - H)
            log_u = state.potential + prev_K
        else:
            log_u = torch.log(torch.rand((c,), generator=gen, **kw)) \
                - state.potential - prev_K
        eps = state.step_size

        n = torch.ones((c,), **kw) if multinomial else \
            torch.ones((c,), dtype=torch.int32, device=pos.device)
        s = torch.ones((c,), dtype=torch.int32, device=pos.device)
        draw, U = pos, state.potential
        pos_z = neg_z = pos
        pos_r = neg_r = r0
        alpha = torch.zeros((c,), **kw)
        n_alpha = torch.zeros((c,), dtype=torch.int32, device=pos.device)
        good = torch.zeros((c,), dtype=torch.bool, device=pos.device)
        div = torch.zeros((c,), dtype=torch.bool, device=pos.device)
        tree_depth = torch.zeros((c,), dtype=torch.int32, device=pos.device)

        # depth budget: the full max_depth during warmup; after it, the
        # learned budget (per chain unless pooled); warmup_tree_depth caps
        # the first half of warmup only (see the JAX package's nuts())
        depth_limit, chain_limit = max_depth, None
        if adapt_depth and draw_ind >= n_adapt:
            chain_limit = state.depth_cap
        if warmup_tree_depth is not None and draw_ind < n_adapt // 2:
            depth_limit = min(max_depth, int(warmup_tree_depth))

        n_doublings = 0
        for depth in range(depth_limit):
            active = s == 1
            if chain_limit is not None:
                active = active & (chain_limit > depth)
            if depth > 0:
                # the draw's one kind of host synchronisation; the first
                # doubling runs for every chain (every budget is >= 1)
                counts["syncs"] += 1
                if not bool(chain_any(active)):
                    break
            n_doublings += 1
            v = torch.where(torch.rand((c,), generator=gen, **kw) <= 0.5,
                            -1.0, 1.0).to(pos.dtype)
            backward = v < 0

            if tree_variant == "reference":
                # reference quirk (src/nuts.cpp:242-255): every doubling
                # restarts from the current draw with the draw's initial
                # momentum; the alpha baseline tracks the updated draw
                start_z, start_r = draw, r0
                alpha_base = U + prev_K
            else:
                # Hoffman-Gelman Algorithm 6: extend from the endpoint in
                # the chosen direction
                start_z = where_chains(backward, neg_z, pos_z)
                start_r = where_chains(backward, neg_r, pos_r)
                alpha_base = state.potential + prev_K

            sub = build_subtree(gen, depth, v, start_z, start_r, eps, log_u,
                                alpha_base, active, inv_mass)

            zu = torch.rand((c,), generator=gen, **kw)
            do_acc = active & (sub["s"] == 1) \
                & (zu * n.to(pos.dtype) < sub["n"].to(pos.dtype))
            draw = where_chains(do_acc, sub["prop_z"], draw)
            U = torch.where(do_acc, sub["prop_U"], U)

            to_neg, to_pos = active & backward, active & ~backward
            neg_z = where_chains(to_neg, sub["z"], neg_z)
            neg_r = where_chains(to_neg, sub["r"], neg_r)
            pos_z = where_chains(to_pos, sub["z"], pos_z)
            pos_r = where_chains(to_pos, sub["r"], pos_r)

            span = pos_z - neg_z
            check1 = (span * neg_r).sum(dim=-1) >= 0
            check2 = (span * pos_r).sum(dim=-1) >= 0
            s_new = sub["s"] * check1.to(torch.int32) * check2.to(torch.int32)
            s = torch.where(active, s_new, s)
            n = torch.where(active, n + sub["n"], n)
            alpha = torch.where(active, sub["alpha"], alpha)
            n_alpha = torch.where(active, sub["n_alpha"], n_alpha)
            good = good | do_acc
            div = div | (active & sub["div"])
            tree_depth = tree_depth + active.to(torch.int32)
        counts["draws"] += 1
        counts["doublings"] += n_doublings
        counts["leaves"] += (1 << n_doublings) - 1

        # dual averaging (reference src/nuts.cpp:294-302); pooled, the
        # accept statistic is the chains' mean, so all chains share one
        # step-size trajectory; with mass adaptation the averaging clock
        # restarts at each window end (adapt_t0), Stan-style
        t = float(draw_ind - state.adapt_t0)
        adapting = draw_ind < n_adapt
        accept_stat = alpha / torch.clamp_min(n_alpha, 1).to(pos.dtype)
        if pooled_adaptation:
            accept_stat = chain_mean(accept_stat).expand(c)
        if adapting:
            h_out = state.h_val + (1.0 / (t + 1.0 + cfg.t0_val)) \
                * (cfg.target_accept_rate - accept_stat - state.h_val)
            step_size_out = torch.exp(
                state.mu_val - h_out * math.sqrt(t + 1.0) / cfg.gamma_val)
            ebar_out = state.epsilon_bar * torch.exp(
                (t + 1.0) ** (-cfg.kappa_val)
                * (torch.log(step_size_out) - torch.log(state.epsilon_bar)))
        else:
            step_size_out = ebar_out = state.epsilon_bar
            h_out = state.h_val
        mu_out = state.mu_val
        t0_out = state.adapt_t0
        inv_mass_out, chol_out = state.inv_mass, state.mass_chol
        wc, wm, wv = state.w_count, state.w_mean, state.w_m2

        if adapt_mass and adapting:
            idx = min(draw_ind, len(mass_collect) - 1)
            collecting, window_end = mass_collect[idx], mass_window_end[idx]
            if collecting or window_end:
                full = lambda b: torch.full((c,), b, dtype=torch.bool,
                                            device=pos.device)
                wc, wm, wv, inv_mass_out, chol_out = \
                    adaptation.windowed_mass_update(
                        wc, wm, wv, inv_mass_out, chol_out, draw,
                        full(collecting), full(window_end), mass_mode,
                        pooled=pooled_adaptation)
            if window_end:
                mu_out = torch.log(10.0 * step_size_out)
                h_out = torch.zeros_like(h_out)
                t0_out = draw_ind + 1
                ebar_out = step_size_out

        depth_hist, depth_cap = state.depth_hist, state.depth_cap
        if adapt_depth and adapting:
            # histogram realized depths over the settled second half of
            # warmup; at its last draw set the budget from it
            if draw_ind >= n_adapt // 2:
                depth_hist = depth_hist.scatter_add(
                    1, torch.clamp_max(tree_depth, max_depth).long()[:, None],
                    torch.ones_like(depth_hist[:, :1]))
            if draw_ind == n_adapt - 1:
                depth_cap = depth_cap_rule(depth_hist, depth_quantile,
                                           max_depth, pooled_adaptation)

        new_state = NUTSState(
            position=draw,
            potential=U,
            step_size=step_size_out,
            epsilon_bar=ebar_out,
            h_val=h_out,
            mu_val=mu_out,
            draw_ind=draw_ind + 1,
            adapt_t0=t0_out,
            inv_mass=inv_mass_out,
            mass_chol=chol_out,
            w_count=wc,
            w_mean=wm,
            w_m2=wv,
            depth_hist=depth_hist,
            depth_cap=depth_cap,
        )
        info = {
            "accepted": good,
            "tree_depth": tree_depth,
            "diverged": div,
            "accept_stat": accept_stat,
            "step_size": eps,
        }
        return new_state, info

    step.counts = counts
    return init, step


def nuts(initial_vals, log_kernel, settings=None, *, n_chains=None, key=None,
         mesh=None, checkpoint_dir=None, checkpoint_every=500, dtype=None,
         bounded_grad="reference", pooled_adaptation=False,
         adapt_mass_matrix=False, adapt_depth=False, depth_quantile=0.98,
         static_sampling_depth=False, tree_variant="endpoint",
         sample_method="slice", thin=1, warmup_tree_depth=None,
         return_resume=False, device=None) -> SamplerResult:
    """Run NUTS (reference src/nuts.cpp entry points). The options are the
    JAX package's ``nuts`` (see its docstring): ``pooled_adaptation``,
    ``adapt_mass_matrix`` (``False``, ``True``/``"diag"``, ``"dense"``),
    ``adapt_depth`` with ``depth_quantile``, ``static_sampling_depth``
    (warmup, one host synchronisation, then a kernel rebuilt with the
    learned budget as its ``max_tree_depth``), ``tree_variant``,
    ``sample_method``, ``warmup_tree_depth``, ``thin`` and
    ``return_resume``.

    ``log_kernel`` is batched: ``(n_chains, n_vals) -> (n_chains,)``.
    ``key`` is a ``torch.Generator`` or an integer seed (``None``: the
    settings' ``rng_seed_value``); ``device`` defaults to that of
    ``initial_vals``, else the card. ``mesh`` shards the chains over its ranks
    (:mod:`mcmc_tpu_torch.parallel`);
    ``checkpoint_dir`` runs in restartable chunks
    (:mod:`mcmc_tpu_torch.checkpoint`)."""
    algo, s = resolve_settings(settings, "nuts_settings", NUTSSettings)
    if return_resume and checkpoint_dir is not None:
        raise ValueError("return_resume is incompatible with checkpoint_dir")

    prob = common.setup_problem(initial_vals, log_kernel, algo, n_chains,
                                dtype, device)
    gen = resolve_key(key, algo, prob.device)
    precond = common.make_spd(s.precond_mat, prob.n_vals, prob.dtype,
                              prob.device)
    grad_fn = integrators.make_kick_grad(prob, bounded_grad)

    n_total = s.n_burnin_draws + s.n_keep_draws
    n_adapt = min(s.n_adapt_draws, n_total)  # reference src/nuts.cpp:54

    if adapt_mass_matrix and s.precond_mat is not None:
        raise ValueError("adapt_mass_matrix is incompatible with a user "
                         "precond_mat — the mass matrix is learned")
    if static_sampling_depth:
        if not adapt_depth:
            raise ValueError("static_sampling_depth requires adapt_depth "
                             "(the static size is the learned budget)")
        if checkpoint_dir is not None:
            raise ValueError(
                "static_sampling_depth is incompatible with checkpoint_dir: "
                "the sampler-state template changes shape between warmup "
                "and sampling, which would invalidate the checkpoint")
        if n_adapt > s.n_burnin_draws:
            raise ValueError(
                f"static_sampling_depth requires n_adapt_draws "
                f"({n_adapt}) <= n_burnin_draws ({s.n_burnin_draws}): the "
                f"budget must be learned before the sampling kernel is "
                f"rebuilt")
    if warmup_tree_depth is not None and int(warmup_tree_depth) < 1:
        raise ValueError(f"warmup_tree_depth must be >= 1, got "
                         f"{warmup_tree_depth}")
    kernel_args = (prob.box_log_kernel, grad_fn, precond)
    init, step = build_nuts_kernel(*kernel_args, s, n_adapt,
                                   pooled_adaptation, adapt_mass_matrix,
                                   adapt_depth, depth_quantile, tree_variant,
                                   sample_method,
                                   warmup_tree_depth=warmup_tree_depth)
    state0 = init(gen, prob.first_draw)
    collect = lambda st: st.position

    n_burnin_run = s.n_burnin_draws
    if static_sampling_depth:
        # phase 1: warmup with the full-size tree, nothing collected
        state0, _, _ = common.run_sampler_loop(
            gen, state0, step, s.n_burnin_draws, 0, collect_fn=collect,
            mesh=mesh, thin=thin)
        # phase 2: rebuild with the learned budget as the tree size (max
        # over chains: lockstep pays the deepest chain anyway)
        cap = int(state0.depth_cap.max())
        _init2, step = build_nuts_kernel(
            *kernel_args, dataclasses.replace(s, max_tree_depth=cap),
            n_adapt, pooled_adaptation, adapt_mass_matrix, False,
            depth_quantile, tree_variant, sample_method)
        state0 = state0._replace(
            depth_hist=state0.depth_hist.new_zeros(
                state0.depth_hist.shape[:-1] + (cap + 1,)),
            depth_cap=torch.clamp_max(state0.depth_cap, cap))
        n_burnin_run = 0

    def assemble(key, state0, n_burnin, n_keep):
        final_state, draws, infos = common.run_sampler_loop(
            resolve_key(key, algo, prob.device), state0, step, n_burnin,
            n_keep, collect_fn=collect, mesh=mesh,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            thin=thin,
        )

        n_accept = common.tally_accepts(infos)
        draws = common.finalize_draws(draws, prob)
        if "accepted" in infos:
            diagnostics = {
                "tree_depth": infos["tree_depth"],
                "n_divergent": infos["diverged"].sum(dim=0),
                "accept_stat": infos["accept_stat"],
                "step_size": infos["step_size"],
            }
        else:
            # checkpointed run: the per-chain totals as counts and means
            totals = infos["totals"]
            diagnostics = {
                "n_divergent": torch.as_tensor(totals["diverged"]),
                "mean_tree_depth": torch.as_tensor(totals["tree_depth"])
                / n_keep,
                "mean_accept_stat": torch.as_tensor(totals["accept_stat"])
                / n_keep,
            }
        if adapt_mass_matrix:
            diagnostics["inv_mass_diag"] = final_state.inv_mass
        if adapt_depth:
            diagnostics["depth_cap"] = final_state.depth_cap
        if prob.squeeze:
            draws = draws[:, 0, :]
            n_accept = n_accept[0]
            # per-draw traces are (n_keep, n_chains); counts are (n_chains,);
            # inv_mass_diag is (n_chains, dim)
            def _squeeze(k, v):
                if k == "inv_mass_diag":
                    return v[0]
                return v[:, 0] if v.ndim == 2 else v[0]
            diagnostics = {k: _squeeze(k, v) for k, v in diagnostics.items()}
        if thin > 1:   # accept_rate divides by n_keep*thin
            diagnostics["thin"] = int(thin)
        return SamplerResult(draws=draws, n_accept_draws=n_accept,
                             diagnostics=diagnostics), final_state

    result, final_state = assemble(gen, state0, n_burnin_run, s.n_keep_draws)
    if return_resume:
        common.attach_resume(result, assemble, final_state)
    return result
