"""Adaptive equi-energy sampler over a temperature ladder (PyTorch port of
``mcmc_tpu.samplers.aees``).

Reference src/aees.cpp:30-305 + include/mcmc/aees.ipp:30-70. K =
``len(temper_vec) + 1`` chains run a descending temperature ladder with T = 1
appended; per draw the hottest chain takes a tempered RWMH step (proposal
scaled by ``sqrt(T)``, accept on ``min(0.01, delta/T)`` — aees.ipp:46-53),
and each colder chain — once its staggered activation point ``draw_ind > k *
(n_initial + n_burnin)`` passes (src/aees.cpp:176) — takes either a local
tempered step (prob ``1 - ee_prob_par``) or an **equi-energy jump**: the
next-hotter chain's kernel history is sorted into ``n_rings`` energy rings, a
stored state is drawn from the ring matching the chain's current energy, and
it is accepted by the two-temperature ratio (src/aees.cpp:187-240).

Design in PyTorch:
- ``n_runs`` independent ladders are one batch: every tensor carries the run
  axis first. The draw counter is the same for every run and is a host
  integer, so activation, the ring spacing and the reservoir's fill count
  are host values: an inactive rung is skipped, not computed and masked;
  only each run's choice between a local move and a jump, and the accept
  tests, are masks;
- the local tempered steps of every moving rung read only the previous
  draw's states, so they are one batch: one log-kernel call of shape
  ``(n_runs * K, d)`` a draw. A jump takes the ring's stored state with its
  stored kernel value (the reference and the JAX package evaluate that
  state again, src/aees.cpp:243: the same function of the same point);
- the ladder loop over the jumps stays sequential over K: rung k's jump
  reads rung k-1's history *including this draw's entry*, so the ring sorts
  cannot be batched across rungs;
- the donor's history window is a contiguous slice (the full history's
  ``[begin, draw_ind]``, the reservoir's filled prefix), sorted stably with
  ``torch.sort``; ring boundaries are strided slices of the sorted values
  and the ring walk (src/aees.cpp:208-218) a batched ``torch.searchsorted``;
- each chain's current kernel value is carried, saving the reference's
  re-evaluations (aees.ipp:48, src/aees.cpp:243);
- the history buffers of the state a transition is given are updated in
  place (the full history is ``n_total`` entries a rung); every other field
  is new.

**Bounded-memory mode** (``history_capacity=C``): the reference keeps every
draw of every chain resident — ``draw_storage(n_vals, K, n_total)`` grows
with the run length (src/aees.cpp:143-147, the memory-scaling pain point of
SURVEY.md §5). With a capacity, each chain instead maintains a fixed-size
**reservoir sample** of its history window (Vitter's algorithm R: the t-th
window entry replaces a uniformly random slot with probability C/t), so the
stored subset is uniform over the same window the reference sorts, ring
boundaries become quantile estimates of the same energy distribution, and
memory is O(C * K * d) independent of ``n_total``. Deviation (documented):
ring boundaries/jump candidates come from the uniform subsample rather than
the full window — statistically the same rings, not element-identical.

Deviations from the reference, all fixing uninitialized/undefined behavior
(observed at the cited lines, reproduced here with deterministic intended
semantics):
- src/aees.cpp:60-72 reads one element past ``temper_vec`` and sorts an
  uninitialized slot; here the ladder is exactly user temps + T = 1, sorted
  descending;
- src/aees.cpp:143 never writes row 0 (hottest chain) of ``kernel_vals`` yet
  sorts it for chain 1's rings; here it is written every draw;
- src/aees.cpp:222 uses a window-relative sort index as an absolute index
  into ``draw_storage``; here the jump state is the one actually selected by
  the ring (absolute indices fall out of the masked argsort);
- all chains start at the transformed initial value and history buffers are
  initialized with its kernel value instead of uninitialized memory;
- **Deviation** (NaN accept ratio in the EE jump): src/aees.cpp:238 tests
  ``z > exp(comp)`` — a NaN ``comp`` (kernel -inf at both temperatures)
  compares false and so silently ACCEPTS the jump; the local MH step
  (aees.ipp:57, ``z < exp``) rejects in the same situation. Here both moves
  use the accept-convention comparison (NaN rejects), i.e. the EE jump
  follows the reference's own local-move semantics rather than its
  inconsistent jump branch.

Beyond the JAX package: ``adapt_ladder=True`` validates that the hottest
temperature exceeds 1 (the JAX package builds a ladder from any maximum).

A transition is a draw of its random numbers from the run's one
``torch.Generator`` (``step.draw``: for every run and rung the move choice,
the walk's normals, the ring pick and the accept uniform, and in the capped
mode the reservoir's uniform and slot, whether or not the draw uses them)
followed by a function of those draws (``step.transition``).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import numpy as np
import torch

from mcmc_tpu_torch.results import SamplerResult
from mcmc_tpu_torch.settings import AEESSettings
from mcmc_tpu_torch.samplers import common
from mcmc_tpu_torch.samplers._resolve import resolve_settings, resolve_key

__all__ = ["aees", "AEESState", "build_aees_kernel", "build_ee_ladder",
           "make_temps", "make_ee_jump", "safe_initial_kv"]


class AEESState(NamedTuple):
    X: torch.Tensor           # (R, K, d) current states per ladder position
    cur_kv: torch.Tensor      # (R, K) current kernel values (temperature 1)
    kv2: torch.Tensor         # (R, 2, K) tempered pairs from the previous draw
    hist_kv: torch.Tensor     # (R, H, K) energy history/reservoir
    hist_draws: torch.Tensor  # (R, H, K, d) state history/reservoir
    draw_ind: int             # draw counter (activation + windows), host


def make_temps(s: AEESSettings, dtype=torch.float32):
    """Temperature ladder, on the CPU: user temps (validated all > 1) + T = 1
    appended, sorted descending — the intended semantics of
    src/aees.cpp:60-72."""
    user = torch.as_tensor(s.temper_vec, dtype=dtype).reshape(-1).cpu() \
        if s.temper_vec is not None else torch.zeros((0,), dtype=dtype)
    if user.numel() and not bool((user > 1.0).all()):
        raise ValueError(
            "temper_vec entries must all be > 1 (temperatures, not inverse "
            "temperatures); T=1 is appended automatically and the T=1 chain "
            "is the one whose draws are returned")
    return torch.sort(torch.cat([user, torch.ones(1, dtype=dtype)]),
                      descending=True).values


def safe_initial_kv(val):
    """A NaN initial kernel value would NaN every accept comparison and
    wedge the chain; force -inf so the first finite proposal accepts."""
    return torch.where(torch.isfinite(val), val, -torch.inf)


def _f32(x):
    """A number as the float32 value JAX computes with, as a Python float."""
    return float(np.float32(x))


def make_mh_step_scaled(box, s: AEESSettings, dim, dtype, device):
    """The tempered-MH core (reference aees.ipp:30-70), the one implementation
    behind the sampler's local steps and the ladder pilot, with the proposal
    scale and the temperature as arguments and the accept flag exposed:
    ``mh(x, val_prev, sqrt_temper, temper, scale, noise, u) -> (x, val,
    accepted)`` over states ``x`` ``(..., d)`` (one log-kernel call on all
    of them). ``sqrt_temper``, ``temper`` and ``scale`` are numbers or
    tensors that broadcast against ``x`` (``sqrt_temper``, ``scale``) and
    ``val_prev`` (``temper``). No finiteness guard, as in the reference —
    NaN ratios reject."""
    cov = common.make_spd(s.cov_mat, dim, dtype, device)

    def mh(x, val_prev, sqrt_temper, temper, scale, noise, u):
        prop = x + sqrt_temper * (scale * cov.sqrt_mv(noise))
        val_new = box(prop.reshape(-1, dim)).reshape(prop.shape[:-1])
        comp = torch.clamp_max((val_new - val_prev) / temper, 0.01)
        acc = u < torch.exp(comp)
        return (torch.where(acc[..., None], prop, x),
                torch.where(acc, val_new, val_prev), acc)

    return mh


def make_ee_jump(n_rings):
    """The ring pick of the equi-energy jump (reference src/aees.cpp:196-218),
    batched over runs: ``pick(window_kv, spacing, cur_kv, z) -> idx`` sorts
    each run's donor window ``(R, L)`` stably into ascending energy, takes
    the ring boundaries at midpoints every ``spacing`` entries, places the
    current energy ``cur_kv`` ``(R,)`` among them and returns the window
    position ``(R,)`` of entry ``spacing * ring + floor(z * spacing)`` in
    sorted order. ``spacing`` (> 0) is a host integer."""
    def pick(window_kv, spacing, cur_kv, z):
        sorted_vals, order = torch.sort(window_kv, dim=1, stable=True)
        end = spacing * n_rings
        ring_vals = 0.5 * (sorted_vals[:, spacing:end:spacing]
                           + sorted_vals[:, spacing - 1:end - 1:spacing])
        which = torch.searchsorted(ring_vals.contiguous(),
                                   cur_kv[:, None].contiguous())
        idx_rel = spacing * which + torch.floor(z * spacing).long()[:, None]
        return torch.gather(order, 1, idx_rel)[:, 0]

    return pick


def build_ee_ladder(gen, box, first, s: AEESSettings, dim, dtype, t_max, *,
                    spacing=3.0, max_rungs=16, n_grid=12, n_pilot_chains=8,
                    n_pilot_draws=400, min_rung_temp=1.4):
    """Ladder construction adapted to the EQUI-ENERGY functional (the JAX
    package's ``build_ee_ladder``; its docstring derives the rule).

    A short pilot measures ``sigma_val(beta)``, the standard deviation of
    the log-kernel, on a geometric grid of ``n_grid`` inverse temperatures
    from ``1/t_max`` to 1 (``n_pilot_chains`` independent tempered RWMH
    chains each, no EE moves; every proposal scale self-tunes toward 0.3
    acceptance over the first half, ``sigma_val`` is read over the second),
    then the ladder is walked down from ``beta = 1/t_max`` with
    ``dbeta = spacing / sigma_val(beta)`` until ``beta`` reaches
    ``1/min_rung_temp`` (capped at ``max_rungs``). The pilot runs the whole
    grid as one ``(n_grid * n_pilot_chains, d)`` batch, drawing from ``gen``.

    Limit, kept from the JAX package: every pilot chain starts at the one
    point ``first`` ``(d,)``; on a multimodal target the pilot measures the
    spread of the modes its chains reach from there within the pilot.

    Returns the user-temp vector (descending, T > 1 only, on the CPU; T = 1
    is appended by :func:`make_temps`)."""
    t_max = float(t_max)
    if not t_max > 1.0:
        raise ValueError(f"adapt_ladder needs a hottest temperature > 1 "
                         f"(max of temper_vec), got {t_max}")
    device = first.device
    G, C = int(n_grid), int(n_pilot_chains)
    beta_grid = torch.as_tensor(np.geomspace(1.0 / t_max, 1.0, G),
                                dtype=dtype)
    grid_temps = (1.0 / beta_grid).to(device)                  # (G,)
    n_half = int(n_pilot_draws) // 2
    mh = make_mh_step_scaled(box, s, dim, dtype, device)

    temper = grid_temps.repeat_interleave(C)                   # (G*C,)
    sqrt_t = torch.sqrt(temper)[:, None]
    with torch.no_grad():
        val0 = safe_initial_kv(box(first[None, :]))[0]
        x = first[None, :].expand(G * C, dim).clone()
        v = val0.expand(G * C).clone()
        scale = torch.full((G,), float(s.par_scale), dtype=dtype,
                           device=device)
        kept = []
        for t in range(int(n_pilot_draws)):
            noise = torch.randn((G * C, dim), generator=gen, dtype=dtype,
                                device=device)
            u = torch.rand((G * C,), generator=gen, dtype=dtype,
                           device=device)
            x, v, acc = mh(x, v, sqrt_t,
                           temper, scale.repeat_interleave(C)[:, None],
                           noise, u)
            if t < n_half:   # burn half: multiplicative scale adaptation
                scale = scale * torch.exp(
                    0.25 * (acc.reshape(G, C).to(dtype).mean(dim=1) - 0.3))
            else:
                kept.append(v.reshape(G, C))
        kept = torch.stack(kept)                               # (n, G, C)
        moved = (kept[1:] != kept[:-1]).to(dtype).mean(dim=(0, 2))
        sig = kept.std(dim=(0, 2), correction=0)
    sig = sig.double().cpu().numpy()
    moved = moved.double().cpu().numpy()
    if moved.min() < 0.02:
        bad = float(grid_temps[int(np.argmin(moved))])
        warnings.warn(
            f"build_ee_ladder pilot chains barely move at T={bad:.3g} "
            f"(acceptance ~{moved.min():.1%}) even after proposal-scale "
            f"self-tuning: sigma_val is underestimated there and the "
            f"constructed ladder may be too sparse. The target may be "
            f"discontinuous/degenerate at that temperature, or cov_mat badly "
            f"mis-shaped for it.", stacklevel=3)
    # degenerate pilots (all-rejecting targets leave vals at -inf, whose
    # std is nan) must not poison the walk with nan betas
    sig = np.where(np.isfinite(sig), sig, 0.0)
    sig = np.maximum(sig, 1e-12)
    log_bg = np.log(beta_grid.double().numpy())
    log_sig = np.log(sig)

    betas = [1.0 / t_max]
    reached = False
    while len(betas) < int(max_rungs):
        b = betas[-1]
        sig_b = float(np.exp(np.interp(np.log(b), log_bg, log_sig)))
        b_next = b + float(spacing) / sig_b
        if b_next >= 1.0 / float(min_rung_temp):
            reached = True
            break
        betas.append(b_next)
    if not reached:
        warnings.warn(
            f"build_ee_ladder hit max_rungs={max_rungs} at T="
            f"{1.0 / betas[-1]:.3g} before bridging to the T=1 target: "
            f"the coldest constructed rung and the appended T=1 chain "
            f"have an energy-histogram gap wider than `spacing` sigmas, "
            f"so EE jumps into the returned chain will rarely accept. "
            f"Raise max_rungs, raise spacing, or lower the hottest "
            f"temperature.", stacklevel=3)
    return torch.as_tensor(1.0 / np.asarray(betas), dtype=dtype)


def build_aees_kernel(box, temps, s: AEESSettings, dim, dtype, device,
                      history_capacity=None):
    """Returns ``(make_state0, step)`` for the AEES transition over a batch
    of runs.

    ``temps`` is the descending ladder (T = 1 last). ``history_capacity=None``
    keeps the reference's full ``(n_total, K)`` history; an int C keeps a
    per-chain reservoir of C entries instead (module docstring).
    ``step.draw(gen, state) -> (sel, noise, pick, u, res_u, res_slot)``
    (each ``(R, K)``, ``noise`` ``(R, K, d)``; the last two ``None``
    without a capacity) and ``step.transition(state, *draws)`` are its two
    halves; ``step.counts`` tallies draws, log-kernel calls, ring sorts and
    host synchronisations (none)."""
    temps_f = [_f32(t) for t in torch.as_tensor(temps).tolist()]
    sqrt_f = [_f32(np.sqrt(np.float32(t))) for t in temps_f]
    K = len(temps_f)
    block = int(s.n_initial_draws) + int(s.n_burnin_draws)
    n_total = int(s.n_keep_draws) + K * block
    n_rings = int(s.n_rings)
    capped = history_capacity is not None
    H = int(history_capacity) if capped else n_total
    scale = _f32(s.par_scale)
    ee_prob = float(s.ee_prob_par)

    mh = make_mh_step_scaled(box, s, dim, dtype, device)
    pick_of = make_ee_jump(n_rings)
    # per-rung sqrt(T) (a column over the state), T, and the next-hotter
    # rung's T (the hottest rung's is the coldest's, as JAX rolls it)
    sqrt_col = torch.tensor(sqrt_f, dtype=dtype, device=device)[:, None]
    temps_t = torch.tensor(temps_f, dtype=dtype, device=device)
    temps_prev = torch.roll(temps_t, 1)
    # rung j's window starts j * block draws in
    rung_offsets = torch.arange(K, dtype=dtype, device=device) * float(block)
    counts = {"draws": 0, "evaluations": 0, "sorts": 0, "syncs": 0}

    def store(hist_kv, hist_draws, j, kv, x, draw_ind, repl, slot, rows):
        """Record chain j's draw into its history slot (full mode) or
        reservoir (capped mode), in place: ``repl`` ``(R,)`` says which runs
        replace their entry ``slot`` once the window has outgrown the
        reservoir. The donor window for reader j+1 starts at j*block
        (reference begin = (k-1)*block, src/aees.cpp:196)."""
        if not capped:
            hist_kv[:, draw_ind, j] = kv
            hist_draws[:, draw_ind, j] = x
            return
        t = draw_ind - j * block + 1          # window entries seen so far
        if t < 1:
            return
        if t <= H:
            hist_kv[:, t - 1, j] = kv
            hist_draws[:, t - 1, j] = x
            return
        hist_kv[rows, slot, j] = torch.where(repl, kv, hist_kv[rows, slot, j])
        hist_draws[rows, slot, j] = torch.where(
            repl[:, None], x, hist_draws[rows, slot, j])

    def draw(gen, state: AEESState):
        R = state.X.shape[0]
        kw = {"generator": gen, "dtype": state.X.dtype,
              "device": state.X.device}
        sel = torch.rand((R, K), **kw)
        noise = torch.randn((R, K, dim), **kw)
        pick = torch.rand((R, K), **kw)
        u = torch.rand((R, K), **kw)
        if not capped:
            return sel, noise, pick, u, None, None
        res_u = torch.rand((R, K), **kw)
        res_slot = torch.randint(0, H, (R, K), generator=gen,
                                 device=state.X.device)
        return sel, noise, pick, u, res_u, res_slot

    cache = {}

    def run_consts(R, device):
        """The run indices and an all-false mask of a batch of ``R`` runs."""
        if (R, device) not in cache:
            cache[(R, device)] = (
                torch.arange(R, device=device),
                torch.zeros((R,), dtype=torch.bool, device=device))
        return cache[(R, device)]

    def transition(state: AEESState, sel, noise, pick, u, res_u=None,
                   res_slot=None):
        draw_ind = int(state.draw_ind)
        X_prev, kv_prev, kv2_prev = state.X, state.cur_kv, state.kv2
        hist_kv, hist_draws = state.hist_kv, state.hist_draws
        R = X_prev.shape[0]
        rows, no = run_consts(R, X_prev.device)
        # the rungs that move this draw: the hottest, and rung k once
        # draw_ind > k * block (src/aees.cpp:176) — a prefix of the ladder
        n = 1 + sum(draw_ind > k * block for k in range(1, K))

        # every moving rung's local tempered step (aees.ipp:46-57) in one
        # batch, from the previous draw's states (reference copies
        # X_prev/kernel_vals_prev before the ladder loop,
        # src/aees.cpp:153-154); the hottest rung's is its move
        x_l, v_l, _ = mh(X_prev[:, :n], kv_prev[:, :n], sqrt_col[:n],
                         temps_t[:n], scale, noise[:, :n], u[:, :n])
        counts["evaluations"] += 1
        x_l = x_l.unbind(1)
        pair_l = torch.stack([v_l / temps_prev[:n], v_l / temps_t[:n]],
                             1).unbind(2)
        v_l = v_l.unbind(1)
        local_c, u_c = (sel > ee_prob).unbind(1), u.unbind(1)
        Xp, kvp, k2p = X_prev.unbind(1), kv_prev.unbind(1), kv2_prev.unbind(2)
        if capped:
            # the reservoir's replacement test u t < C (prob C/t) of every
            # rung, t the rung's window entries in float32 (exact integers)
            repl = (res_u * (float(draw_ind + 1) - rung_offsets)
                    < float(H)).unbind(1)
            slots = res_slot.unbind(1)
        else:
            repl = slots = (None,) * K

        # hottest chain (src/aees.cpp:160-164)
        x0, v0 = x_l[0], v_l[0]
        store(hist_kv, hist_draws, 0, v0, x0, draw_ind, repl[0], slots[0],
              rows)
        xs, vs, pairs = [x0], [v0], [torch.stack([v0, v0], dim=1)]
        att, eacc = [no], [no]

        # ladder loop; each chain's history entry is written before the next
        # (colder) chain reads the ring window
        for k in range(1, n):
            xk, vk, pk, local = Xp[k], kvp[k], k2p[k], local_c[k]
            begin = (k - 1) * block
            length = draw_ind - begin + 1
            avail = min(length, H) if capped else length
            spacing = avail // n_rings
            lo = 0 if capped else begin
            if spacing > 0:
                # equi-energy jump (src/aees.cpp:187-240): the ring's stored
                # state, with its stored kernel value (the reference
                # evaluates it again, src/aees.cpp:243)
                counts["sorts"] += 1
                idx = pick_of(hist_kv[:, lo:lo + avail, k - 1], spacing, vk,
                              pick[:, k]) + lo
                x_ee = hist_draws[rows, idx, k - 1]
                v_ee = hist_kv[rows, idx, k - 1]
                new_pair = torch.stack([v_ee / temps_f[k - 1],
                                        v_ee / temps_f[k]], dim=1)
                comp = torch.clamp_max((new_pair[:, 1] - pk[:, 1])
                                       + (pk[:, 0] - new_pair[:, 0]), 0.01)
                acc_e = u_c[k] < torch.exp(comp)
                jump = ~local
                took = jump & acc_e
                xk = torch.where(took[:, None], x_ee, torch.where(
                    local[:, None], x_l[k], xk))
                vk = torch.where(took, v_ee, torch.where(local, v_l[k], vk))
                pk = torch.where(local[:, None], pair_l[k], torch.where(
                    acc_e[:, None], new_pair, pk))
            else:
                # no ring yet: a jump draw stays
                jump = took = no
                xk = torch.where(local[:, None], x_l[k], xk)
                vk = torch.where(local, v_l[k], vk)
                pk = torch.where(local[:, None], pair_l[k], pk)
            store(hist_kv, hist_draws, k, vk, xk, draw_ind, repl[k], slots[k],
                  rows)
            xs.append(xk)
            vs.append(vk)
            pairs.append(pk)
            att.append(jump)
            eacc.append(took)
        for k in range(n, K):       # inactive rungs stay
            store(hist_kv, hist_draws, k, kvp[k], Xp[k], draw_ind, repl[k],
                  slots[k], rows)
            xs.append(Xp[k])
            vs.append(kvp[k])
            pairs.append(k2p[k])
            att.append(no)
            eacc.append(no)

        counts["draws"] += 1
        new_state = AEESState(
            X=torch.stack(xs, dim=1), cur_kv=torch.stack(vs, dim=1),
            kv2=torch.stack(pairs, dim=2), hist_kv=hist_kv,
            hist_draws=hist_draws, draw_ind=draw_ind + 1)
        # per-rung EE-jump attempt/accept flags (rung 0 never jumps)
        return new_state, {"ee_attempt": torch.stack(att, dim=1),
                           "ee_accept": torch.stack(eacc, dim=1)}

    def step(gen, state: AEESState):
        return transition(state, *draw(gen, state))

    def make_state0(first, val_init, n_runs):
        """``n_runs`` ladders, every chain at ``first`` ``(d,)`` with kernel
        value ``val_init`` (0-d), history filled with them."""
        R = int(n_runs)
        X = first.expand(R, K, dim).clone()
        kv = val_init.expand(R, K).clone()
        kv2 = torch.stack([val_init / temps_prev, val_init / temps_t])
        return AEESState(
            X=X, cur_kv=kv, kv2=kv2.expand(R, 2, K).clone(),
            hist_kv=val_init.expand(R, H, K).clone(),
            hist_draws=first.expand(R, H, K, dim).clone(),
            draw_ind=0)

    step.draw, step.transition, step.counts = draw, transition, counts
    step.K, step.H = K, H
    return make_state0, step


def aees(initial_vals, log_kernel, settings=None, *, key=None, n_runs=None,
         mesh=None, checkpoint_dir=None, checkpoint_every=500,
         history_capacity=None, adapt_ladder=False, n_ladder_adapt=None,
         ladder_spacing=3.0, max_rungs=16, dtype=None,
         device=None) -> SamplerResult:
    """Run AEES. Returns the final ``n_keep_draws`` draws of the T = 1 chain
    (reference src/aees.cpp:255-270): ``(n_keep, n_vals)``, or ``(n_keep,
    n_runs, n_vals)`` with ``n_runs`` independent ladder replicas, which run
    as one batch. ``log_kernel`` is batched: ``(n_runs, n_vals) ->
    (n_runs,)``. ``history_capacity`` bounds each rung's history to a
    reservoir of that many entries (module docstring).

    ``adapt_ladder=True`` (or ``"ee"``) tunes the temperature ladder to the
    equi-energy functional before sampling (:func:`build_ee_ladder`, with
    ``ladder_spacing`` and ``max_rungs``): only ``max(temper_vec)``, which
    must exceed 1, is used; the rung count emerges from the walk.
    ``adapt_ladder="pt"`` keeps the Robbins-Monro PT pre-run toward the
    0.234 swap target (the ported :func:`~mcmc_tpu_torch.samplers.pt.pt`,
    32 ladders of RWMH inner moves for ``n_ladder_adapt`` draws). The ladder
    is reported in ``diagnostics["temperatures"]``; per-rung EE-jump
    attempts and acceptance over kept draws in ``ee_attempts`` and
    ``ee_accept_rate``. ``n_accept_draws`` counts the kept draws at which
    the cold chain moved (the reference's AEES tracks no acceptance).

    ``key`` is a ``torch.Generator`` or an integer seed; ``device`` defaults
    to that of ``initial_vals``, else the card. ``mesh`` is not ported yet and
    raises; ``checkpoint_dir`` runs in restartable chunks
    (:mod:`mcmc_tpu_torch.checkpoint`)."""
    algo, s = resolve_settings(settings, "aees_settings", AEESSettings)
    common._no_mesh(mesh)

    prob = common.setup_problem(initial_vals, log_kernel, algo, None, dtype,
                                device)
    dim, dt, box = prob.n_vals, prob.dtype, prob.box_log_kernel
    gen = resolve_key(key, algo, prob.device)

    if adapt_ladder:
        if s.temper_vec is None:
            raise ValueError("adapt_ladder requires an initial temper_vec "
                             "(its max sets the hottest rung)")
        mode = "ee" if adapt_ladder is True else adapt_ladder
        if mode == "ee":
            t_max = float(torch.as_tensor(s.temper_vec).max())
            adapted = build_ee_ladder(
                gen, box, prob.first_draw[0], s, dim, dt, t_max,
                spacing=ladder_spacing, max_rungs=max_rungs)
            s = dataclasses.replace(s, temper_vec=adapted.numpy())
        elif mode == "pt":
            from mcmc_tpu_torch.samplers.pt import pt as _pt
            from mcmc_tpu_torch.settings import AlgoSettings, PTSettings
            n_pre = int(n_ladder_adapt) if n_ladder_adapt is not None \
                else int(s.n_initial_draws) + int(s.n_burnin_draws)
            pt_algo = AlgoSettings(
                vals_bound=algo.vals_bound, lower_bounds=algo.lower_bounds,
                upper_bounds=algo.upper_bounds,
                pt_settings=PTSettings(
                    n_burnin_draws=n_pre, n_keep_draws=1,
                    temper_vec=s.temper_vec, inner="rwmh",
                    par_scale=s.par_scale, cov_mat=s.cov_mat,
                    adapt_temps=True))
            pre = _pt(initial_vals, log_kernel, pt_algo, n_chains=32,
                      key=gen, dtype=dt, device=prob.device)
            adapted = pre.diagnostics["temperatures"].cpu()  # T=1 last
            s = dataclasses.replace(s, temper_vec=adapted[:-1].numpy())
        else:
            raise ValueError(
                f"adapt_ladder must be False, True, 'ee', or 'pt', got "
                f"{adapt_ladder!r}")

    temps = make_temps(s, dt)
    make_state0, step = build_aees_kernel(box, temps, s, dim, dt,
                                          prob.device, history_capacity)
    K = step.K
    block = int(s.n_initial_draws) + int(s.n_burnin_draws)

    first = prob.first_draw[0]
    with torch.no_grad():
        val_init = safe_initial_kv(box(first[None, :]))[0]
    R = 1 if n_runs is None else int(n_runs)
    state0 = make_state0(first, val_init, R)

    _, draws, infos = common.run_sampler_loop(
        gen, state0, step, K * block, s.n_keep_draws,
        collect_fn=lambda st: st.X[:, K - 1], checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every)
    draws = common.finalize_draws(draws, prob)            # (n_keep, R, d)
    if "totals" in infos:     # checkpointed run: per-run totals (R, K)
        att = torch.as_tensor(infos["totals"]["ee_attempt"]).sum(dim=0)
        acc = torch.as_tensor(infos["totals"]["ee_accept"]).sum(dim=0)
    else:
        att = infos["ee_attempt"].sum(dim=(0, 1))         # (K,)
        acc = infos["ee_accept"].sum(dim=(0, 1))
    # rung 0 never jumps; rate over KEPT draws (reference counting
    # convention, src/rwmh.cpp:140-142). The reference's AEES tracks no
    # acceptance; report the cold chain's kept-draw move count
    moved = (draws[1:] != draws[:-1]).any(dim=-1).sum(dim=0)
    if n_runs is None:
        draws, moved = draws[:, 0], moved[0]
    return SamplerResult(
        draws=draws, n_accept_draws=moved,
        diagnostics={"temperatures": temps.to(prob.device),
                     "ee_attempts": att,
                     "ee_accept_rate": acc / torch.clamp_min(att, 1)})
