"""The PyTorch port's adaptive equi-energy sampler against the JAX
package's, on the CPU.

A draw is held exactly: JAX's step under ``jax.vmap`` over six runs, and
the port's transition fed the move choices, walk normals, ring picks,
accept uniforms and reservoir draws JAX's step takes from its keys, with
the full history and with a capped one (a reservoir of 10 entries), over
the first 30 draws of a 3-rung ladder whose rungs activate at draws 5 and
9: inactive rungs, the first active draws with too short a window for a
ring (a jump draw stays), local moves, equi-energy jumps accepted and
rejected, and the reservoir's fill, replace and skip. Every state field at
rtol 1e-5, the jump attempts and accepts exactly, one draw at a time and
over the port's own run. The rest is distributional, on the AEES cases of
``tests/test_rmhmc_de_aees.py`` and ``tests/test_bounded_samplers.py`` at
smaller sizes.
"""

import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmc_tpu
import mcmc_tpu_torch
from mcmc_tpu import models as jmodels
from mcmc_tpu_torch import convert
from mcmc_tpu_torch import models as tmodels
from test_torch_chees import as_tensors
from test_torch_pt import assert_state


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for every test here: the tests run in several
    worker processes at once, and torch's default of a thread per core
    oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


jaees = importlib.import_module("mcmc_tpu.samplers.aees")
taees = importlib.import_module("mcmc_tpu_torch.samplers.aees")

R, D, N_TRANS, CAP = 6, 2, 30, 10
_MU = np.array([[-2.0, -2.0], [2.0, 2.0]], np.float32)
_HALF = np.array([0.5, 0.5], np.float32)
SETTINGS = dict(n_initial_draws=2, n_burnin_draws=2, n_keep_draws=20,
                n_rings=7, ee_prob_par=0.5, temper_vec=np.array([20.0, 4.0]),
                par_scale=0.8, cov_mat=np.array([[0.5, 0.1], [0.1, 0.3]]))
CASES = {"full": None, "capped": CAP}
_RUNS = {}


def _jax_draws(key, K, H):
    """The random numbers JAX's AEES step takes from ``key``, in the port's
    layout: each rung's move choice, walk normals, ring pick and accept
    uniform (the hottest rung's choice and pick unused, zero), and each
    rung's reservoir uniform and slot."""
    keys = jax.random.split(key, 2 * K)
    k_n, k_u = jax.random.split(keys[0])
    sel, noise = [jnp.zeros(())], [jax.random.normal(k_n, (D,))]
    pick, u = [jnp.zeros(())], [jax.random.uniform(k_u)]
    for k in range(1, K):
        k_sel, k_move = jax.random.split(keys[k])
        a, b = jax.random.split(k_move)
        sel.append(jax.random.uniform(k_sel))
        noise.append(jax.random.normal(a, (D,)))
        pick.append(jax.random.uniform(a))
        u.append(jax.random.uniform(b))
    res_u, res_slot = [], []
    for j in range(K):
        k_ru, k_slot = jax.random.split(keys[K + j])
        res_u.append(jax.random.uniform(k_ru))
        res_slot.append(jax.random.randint(k_slot, (), 0, H))
    return tuple(jnp.stack(v) for v in (sel, noise, pick, u, res_u,
                                        res_slot))


def _aees_case(name):
    """JAX's ``N_TRANS`` draws of the case over ``R`` runs (cached) with the
    draws they take, and the port's kernel, on the two-mode mixture."""
    cap = CASES[name]
    jlk = jmodels.gaussian_mixture_model(_MU, _HALF, _HALF)
    tlk = tmodels.gaussian_mixture_model(_MU, _HALF, _HALF, device="cpu")
    ts = mcmc_tpu_torch.AEESSettings(**SETTINGS)
    temps = taees.make_temps(ts)
    _, tstep = taees.build_aees_kernel(tlk, temps, ts, D, torch.float32,
                                       "cpu", cap)
    if name not in _RUNS:
        js = mcmc_tpu.AEESSettings(**SETTINGS)
        jtemps = jaees.make_temps(js, jnp.float32)
        jmake, jstep = jaees.build_aees_kernel(jlk, jtemps, js, D,
                                               jnp.float32, cap)
        first = jnp.asarray(_MU[0])
        st = jmake(first, jlk(first))
        st = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (R,) + x.shape), st)
        K, H = int(st.X.shape[1]), int(st.hist_kv.shape[1])
        step = jax.jit(jax.vmap(jstep))
        draws_of = jax.jit(jax.vmap(lambda k: _jax_draws(k, K, H)))
        as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
        states, infos, draws = [as_np(st)], [], []
        for k in jax.random.split(jax.random.PRNGKey(31), N_TRANS):
            keys = jax.random.split(k, R)
            draws.append(as_np(draws_of(keys)))
            st, info = step(keys, st)
            states.append(as_np(st))
            infos.append(as_np(info))
        _RUNS[name] = (states, infos, draws)
    return tstep, _RUNS[name]


def _fed(draws, capped):
    sel, noise, pick, u, res_u, res_slot = as_tensors(draws)
    if not capped:
        return sel, noise, pick, u, None, None
    return sel, noise, pick, u, res_u, res_slot.long()


@pytest.mark.parametrize("name", list(CASES))
def test_aees_draw_matches_jax(name):
    """Each of JAX's draws from JAX's state before it, fed its random
    numbers: every field (histories included) at rtol 1e-5, the draw
    counter equal, each run's jump attempts and accepts exactly. The cases
    reach what they are meant to: inactive rungs, a jump draw with no ring
    yet, local and jump moves, accepted and rejected jumps, and (capped)
    reservoir entries replaced and skipped."""
    tstep, (states, infos, draws) = _aees_case(name)
    capped = CASES[name] is not None
    with torch.no_grad():
        for t, d in enumerate(draws):
            new, info = tstep.transition(convert.aees_state(states[t], "cpu"),
                                         *_fed(d, capped))
            assert_state(new, states[t + 1], what=f"state after {t}")
            for k in ("ee_attempt", "ee_accept"):
                np.testing.assert_array_equal(info[k].numpy(), infos[t][k],
                                              err_msg=f"{k} of {t}")
    att = np.stack([i["ee_attempt"] for i in infos])      # (t, R, K)
    acc = np.stack([i["ee_accept"] for i in infos])
    sel = np.stack([d[0] for d in draws])
    block = SETTINGS["n_initial_draws"] + SETTINGS["n_burnin_draws"]
    assert not att[:2 * block + 1, :, 2].any()            # rung 2 inactive
    jump_draw = sel[:, :, 1] <= SETTINGS["ee_prob_par"]
    # draw 5: rung 1 active, window of 6 < 7 rings: a jump draw stays
    assert jump_draw[block + 1].any() and not att[block + 1, :, 1].any()
    assert att[:, :, 1:].sum() > 40 and (~jump_draw[block + 2:]).any()
    assert acc.sum() > 10 and (att & ~acc).sum() > 3
    if capped:
        # rung 0's reservoir past its 10 entries: replaced (u t < C) and
        # skipped (u t >= C)
        ru = np.stack([d[4][:, 0] for d in draws[CAP:]])
        t_win = np.arange(CAP, N_TRANS)[:, None] + 1
        replace = ru * t_win < CAP
        assert replace.any() and (~replace).any()


# Nothing adapts: over the 30 draws the port's own run keeps every field
# within 3.4e-7 of its scale (measured) and makes JAX's decisions; held at
# 1e-5.
RUN_RTOL = 1e-5


@pytest.mark.parametrize("name", list(CASES))
def test_aees_run_fed_jax_draws(name):
    """The port's own run of the case from JAX's first state, fed JAX's
    draws: the same jump decisions at every draw, the final state (the
    histories included) within ``RUN_RTOL``; one log-kernel call a draw (the
    local steps of every moving rung in one batch), no host
    synchronisation."""
    cap = CASES[name]
    tstep, (states, infos, draws) = _aees_case(name)
    before = dict(tstep.counts)
    st = convert.aees_state(states[0], "cpu")
    with torch.no_grad():
        for t, d in enumerate(draws):
            st, info = tstep.transition(st, *_fed(d, cap is not None))
            for k in ("ee_attempt", "ee_accept"):
                np.testing.assert_array_equal(
                    info[k].numpy(), infos[t][k],
                    err_msg=f"{name}: {k} of {t}")
    assert_state(st, states[-1], RUN_RTOL, what=f"{name} final state")
    evals = tstep.counts["evaluations"] - before["evaluations"]
    assert evals == N_TRANS and tstep.counts["syncs"] == 0


@pytest.mark.parametrize("name", list(CASES))
def test_convert_round_trip_and_state0(name):
    """``convert.aees_state`` of the case's initial state from JAX (batched
    over runs, and of one ladder, which gains the run axis) equals the port's
    ``make_state0``: every chain and history entry at the start, the
    tempered pairs from the ladder."""
    tlk = tmodels.gaussian_mixture_model(_MU, _HALF, _HALF, device="cpu")
    ts = mcmc_tpu_torch.AEESSettings(**SETTINGS)
    first = torch.tensor(_MU[0])
    cap = CASES[name]
    _, (states, _, _) = _aees_case(name)
    make0, step = taees.build_aees_kernel(
        tlk, taees.make_temps(ts), ts, D, torch.float32, "cpu", cap)
    want = make0(first, tlk(first[None])[0], R)
    got = convert.aees_state(states[0], "cpu")
    one = convert.aees_state(jax.tree_util.tree_map(lambda a: a[0],
                                                    states[0]), "cpu")
    assert got.draw_ind == one.draw_ind == 0
    assert got.hist_kv.shape == (R, step.H, 3)
    for f in ("X", "cur_kv", "kv2", "hist_kv", "hist_draws"):
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   msg=f"{name} {f}")
        torch.testing.assert_close(getattr(one, f),
                                   getattr(want, f)[:1])


def test_ring_pick_matches_jax_on_ties_and_windows():
    """The ring pick against JAX's ``make_ee_jump`` sort and ring walk on
    windows with ties, at every ring spacing a window of 23 allows: the
    picked slot is the one JAX picks (JAX sorts the masked full buffer,
    the port the window's slice)."""
    rng = np.random.default_rng(2)
    H, lo = 40, 9
    hist = np.round(rng.standard_normal(H), 1).astype(np.float32)
    for n_rings in (2, 3, 5, 11):
        pick = taees.make_ee_jump(n_rings)
        for L in (n_rings, 12, 23):
            mask = (np.arange(H) >= lo) & (np.arange(H) < lo + L)
            spacing = L // n_rings
            masked = np.where(mask, hist, np.inf)
            order = np.argsort(masked, kind="stable")
            sv = masked[order]
            pos = np.arange(1, n_rings) * spacing
            ring = 0.5 * (sv[pos] + sv[pos - 1])
            cur = rng.standard_normal(8).astype(np.float32)
            z = rng.uniform(size=8).astype(np.float32)
            which = np.searchsorted(ring, cur, side="left")
            want = order[spacing * which
                         + np.floor(z * np.float32(spacing)).astype(int)]
            got = pick(torch.tensor(hist[lo:lo + L]).expand(8, L), spacing,
                       torch.tensor(cur), torch.tensor(z)) + lo
            np.testing.assert_array_equal(got.numpy(), want)


def _hard_mixture(sig=0.1):
    return tmodels.gaussian_mixture_model(_MU, np.array([sig, sig]),
                                          np.array([0.5, 0.5]), device="cpu")


def _bimodal_checks(d, n_min):
    pos, neg = d[d[:, 0] > 0.1], d[d[:, 0] < -0.1]
    assert len(pos) > n_min and len(neg) > n_min, (len(pos), len(neg))
    np.testing.assert_allclose(pos.mean(axis=0), [2.0, 2.0], atol=0.25)
    np.testing.assert_allclose(neg.mean(axis=0), [-2.0, -2.0], atol=0.25)


@pytest.mark.parametrize("capacity", [None, 128])
def test_aees_bimodal_mixture(capacity):
    """tests/test_rmhmc_de_aees.py's ``test_aees_bimodal_mixture`` and
    ``test_aees_capped_history_bimodal`` at 8 runs of 100 + 100 draws a rung
    and 1,000 kept (the reference example's ladder 60, 9, 1, 11 rings, jump
    probability 0.05, proposal 0.35 I): both modes visited by the pooled
    cold chains, each mode's mean within 0.25 of +-2; the ladder reported;
    capped, the reservoir is capacity-sized."""
    s = mcmc_tpu_torch.AEESSettings(
        n_initial_draws=100, n_burnin_draws=100, n_keep_draws=1000,
        n_rings=11, ee_prob_par=0.05, temper_vec=np.array([60.0, 9.0]),
        cov_mat=0.35 * np.eye(2))
    out = mcmc_tpu_torch.aees(_MU[0], _hard_mixture(), s, key=2, n_runs=8,
                              history_capacity=capacity, device="cpu")
    d = out.draws.numpy()
    assert d.shape == (1000, 8, 2)
    _bimodal_checks(d.reshape(-1, 2), 1000)
    np.testing.assert_array_equal(out.diagnostics["temperatures"].numpy(),
                                  [60.0, 9.0, 1.0])
    att = out.diagnostics["ee_attempts"].numpy()
    assert att[0] == 0 and (att[1:] > 0).all()
    assert (out.diagnostics["ee_accept_rate"][1:] > 0.3).all()


def test_aees_single_ladder_and_replicas():
    """``test_aees_multi_run_vmapped`` (0.5-variance modes, ladder 20, 4,
    1): four replicas differ and their pooled draws hold both modes; with
    no ``n_runs`` one ladder's draws come back ``(n_keep, d)``, with its
    move count (200 kept draws after 50 + 50 a rung); one seed repeats bit
    for bit."""
    s = mcmc_tpu_torch.AEESSettings(
        n_initial_draws=100, n_burnin_draws=100, n_keep_draws=600,
        n_rings=5, ee_prob_par=0.1, temper_vec=np.array([20.0, 4.0]),
        cov_mat=0.5 * np.eye(2))
    lk = _hard_mixture(0.5)
    out = mcmc_tpu_torch.aees(_MU[0], lk, s, key=0, n_runs=4, device="cpu")
    d = out.draws.numpy()
    assert d.shape == (600, 4, 2)
    assert np.abs(d[:, 0] - d[:, 1]).max() > 0
    pooled = d.reshape(-1, 2)
    assert (pooled[:, 0] > 0.1).mean() > 0.1
    assert (pooled[:, 0] < -0.1).mean() > 0.1
    s = mcmc_tpu_torch.AEESSettings(
        n_initial_draws=50, n_burnin_draws=50, n_keep_draws=200, n_rings=5,
        temper_vec=np.array([20.0, 4.0]), cov_mat=0.5 * np.eye(2))
    one = mcmc_tpu_torch.aees(_MU[0], lk, s, key=5, device="cpu")
    again = mcmc_tpu_torch.aees(_MU[0], lk, s, key=5, device="cpu")
    assert one.draws.shape == (200, 2)
    assert torch.equal(one.draws, again.draws)
    moved = int((one.draws[1:] != one.draws[:-1]).any(-1).sum())
    assert int(one.n_accept_draws) == moved > 40


def test_aees_adapt_ladder_ee():
    """``test_aees_adapt_ladder_ee`` at 4 runs, a 128-entry reservoir and
    100 + 100 + 1,000 draws: the constructed ladder starts at 60, descends
    strictly to 1 with no rung below 1.4 and 3-8 rungs; every rung but the
    hottest attempts and accepts jumps (rate > 0.3); both modes visited.
    Refusals: no ``temper_vec``, an unknown mode, and (beyond the JAX
    package) a hottest temperature that is not above 1."""
    s = mcmc_tpu_torch.AEESSettings(
        n_initial_draws=100, n_burnin_draws=100, n_keep_draws=1000,
        n_rings=11, ee_prob_par=0.05, temper_vec=np.array([60.0]),
        cov_mat=0.35 * np.eye(2))
    out = mcmc_tpu_torch.aees(_MU[0], _hard_mixture(), s, key=3, n_runs=4,
                              history_capacity=128, adapt_ladder=True,
                              device="cpu")
    temps = out.diagnostics["temperatures"].numpy()
    K = temps.shape[0]
    assert 3 <= K <= 8, temps
    assert temps[0] == pytest.approx(60.0) and temps[-1] == 1.0
    assert np.all(np.diff(temps) < 0) and np.all(temps[1:-1] > 1.4)
    att = out.diagnostics["ee_attempts"].numpy()
    assert att.shape == (K,) and att[0] == 0 and (att[1:] > 0).all()
    assert (out.diagnostics["ee_accept_rate"][1:] > 0.3).all()
    d = out.draws.numpy()
    assert (d[..., 0] > 0.1).mean() > 0.05 and (d[..., 0] < -0.1).mean() > 0.05

    with pytest.raises(ValueError, match="adapt_ladder"):
        mcmc_tpu_torch.aees(_MU[0], _hard_mixture(),
                            mcmc_tpu_torch.AEESSettings(n_keep_draws=10),
                            adapt_ladder=True, device="cpu")
    with pytest.raises(ValueError, match="adapt_ladder"):
        mcmc_tpu_torch.aees(_MU[0], _hard_mixture(), s, adapt_ladder="nope",
                            device="cpu")
    s1 = mcmc_tpu_torch.AEESSettings(temper_vec=np.array([1.0]))
    with pytest.raises(ValueError, match="> 1"):
        mcmc_tpu_torch.aees(_MU[0], _hard_mixture(), s1, adapt_ladder=True,
                            device="cpu")


def test_build_ee_ladder_warnings():
    """``test_build_ee_ladder_typed_key_and_cap_warning``'s 2-d cases: a
    Gaussian's ladder starts at 60 and descends; a tiny spacing hits
    ``max_rungs`` and warns; an all-rejecting target warns that the pilot
    barely moves and still gives a finite ladder."""
    lk = lambda v: -0.5 * (v ** 2).sum(-1)
    s = mcmc_tpu_torch.AEESSettings(cov_mat=np.eye(2))
    gen = torch.Generator().manual_seed(0)
    t = taees.build_ee_ladder(gen, lk, torch.zeros(2), s, 2, torch.float32,
                              60.0, n_pilot_draws=100).numpy()
    assert t[0] == pytest.approx(60.0) and np.all(np.diff(t) < 0)
    assert np.all(t > 1.0)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        taees.build_ee_ladder(gen, lk, torch.zeros(2), s, 2, torch.float32,
                              60.0, spacing=0.05, max_rungs=4,
                              n_pilot_draws=100)
    assert any("max_rungs" in str(x.message) for x in w)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        bad = taees.build_ee_ladder(
            gen, lambda v: torch.full(v.shape[:1], -torch.inf), torch.zeros(2),
            s, 2, torch.float32, 60.0, n_pilot_draws=100)
    assert any("barely move" in str(x.message) for x in w)
    assert np.isfinite(bad.numpy()).all()


def test_aees_adapt_ladder_pt():
    """``test_aees_adapt_ladder_pt_legacy`` at 4 runs and 100 + 100 + 600
    draws: the PT pre-run (400 draws) keeps the rung count, ends at 1,
    descends, and moves the ladder off its initial guess."""
    s = mcmc_tpu_torch.AEESSettings(
        n_initial_draws=100, n_burnin_draws=100, n_keep_draws=600,
        n_rings=11, ee_prob_par=0.05, temper_vec=np.array([60.0, 9.0]),
        cov_mat=0.35 * np.eye(2))
    out = mcmc_tpu_torch.aees(_MU[0], _hard_mixture(), s, key=3, n_runs=4,
                              history_capacity=128, adapt_ladder="pt",
                              n_ladder_adapt=400, device="cpu")
    temps = out.diagnostics["temperatures"].numpy()
    assert temps.shape == (3,) and temps[-1] == pytest.approx(1.0)
    assert np.all(np.diff(temps) < 0)
    assert not np.allclose(temps[:-1], [60.0, 9.0], rtol=0.05)


def test_aees_bounded(tmp_path):
    """tests/test_bounded_samplers.py::test_aees_bounded at 4 runs and 100
    + 100 + 800 draws: modes at (1, 1) and (3, 3) in the box [0, 5]^2, every
    draw back-transformed inside it, both modes visited; the same run with
    ``checkpoint_dir=`` gives the same draws."""
    mu = np.array([[1.0, 1.0], [3.0, 3.0]], np.float32)
    lk = tmodels.gaussian_mixture_model(mu, np.array([0.2, 0.2]),
                                        np.array([0.5, 0.5]), device="cpu")
    algo = mcmc_tpu_torch.AlgoSettings(
        rng_seed_value=13, vals_bound=True, lower_bounds=np.zeros(2),
        upper_bounds=np.full(2, 5.0),
        aees_settings=mcmc_tpu_torch.AEESSettings(
            n_initial_draws=100, n_burnin_draws=100, n_keep_draws=800,
            temper_vec=np.array([10.0]), cov_mat=0.3 * np.eye(2)))
    out = mcmc_tpu_torch.aees(mu[0], lk, algo, n_runs=4, device="cpu")
    d = out.draws.numpy()
    assert ((d > 0.0) & (d < 5.0)).all()
    assert (d[..., 0] > 2.0).mean() > 0.1 and (d[..., 0] < 2.0).mean() > 0.1
    ck = mcmc_tpu_torch.aees(mu[0], lk, algo, n_runs=4, device="cpu",
                             checkpoint_dir=tmp_path / "ck",
                             checkpoint_every=300)
    assert torch.equal(ck.draws, out.draws)
