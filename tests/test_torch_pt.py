"""The PyTorch port's parallel tempering against the JAX package's, on the
CPU.

A transition is held exactly: JAX's step under ``jax.vmap`` with the chain
axis named (the ladder adaptation pools over it), and the port's transition
fed the momenta or walk normals, accept uniforms and swap uniforms JAX's
step draws from its keys; HMC and RWMH inner moves (RWMH with a dense
covariance), with and without ladder adaptation, and swaps every second
draw (draws without a swap round, and the round-trip bookkeeping before the
first). Every state field at rtol 1e-5 and the accept and swap decisions
exactly, one transition at a time and over the port's own run. The rest is
distributional, on the cases of ``tests/test_pt.py`` at smaller sizes.

``assert_state`` serves the other tempering and ensemble samplers' tests.
"""

import importlib

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
from test_torch_chees import AX, as_tensors, assert_close, jax_run

jpt = importlib.import_module("mcmc_tpu.samplers.pt")
tpt = importlib.import_module("mcmc_tpu_torch.samplers.pt")

C, D, N_TRANS = 16, 2, 20
_MU = np.array([[-2.0, -2.0], [2.0, 2.0]], np.float32)
_HALF = np.array([0.5, 0.5], np.float32)
_COV = np.array([[0.6, 0.2], [0.2, 0.4]], np.float32)

# (inner, adapt_temps, swap_every)
CASES = {"hmc": ("hmc", False, 1), "hmc_adapt": ("hmc", True, 1),
         "rwmh": ("rwmh", False, 1), "rwmh_adapt_every2": ("rwmh", True, 2)}
_RUNS = {}


def assert_state(got, want, rtol=1e-5, what=""):
    """The port's state ``got`` against JAX's ``want`` field by field: host
    counters (``int``) equal to JAX's (every batched copy), tensors as
    ``assert_close`` holds them."""
    for name, g in zip(got._fields, got):
        w = getattr(want, name)
        if isinstance(g, int):
            np.testing.assert_array_equal(np.asarray(w).reshape(-1), g,
                                          err_msg=f"{what} {name}")
        else:
            assert_close({name: g}, {name: np.asarray(w)}, rtol,
                         what=what)


def _settings(name, **kw):
    inner, adapt, every = CASES[name]
    return dict(n_burnin_draws=30, n_keep_draws=10, n_temps=4,
                max_temp=20.0, inner=inner, step_size=0.3, n_leap_steps=3,
                par_scale=0.9, cov_mat=_COV if inner == "rwmh" else None,
                swap_every=every, adapt_temps=adapt, **kw)


def _jax_draws(key, inner, K):
    """The random numbers JAX's PT step takes from ``key``: each replica's
    momenta (or walk normals) and accept uniform, and the swap uniforms."""
    k_inner, k_swap = jax.random.split(key)

    def one(k):
        k1, k2 = jax.random.split(k)
        return (jax.random.normal(k1, (D,), jnp.float32),
                jax.random.uniform(k2, dtype=jnp.float32))

    noise, u = jax.vmap(one)(jax.random.split(k_inner, K))
    return noise, u, jax.random.uniform(k_swap, (K - 1,), jnp.float32)


def _pt_case(name):
    """JAX's ``N_TRANS`` transitions of the case (cached) with the draws they
    take, and the port's kernel, on the two-mode mixture."""
    s = _settings(name)
    jlk = jmodels.gaussian_mixture_model(_MU, _HALF, _HALF)
    tlk = tmodels.gaussian_mixture_model(_MU, _HALF, _HALF, device="cpu")
    n_adapt = 30
    _, tstep = tpt.build_pt_kernel(tlk, mcmc_tpu_torch.PTSettings(**s), D,
                                   torch.float32, "cpu", n_adapt)
    if name not in _RUNS:
        jmake, jstep = jpt.build_pt_kernel(jlk, mcmc_tpu.PTSettings(**s), D,
                                           jnp.float32, n_adapt,
                                           axis_name=AX)
        first = 1.5 * np.random.default_rng(5).standard_normal(
            (C, D)).astype(np.float32)
        state0 = jax.vmap(lambda f: jmake(f, jlk(f)))(first)
        K = int(state0.X.shape[1])
        _RUNS[name] = jax_run(jstep, lambda k: _jax_draws(k, s["inner"], K),
                              state0, N_TRANS, seed=21)
    return tstep, _RUNS[name]


def _transition_args(draws, draw_ind, every):
    """JAX's draws as the port's: no swap uniforms off a swap round."""
    noise, u, u_swap = as_tensors(draws)
    if draw_ind % every != every - 1:
        u_swap = None
    return noise, u, u_swap


@pytest.mark.parametrize("name", list(CASES))
def test_pt_transition_matches_jax(name):
    """Each of JAX's transitions from JAX's state before it, fed its draws:
    every state field at rtol 1e-5 (the draw counter equal), the cold
    chain's accept decisions and the swap decisions exactly, the swap
    attempts on the even/odd pattern of the round."""
    tstep, (states, infos, draws) = _pt_case(name)
    every = CASES[name][2]
    n_swaps = 0
    with torch.no_grad():
        for t, d in enumerate(draws):
            st = convert.pt_state(states[t], "cpu")
            new, info = tstep.transition(
                st, *_transition_args(d, st.draw_ind, every))
            assert_state(new, states[t + 1], what=f"state after {t}")
            for k in ("accepted", "swap_accepted", "swap_attempted"):
                np.testing.assert_array_equal(info[k].numpy(), infos[t][k],
                                              err_msg=f"{k} of {t}")
            n_swaps += int(infos[t]["swap_accepted"].sum())
    assert n_swaps > 20, n_swaps
    if CASES[name][1]:   # the ladder moved, identically in every chain
        rho = states[-1].rho
        assert np.abs(rho - states[0].rho).max() > 1e-3
        np.testing.assert_array_equal(rho, np.broadcast_to(rho[0], rho.shape))


# Measured over the 20 fed transitions of the port's own run: positions and
# kernel values within 2.1e-6 of their scale, the adapted spacings within
# 2.3e-7 (each round's pooled swap probability is a mean over 16 chains'
# f32 exponentials, and the gain shrinks); held at 1e-5.
RUN_RTOL = 1e-5


@pytest.mark.parametrize("name", list(CASES))
def test_pt_run_fed_jax_draws(name):
    """The port's own run of the case from JAX's first state, fed JAX's
    draws: the same accept and swap decisions at every transition and the
    final state within ``RUN_RTOL``; no host synchronisation, a swap round
    every ``swap_every`` draws."""
    every = CASES[name][2]
    tstep, (states, infos, draws) = _pt_case(name)
    before = dict(tstep.counts)
    st = convert.pt_state(states[0], "cpu")
    with torch.no_grad():
        for t, d in enumerate(draws):
            st, info = tstep.transition(
                st, *_transition_args(d, st.draw_ind, every))
            for k in ("accepted", "swap_accepted"):
                np.testing.assert_array_equal(
                    info[k].numpy(), infos[t][k],
                    err_msg=f"{name}: {k} of {t}")
    assert_state(st, states[-1], RUN_RTOL, what=f"{name} final state")
    assert tstep.counts["syncs"] == before["syncs"] == 0
    assert tstep.counts["swap_rounds"] - before["swap_rounds"] \
        == N_TRANS // every


@pytest.mark.parametrize("name", list(CASES))
def test_convert_round_trip(name):
    """``convert.pt_state`` carries the case's initial ladders from JAX
    across and equals the port's ``make_state0`` from the same starting
    points."""
    tstep, (states, _, _) = _pt_case(name)
    tlk = tmodels.gaussian_mixture_model(_MU, _HALF, _HALF, device="cpu")
    make0, _ = tpt.build_pt_kernel(
        tlk, mcmc_tpu_torch.PTSettings(**_settings(name)), D,
        torch.float32, "cpu", 30)
    first = torch.tensor(np.asarray(states[0].X[:, 0]))
    want = make0(first, tlk(first))
    got = convert.pt_state(states[0], "cpu")
    assert got.draw_ind == 0 and got.occ.dtype == torch.int32
    for f, g, w in zip(got._fields, got, want):
        if f == "draw_ind":
            continue
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6,
                                   msg=f"{name} {f}")


def test_make_ladder_and_rho_round_trip():
    """tests/test_pt.py's ladders: the geometric and the explicit ladder
    equal JAX's, entries <= 1 and duplicates are refused, and the spacings
    ``rho`` give back the ladder's log-temperatures (float64)."""
    for kw in (dict(n_temps=4, max_temp=27.0), dict(n_temps=6, max_temp=60.0),
               dict(temper_vec=[10.0, 3.0]), dict(n_temps=1)):
        np.testing.assert_array_equal(
            tpt.make_ladder(mcmc_tpu_torch.PTSettings(**kw)).numpy(),
            np.asarray(jpt.make_ladder(mcmc_tpu.PTSettings(**kw),
                                       jnp.float32)), err_msg=str(kw))
    for bad in ([1.0, 3.0], [0.25, 0.5]):
        with pytest.raises(ValueError, match="must all be > 1"):
            tpt.make_ladder(mcmc_tpu_torch.PTSettings(temper_vec=bad))
    with pytest.raises(ValueError, match="strictly descending"):
        tpt.make_ladder(mcmc_tpu_torch.PTSettings(temper_vec=[3.0, 3.0]))
    temps = tpt.make_ladder(mcmc_tpu_torch.PTSettings(n_temps=5,
                                                      max_temp=64.0),
                            torch.float64)
    lt = torch.log(temps)
    rho = torch.log(lt[:-1] - lt[1:])
    torch.testing.assert_close(tpt._log_temps_from_rho(rho), lt, rtol=1e-12,
                               atol=1e-12)


def test_swap_permutation_detailed():
    """tests/test_pt.py::test_pt_swap_permutation_detailed on the port: with
    every pair's log alpha large, draw 0 (parity 0) exchanges (0,1) and
    (2,3), draw 1 (parity 1) only (1,2); occupants follow."""
    s = mcmc_tpu_torch.PTSettings(n_temps=4, max_temp=8.0, inner="rwmh",
                                  par_scale=1e-6)
    box = lambda z: -0.5 * (z ** 2).sum(-1)
    make0, step = tpt.build_pt_kernel(box, s, 2, torch.float32, "cpu", 0)
    st = make0(torch.zeros(1, 2), torch.zeros(1))
    X = torch.arange(8.0).reshape(1, 4, 2)
    kv = torch.tensor([[40.0, 30.0, 20.0, 10.0]])
    st = st._replace(X=X, kv=kv)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        st1, info = step(gen, st)
        np.testing.assert_array_equal(st1.X[0].numpy(),
                                      X[0].numpy()[[1, 0, 3, 2]])
        np.testing.assert_array_equal(st1.kv[0].numpy(),
                                      kv[0].numpy()[[1, 0, 3, 2]])
        np.testing.assert_array_equal(st1.occ[0].numpy(), [1, 0, 3, 2])
        np.testing.assert_array_equal(info["swap_attempted"][0].numpy(),
                                      [1.0, 0.0, 1.0])
        st2, info2 = step(gen, st1._replace(kv=kv))
        np.testing.assert_array_equal(info2["swap_attempted"][0].numpy(),
                                      [0.0, 1.0, 0.0])
        np.testing.assert_array_equal(st2.X[0].numpy(),
                                      st1.X[0].numpy()[[0, 2, 1, 3]])


def _bimodal(v):
    return torch.logaddexp(-0.5 * ((v - 2.0) ** 2).sum(-1),
                           -0.5 * ((v + 2.0) ** 2).sum(-1))


def test_pt_bimodal_mode_recovery():
    """tests/test_pt.py::test_pt_bimodal_mode_recovery at 16 ladders and
    200 + 600 draws: the cold chains hold both modes at 0.5 +- 0.1, each
    mode's mean within 0.2 of +-2, every chain crosses (its share of the
    positive mode in (0.1, 0.9)), every pair's swap rate in (0.2, 0.95)."""
    s = mcmc_tpu_torch.PTSettings(n_burnin_draws=200, n_keep_draws=600,
                                  n_temps=6, max_temp=50.0, inner="hmc",
                                  step_size=0.25, n_leap_steps=5)
    out = mcmc_tpu_torch.pt(np.zeros(2), _bimodal, s, n_chains=16, key=0,
                            device="cpu")
    d = out.draws.numpy()
    assert d.shape == (600, 16, 2)
    pos = d[..., 0] > 0
    assert 0.4 < pos.mean() < 0.6, pos.mean()
    np.testing.assert_allclose(d[pos].mean(axis=0), [2.0, 2.0], atol=0.2)
    np.testing.assert_allclose(d[~pos].mean(axis=0), [-2.0, -2.0], atol=0.2)
    per_chain = pos.mean(axis=0)
    assert (per_chain > 0.1).all() and (per_chain < 0.9).all(), per_chain
    rates = out.diagnostics["swap_accept_rate"].numpy()
    assert rates.shape == (16, 5)
    assert (rates > 0.2).all() and (rates < 0.95).all()


def test_pt_rwmh_inner_squeeze_and_thin():
    """tests/test_pt.py::test_pt_rwmh_inner_and_squeeze: one ladder (chain
    axis squeezed) crosses modes; with ``thin=2`` the round-trip rate
    divides by every sweep and ``resume`` continues the ladder."""
    s = mcmc_tpu_torch.PTSettings(n_burnin_draws=200, n_keep_draws=600,
                                  n_temps=5, max_temp=30.0, inner="rwmh",
                                  par_scale=0.8)
    out = mcmc_tpu_torch.pt(np.zeros(2), _bimodal, s, key=3, device="cpu")
    assert out.draws.shape == (600, 2)
    assert 0.1 < float((out.draws[:, 0] > 0).float().mean()) < 0.9
    assert out.diagnostics["swap_accept_rate"].shape == (4,)
    out = mcmc_tpu_torch.pt(np.zeros(2), _bimodal, s, n_chains=2, key=3,
                            device="cpu", thin=2, return_resume=True)
    trips = out.diagnostics["round_trips"]
    torch.testing.assert_close(out.diagnostics["round_trip_rate"],
                               trips.float() / 1600.0)
    assert out.diagnostics["thin"] == 2
    more = out.diagnostics["resume"](5, 50)
    assert more.draws.shape == (50, 2, 2)
    assert bool((more.diagnostics["round_trips"] >= trips).all())


def test_pt_ladder_adaptation_targets_swap_rate():
    """tests/test_pt.py::test_pt_ladder_adaptation_targets_swap_rate at its
    size (16 ladders, 1500 + 800 draws): from a ladder far too dense (max 3) the
    adapted ladder widens, stays descending to 1, is the same in every
    chain, and every pair's kept swap rate is within 0.15 of 0.234."""
    s = mcmc_tpu_torch.PTSettings(n_burnin_draws=1500, n_keep_draws=800,
                                  n_temps=6, max_temp=3.0, inner="rwmh",
                                  par_scale=0.8, adapt_temps=True)
    out = mcmc_tpu_torch.pt(np.zeros(2), _bimodal, s, n_chains=16, key=4,
                            device="cpu")
    temps = out.diagnostics["temperatures"].numpy()
    assert temps[0] > 3.0 and abs(temps[-1] - 1.0) < 1e-6
    assert (temps[:-1] > temps[1:]).all()
    rates = out.diagnostics["swap_accept_rate"].numpy().mean(axis=0)
    assert (np.abs(rates - 0.234) < 0.15).all(), rates


def test_pt_bounded_and_single_temperature():
    """tests/test_pt.py::test_pt_bounded (draws stay above the bound, the
    truncated normal's mean 1.09 within 0.25) and
    ``test_pt_single_temperature_degenerates_to_inner`` (K = 1 is plain
    HMC, 16 chains of 100 + 400 draws: no swap diagnostics, no round trips,
    N(0, I) moments within 0.15 and 0.2)."""
    algo = mcmc_tpu_torch.AlgoSettings(
        vals_bound=True, lower_bounds=np.zeros(2),
        upper_bounds=np.full(2, np.inf),
        pt_settings=mcmc_tpu_torch.PTSettings(
            n_burnin_draws=150, n_keep_draws=300, n_temps=4, max_temp=10.0,
            step_size=0.15, n_leap_steps=4))
    out = mcmc_tpu_torch.pt(np.ones(2), lambda v: -0.5 * ((v - 1.0) ** 2)
                            .sum(-1), algo, n_chains=4, key=9, device="cpu")
    d = out.draws.numpy()
    assert (d > 0).all()
    assert abs(d.mean() - 1.09) < 0.25

    s = mcmc_tpu_torch.PTSettings(n_burnin_draws=100, n_keep_draws=400,
                                  temper_vec=[], step_size=0.3,
                                  n_leap_steps=5)
    out = mcmc_tpu_torch.pt(np.zeros(3), lambda v: -0.5 * (v ** 2).sum(-1),
                            s, n_chains=16, key=11, device="cpu")
    assert out.diagnostics["swap_accept_rate"].numel() == 0
    assert int(out.diagnostics["round_trips"].sum()) == 0
    d = out.draws.numpy()
    np.testing.assert_allclose(d.mean(axis=(0, 1)), 0.0, atol=0.15)
    np.testing.assert_allclose(d.var(axis=(0, 1)), 1.0, atol=0.2)


def test_pt_round_trips():
    """tests/test_pt.py's round-trip cases: a healthy 4-rung ladder on a
    Gaussian completes trips in every one of 4 ladders (rate = trips /
    sweeps), and two rungs at nearly one temperature swap almost every
    sweep: 30-60 trips in 100 sweeps."""
    lk = lambda v: -0.5 * (v ** 2).sum(-1)
    s = mcmc_tpu_torch.PTSettings(n_burnin_draws=200, n_keep_draws=800,
                                  n_temps=4, max_temp=8.0, step_size=0.5,
                                  n_leap_steps=4)
    out = mcmc_tpu_torch.pt(np.zeros(2), lk, s, n_chains=4, key=0,
                            device="cpu")
    trips = out.diagnostics["round_trips"].numpy()
    assert trips.shape == (4,) and trips.min() > 0, trips
    np.testing.assert_allclose(out.diagnostics["round_trip_rate"].numpy(),
                               trips / 1000.0, rtol=1e-6)
    s = mcmc_tpu_torch.PTSettings(n_burnin_draws=0, n_keep_draws=100,
                                  temper_vec=[1.0 + 1e-4], step_size=0.3,
                                  n_leap_steps=2)
    out = mcmc_tpu_torch.pt(np.zeros(1), lk, s, key=2, device="cpu")
    assert 30 <= int(out.diagnostics["round_trips"]) <= 60


def test_pt_determinism_and_refusals(tmp_path):
    """One seed repeats bit for bit; ``mesh=`` raises (not ported),
    ``checkpoint_dir=`` gives the in-memory run's draws, ``return_resume``
    with ``checkpoint_dir`` and an unknown inner move are refused."""
    s = mcmc_tpu_torch.PTSettings(n_burnin_draws=10, n_keep_draws=20,
                                  n_temps=3, adapt_temps=True)
    a = mcmc_tpu_torch.pt(np.zeros(2), _bimodal, s, n_chains=3, key=7,
                          device="cpu")
    b = mcmc_tpu_torch.pt(np.zeros(2), _bimodal, s, n_chains=3, key=7,
                          device="cpu")
    assert torch.equal(a.draws, b.draws)
    assert torch.equal(a.diagnostics["temperatures"],
                       b.diagnostics["temperatures"])
    with pytest.raises(NotImplementedError, match="A12"):
        mcmc_tpu_torch.pt(np.zeros(2), _bimodal, s, mesh=object(),
                          device="cpu")
    assert torch.equal(
        a.draws, mcmc_tpu_torch.pt(np.zeros(2), _bimodal, s, n_chains=3,
                                   key=7, device="cpu", checkpoint_every=7,
                                   checkpoint_dir=tmp_path / "ck").draws)
    with pytest.raises(ValueError, match="incompatible"):
        mcmc_tpu_torch.pt(np.zeros(2), _bimodal, s, checkpoint_dir="x",
                          return_resume=True, device="cpu")
    with pytest.raises(ValueError, match="inner"):
        mcmc_tpu_torch.pt(np.zeros(2), _bimodal,
                          mcmc_tpu_torch.PTSettings(inner="nuts"),
                          device="cpu")
