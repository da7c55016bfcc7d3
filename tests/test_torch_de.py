"""The PyTorch port's differential-evolution MCMC against the JAX package's,
on the CPU.

A sweep is held exactly: JAX's sweep, and the port's fed the integers,
box noise and uniforms JAX's sweep draws from its key (the two index
integers of each walker go through the same shifted mapping on both
sides), without and with the every-10th-generation jump, and from a
bounded initial box (``sampling_bounds_check``, the population treated as
unconstrained coordinates, as the reference does). Every state field at
rtol 1e-5 and the accept decisions exactly, one sweep at a time and over
the port's own run. The rest is distributional, on the DE cases of
``tests/test_rmhmc_de_aees.py`` and ``tests/test_bounded_samplers.py`` at
smaller sizes.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmc_tpu
import mcmc_tpu_torch
from mcmc_tpu import bounds as jbounds
from mcmc_tpu import models as jmodels
from mcmc_tpu.samplers import common as jcommon
from mcmc_tpu_torch import bounds as tbounds
from mcmc_tpu_torch import convert
from mcmc_tpu_torch import models as tmodels
from mcmc_tpu_torch.samplers import common as tcommon
from test_torch_chees import assert_close


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for every test here: the tests run in several
    worker processes at once, and torch's default of a thread per core
    oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


jde = importlib.import_module("mcmc_tpu.samplers.de")
tde = importlib.import_module("mcmc_tpu_torch.samplers.de")

N_POP, N_SWEEPS = 24, 25
_MU = np.array([[-2.0, -2.0], [2.0, 2.0]], np.float32)
_HALF = np.array([0.5, 0.5], np.float32)

# (jumps, bounded)
CASES = {"plain": (False, False), "jumps": (True, False),
         "bounded_box": (False, True)}
_RUNS = {}


def _jax_draws(key, cfg, n_vals):
    """The random numbers JAX's sweep takes from ``key``: each walker's two
    index integers, the box noise and the accept uniforms."""
    k_idx, k_noise, k_acc = jax.random.split(key, 3)

    def ints(k):
        k1, k2 = jax.random.split(k)
        return (jax.random.randint(k1, (), 0, cfg.n_pop - 1),
                jax.random.randint(k2, (), 0, cfg.n_pop - 2))

    r1, r2 = jax.vmap(ints)(jax.random.split(k_idx, cfg.n_pop))
    noise = jax.random.uniform(k_noise, (cfg.n_pop, n_vals), jnp.float32,
                               minval=-cfg.par_b, maxval=cfg.par_b)
    return r1, r2, noise, jax.random.uniform(k_acc, (cfg.n_pop,),
                                             jnp.float32)


def _de_case(name):
    """JAX's ``N_SWEEPS`` sweeps of the case (cached) with the draws they
    take, and the port's sweep, on the two-mode mixture (with a box on the
    first coordinate in the bounded case)."""
    jumps, bounded = CASES[name]
    cfg = dict(n_pop=N_POP, jumps=jumps, par_b=0.05, par_gamma_jump=1.5)
    kw = dict(vals_bound=True, lower_bounds=np.array([-1.0, -np.inf]),
              upper_bounds=np.array([3.0, np.inf])) if bounded else {}
    jlk = jmodels.gaussian_mixture_model(_MU, _HALF, _HALF)
    tlk = tmodels.gaussian_mixture_model(_MU, _HALF, _HALF, device="cpu")
    tprob = tcommon.setup_problem(torch.zeros(2), tlk,
                                  mcmc_tpu_torch.AlgoSettings(**kw), None)
    tsweep = tde.build_de_sweep(tprob.box_log_kernel,
                                mcmc_tpu_torch.DESettings(**cfg), 2)
    if name not in _RUNS:
        jprob = jcommon.setup_problem(jnp.zeros(2), jlk,
                                      mcmc_tpu.AlgoSettings(**kw), None)
        jcfg = mcmc_tpu.DESettings(**cfg)
        lb, ub = jbounds.sampling_bounds_check(
            jprob.vals_bound, jprob.codes, jprob.lower_bounds,
            jprob.upper_bounds, np.full(2, -4.0, np.float32),
            np.full(2, 4.0, np.float32))
        U = np.random.default_rng(12).uniform(size=(N_POP, 2)).astype(
            np.float32)
        X0 = lb + (ub - lb) * U
        kv0 = jax.vmap(jprob.box_log_kernel)(X0)
        st = jde.DEState(X=X0, kernel_vals=jnp.where(jnp.isfinite(kv0), kv0,
                                                     -jnp.inf),
                         gen_ind=jnp.asarray(0, jnp.int32))
        sweep = jax.jit(jde.build_de_sweep(jprob.box_log_kernel, jcfg, 2))
        draws_of = jax.jit(lambda k: _jax_draws(k, jcfg, 2))
        as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
        states, infos, draws = [as_np(st)], [], []
        for k in jax.random.split(jax.random.PRNGKey(13), N_SWEEPS):
            draws.append(as_np(draws_of(k)))
            st, info = sweep(k, st)
            states.append(as_np(st))
            infos.append(as_np(info))
        _RUNS[name] = (np.asarray(lb), np.asarray(ub), U, states, infos,
                       draws)
    return tprob, tsweep, _RUNS[name]


def _fed(draws):
    return [torch.from_numpy(np.array(d)) for d in draws]


@pytest.mark.parametrize("name", list(CASES))
def test_de_sweep_matches_jax(name):
    """Each of JAX's sweeps from JAX's state before it, fed its draws:
    population, kernel values and generation counter at rtol 1e-5, the
    accept decisions exactly; the bounded case's initial box equals JAX's
    ``sampling_bounds_check`` and the population starts inside it."""
    tprob, tsweep, (lb, ub, U, states, infos, draws) = _de_case(name)
    tlb, tub = tbounds.sampling_bounds_check(
        tprob.vals_bound, tprob.codes, tprob.lower_bounds,
        tprob.upper_bounds, torch.full((2,), -4.0), torch.full((2,), 4.0))
    np.testing.assert_array_equal(tlb.numpy(), lb)
    np.testing.assert_array_equal(tub.numpy(), ub)
    if CASES[name][1]:
        np.testing.assert_array_equal(lb, [-1.0, -4.0])
        np.testing.assert_array_equal(ub, [3.0, 4.0])
    with torch.no_grad():
        for t, d in enumerate(draws):
            new, info = tsweep.transition(convert.de_state(states[t], "cpu"),
                                          *_fed(d))
            assert_close(new, states[t + 1], what=f"state after {t}")
            np.testing.assert_array_equal(info["accepted"].numpy(),
                                          infos[t]["accepted"])
    acc = np.mean([i["accepted"].mean() for i in infos])
    assert 0.05 < acc < 0.95, acc


# Nothing adapts, but each sweep adds gamma times a difference of two
# walkers' rounding errors to a third's, so the f32 rounding of the two
# packages' arithmetic spreads: after 25 sweeps the population and kernel
# values are within 1.2e-5 of their scale (measured); held at 1e-4.
RUN_RTOL = 1e-4


def test_de_run_fed_jax_draws():
    """The port's own run of every case from JAX's start, fed JAX's draws:
    the same accept decisions at every sweep (the jump sweeps, the 10th and
    20th, included) and the final state within ``RUN_RTOL``; no host
    synchronisation."""
    for name in CASES:
        _, tsweep, (_, _, _, states, infos, draws) = _de_case(name)
        st = convert.de_state(states[0], "cpu")
        with torch.no_grad():
            for t, d in enumerate(draws):
                st, info = tsweep.transition(st, *_fed(d))
                np.testing.assert_array_equal(info["accepted"].numpy(),
                                              infos[t]["accepted"],
                                              err_msg=f"{name} sweep {t}")
        assert_close(st, states[-1], RUN_RTOL, what=f"{name} final state")
        assert int(st.gen_ind) == N_SWEEPS
        assert tsweep.counts == {"sweeps": N_SWEEPS, "syncs": 0}


def test_convert_round_trip():
    """``convert.de_state`` carries JAX's initial population across and
    equals the port's state built from the same numpy population (box
    log-kernel values, generation 0)."""
    for name in CASES:
        tprob, _, (_, _, _, states, _, _) = _de_case(name)
        got = convert.de_state(states[0], "cpu")
        X0 = torch.from_numpy(np.asarray(states[0].X))
        kv = tprob.box_log_kernel(X0)
        want = tde.DEState(X0, torch.where(torch.isfinite(kv), kv,
                                           -torch.inf),
                           torch.zeros((), dtype=torch.int32))
        assert got.gen_ind.dtype == torch.int32 and got.gen_ind.ndim == 0
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def test_distinct_indices():
    """tests/test_rmhmc_de_aees.py::test_de_distinct_indices on the port's
    draws: ``c1 != i``, ``c2`` neither ``i`` nor ``c1``, and every index
    but ``i`` reached, over 500 sweeps of 10 walkers; on the integers JAX
    draws from its keys, the port's mapping gives JAX's partners."""
    sweep = tde.build_de_sweep(lambda x: -(x ** 2).sum(-1),
                               mcmc_tpu_torch.DESettings(n_pop=10), 1)
    st = tde.DEState(torch.zeros(10, 1), torch.zeros(10),
                     torch.zeros((), dtype=torch.int32))
    gen = torch.Generator().manual_seed(0)
    c1s, c2s = [], []
    for _ in range(500):
        r1, r2, _, _ = sweep.draw(gen, st)
        c1, c2 = tde._distinct_pair_indices(r1, r2)
        c1s.append(c1)
        c2s.append(c2)
    c1, c2 = torch.stack(c1s).numpy(), torch.stack(c2s).numpy()
    i = np.arange(10)
    assert (c1 != i).all() and (c2 != i).all() and (c1 != c2).all()
    for w in range(10):
        assert set(c1[:, w]) == set(range(10)) - {w}
    # JAX's partners from 50 sweeps of keys, and the port's mapping of the
    # integers JAX draws from the same keys
    keys = jax.random.split(jax.random.PRNGKey(0), 500).reshape(50, 10, -1)
    idx = jnp.arange(10)
    for k in keys:
        w1, w2 = jax.vmap(jde._distinct_pair_indices, (0, 0, None))(
            k, idx, 10)
        r1, r2 = jax.vmap(lambda kk: tuple(
            jax.random.randint(k_, (), 0, hi) for k_, hi in
            zip(jax.random.split(kk), (9, 8))))(k)
        g1, g2 = tde._distinct_pair_indices(
            torch.from_numpy(np.array(r1)).long(),
            torch.from_numpy(np.array(r2)).long())
        np.testing.assert_array_equal(g1.numpy(), np.asarray(w1))
        np.testing.assert_array_equal(g2.numpy(), np.asarray(w2))


def _gauss_data(seed):
    return (2.0 + np.random.default_rng(seed).standard_normal(100)).astype(
        np.float32)


def test_de_normal_mean_and_jumps():
    """tests/test_rmhmc_de_aees.py:50-76 at 100 walkers: the posterior mean
    within 0.1, acceptance over ``n_keep * n_pop`` in (0.05, 0.9), draws
    ``(n_keep, n_pop, 1)``; the jumps mode within 0.3 of 2."""
    x = _gauss_data(17)
    lk = tmodels.gaussian_mean_model(x, device="cpu")
    algo = mcmc_tpu_torch.AlgoSettings(
        rng_seed_value=1, de_settings=mcmc_tpu_torch.DESettings(
            n_pop=100, n_burnin_draws=300, n_keep_draws=300))
    out = mcmc_tpu_torch.de(np.array([1.0]), lk, algo, device="cpu")
    assert out.draws.shape == (300, 100, 1)
    post = float(x.mean() * 100 / 100.25 + 1.0 * 0.25 / 100.25)
    assert abs(float(out.draws.mean()) - post) < 0.1
    rate = int(out.n_accept_draws) / (300 * 100)
    assert 0.05 < rate < 0.9, rate
    np.testing.assert_allclose(
        float(out.diagnostics["accept_rate_per_walker"].mean()), rate,
        rtol=1e-5)

    s = mcmc_tpu_torch.DESettings(n_pop=50, n_burnin_draws=300,
                                  n_keep_draws=300, jumps=True)
    out = mcmc_tpu_torch.de(np.array([1.0]), tmodels.gaussian_mean_model(
        _gauss_data(23), device="cpu"), s, key=0, device="cpu", thin=2)
    assert abs(float(out.draws.mean()) - 2.0) < 0.3
    assert out.diagnostics["thin"] == 2
    assert float(out.diagnostics["accept_rate_per_walker"].max()) <= 1.0


def test_de_bounded():
    """tests/test_bounded_samplers.py::test_de_bounded at 50 walkers: the
    bounds-clipped initial box and the box kernel keep every draw above the
    lower bound, and the mean lands within 0.3 of the data's."""
    x = _gauss_data(9)
    algo = mcmc_tpu_torch.AlgoSettings(
        rng_seed_value=11, vals_bound=True, lower_bounds=np.array([0.5]),
        upper_bounds=np.array([np.inf]),
        de_settings=mcmc_tpu_torch.DESettings(n_pop=50, n_burnin_draws=300,
                                              n_keep_draws=300))
    out = mcmc_tpu_torch.de(np.array([1.0]), tmodels.gaussian_mean_model(
        x, device="cpu"), algo, device="cpu")
    d = out.draws
    assert bool((d >= 0.5).all())
    assert abs(float(d[100:].mean()) - float(x.mean())) < 0.3


def test_de_mixture_symmetric_means():
    """The suite's ``de_mixture`` row at 200 walkers and a tenth of its
    generations: both modes held (about half the walkers' draws on each
    side) and both means within 5 MC standard errors of the exact 0."""
    lk = tmodels.gaussian_mixture_model(_MU, _HALF, _HALF, device="cpu")
    s = mcmc_tpu_torch.DESettings(n_pop=200, n_burnin_draws=100,
                                  n_keep_draws=200,
                                  initial_lb=np.array([-4.0, -4.0]),
                                  initial_ub=np.array([4.0, 4.0]))
    out = mcmc_tpu_torch.de(np.zeros(2), lk, s, key=7, device="cpu")
    d = out.draws
    share = float((d[..., 0] > 0).float().mean())
    assert 0.3 < share < 0.7, share
    from mcmc_tpu_torch import diagnostics as td
    ess = td.ess(d)
    mcse = d.std(dim=(0, 1)) / torch.sqrt(ess)
    assert bool((d.mean(dim=(0, 1)).abs() <= 5 * mcse).all()), (
        d.mean(dim=(0, 1)), mcse)
