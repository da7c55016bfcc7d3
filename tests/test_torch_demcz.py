"""The PyTorch port's DE-MC(Z) against the JAX package's, on the CPU.

A generation is held exactly: JAX's sweep under ``jax.vmap`` over three
runs (each with its own archive), and the port's generation fed the archive
indices, box noise, snooker scales, move choices and accept uniforms JAX's
sweep draws from its keys: parallel and snooker moves (a snooker anchor
equal to the walker's own state among them), the every-10th-generation
jump, the strided archive append, an archive that wraps as a ring, and a
bounded target. Every state field at rtol 1e-5 (the fill count and
generation counter equal) and the accept decisions exactly, one generation
at a time and over the port's own run. The rest is distributional, on the
cases of ``tests/test_demcz.py`` at smaller sizes.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmc_tpu
import mcmc_tpu_torch
from mcmc_tpu import bounds as jbounds
from mcmc_tpu.samplers import common as jcommon
from mcmc_tpu_torch import convert
from mcmc_tpu_torch import diagnostics as td
from mcmc_tpu_torch import models as tmodels
from mcmc_tpu_torch.samplers import common as tcommon
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


jdz = importlib.import_module("mcmc_tpu.samplers.demcz")
tdz = importlib.import_module("mcmc_tpu_torch.samplers.demcz")

R, N_POP, D, N_GENS, N_INIT = 3, 5, 3, 25, 12
_COV = np.array([[1.0, 0.6, 0.1], [0.6, 1.0, 0.3], [0.1, 0.3, 0.7]],
                np.float32)
_PREC = np.linalg.inv(_COV).astype(np.float32)
# (capacity, bounded)
CASES = {"growing": (N_INIT + N_POP * (N_GENS // 3), False),
         "ring": (14, False), "bounded": (N_INIT + N_POP * (N_GENS // 3),
                                          True)}
SETTINGS = dict(n_pop=N_POP, snooker_prob=0.3, jumps=True,
                par_gamma_jump=1.0, par_b=1e-3, archive_stride=3)
_RUNS = {}


def _targets(name):
    jP, tP = jnp.asarray(_PREC), torch.tensor(_PREC)
    kw = dict(vals_bound=True, lower_bounds=np.array([-2.0, 0.0, -np.inf]),
              upper_bounds=np.array([2.0, np.inf, np.inf])) \
        if CASES[name][1] else {}
    return (lambda v: -0.5 * v @ jP @ v,
            lambda v: -0.5 * ((v @ tP) * v).sum(-1), kw)


def _jax_draws(key, filled):
    """The random numbers JAX's sweep takes from ``key`` with ``filled``
    archive entries: each walker's three uniform integers, the box noise,
    the snooker scales, the move choices and the accept uniforms."""
    k_idx, k_gs, k_choice, k_noise, k_acc = jax.random.split(key, 5)

    def ints(k):
        k1, k2, k3 = jax.random.split(k, 3)
        return (jax.random.randint(k1, (), 0, filled),
                jax.random.randint(k2, (), 0, filled - 1),
                jax.random.randint(k3, (), 0, filled - 2))

    r1, r2, r3 = jax.vmap(ints)(jax.random.split(k_idx, N_POP))
    b = SETTINGS["par_b"]
    return (r1, r2, r3,
            jax.random.uniform(k_noise, (N_POP, D), jnp.float32, minval=-b,
                               maxval=b),
            jax.random.uniform(k_gs, (N_POP,), jnp.float32, minval=1.2,
                               maxval=2.2),
            jax.random.uniform(k_choice, (N_POP,), jnp.float32),
            jax.random.uniform(k_acc, (N_POP,), jnp.float32))


def _demcz_case(name):
    """JAX's ``N_GENS`` generations of ``R`` runs (cached) with the draws
    they take, and the port's sweep."""
    cap, _ = CASES[name]
    jlk, tlk, kw = _targets(name)
    tprob = tcommon.setup_problem(torch.zeros(D), tlk,
                                  mcmc_tpu_torch.AlgoSettings(**kw), None)
    tsweep = tdz.build_demcz_sweep(
        tprob.box_log_kernel, mcmc_tpu_torch.DEMCZSettings(**SETTINGS), D,
        cap)
    if name not in _RUNS:
        jprob = jcommon.setup_problem(jnp.zeros(D), jlk,
                                      mcmc_tpu.AlgoSettings(**kw), None)
        U = np.random.default_rng(8).uniform(size=(R, N_INIT, D)).astype(
            np.float32)
        Zi = -1.5 + 3.0 * U
        if kw:   # the box sampled inside the bounds, then transformed
            Zi[..., 1] = np.abs(Zi[..., 1]) + 0.05
            Zi = np.asarray(jax.vmap(jax.vmap(lambda v: jbounds.transform(
                v, jprob.codes, jprob.lower_bounds, jprob.upper_bounds)))(
                    Zi))
        Z0 = np.zeros((R, cap, D), np.float32)
        Z0[:, :N_INIT] = Zi
        X0 = Zi[:, -N_POP:]
        kv0 = jax.vmap(jax.vmap(jprob.box_log_kernel))(X0)
        st = jdz.DEMCZState(X=X0, kernel_vals=kv0, Z=Z0,
                            m_total=np.full(R, N_INIT, np.int32),
                            gen_ind=np.zeros(R, np.int32))
        sweep = jax.jit(jax.vmap(jdz.build_demcz_sweep(
            jprob.box_log_kernel, mcmc_tpu.DEMCZSettings(**SETTINGS), D,
            cap)))
        draws_of = jax.jit(jax.vmap(_jax_draws, (0, None)))
        as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
        states, infos, draws = [as_np(st)], [], []
        for k in jax.random.split(jax.random.PRNGKey(19), N_GENS):
            keys = jax.random.split(k, R)
            filled = min(int(states[-1].m_total[0]), cap)
            draws.append(as_np(draws_of(keys, filled)))
            st, info = sweep(keys, st)
            states.append(as_np(st))
            infos.append(as_np(info))
        _RUNS[name] = (states, infos, draws)
    return tsweep, _RUNS[name]


@pytest.mark.parametrize("name", list(CASES))
def test_demcz_generation_matches_jax(name):
    """Each of JAX's generations from JAX's state before it, fed its draws:
    populations, kernel values and archives at rtol 1e-5, the fill count
    and generation counter equal, the accept decisions exactly. The cases
    reach both moves (accepted and rejected), the jump generations, the
    appends (the ring wraps), and a snooker anchor equal to the walker's
    own state, counted as a rejection."""
    tsweep, (states, infos, draws) = _demcz_case(name)
    with torch.no_grad():
        for t, d in enumerate(draws):
            new, info = tsweep.transition(
                convert.demcz_state(states[t], "cpu"), *as_tensors(d))
            assert_state(new, states[t + 1], what=f"state after {t}")
            np.testing.assert_array_equal(info["accepted"].numpy(),
                                          infos[t]["accepted"],
                                          err_msg=f"accepts of {t}")
    acc = np.stack([i["accepted"] for i in infos])
    snooker = np.stack([d[5] for d in draws]) < SETTINGS["snooker_prob"]
    assert (acc & snooker).any() and (acc & ~snooker).any()
    assert (~acc & snooker).any() and (~acc & ~snooker).any()
    m = [int(s.m_total[0]) for s in states]
    assert m[3] == N_INIT + N_POP and m[-1] == N_INIT + 8 * N_POP
    if name == "growing":
        # the degenerate snooker: anchor z == x_i (the population starts
        # as the archive's last rows)
        degenerate = []
        for t, d in enumerate(draws):
            r1, r2, r3 = (torch.from_numpy(np.array(a)).long()
                          for a in d[:3])
            _, _, rz = tdz._distinct_triple(r1, r2, r3)
            z = np.take_along_axis(states[t].Z, rz.numpy()[..., None], 1)
            degenerate.append((z == states[t].X).all(-1) & snooker[t])
        degenerate = np.stack(degenerate)
        assert degenerate.any() and not (acc & degenerate).any()


# Nothing adapts, but a snooker move divides by |x_i - z|^2, and where a
# walker sits within a parallel move's noise of its anchor (the ring case's
# 14-entry archive holds mostly recent states) the difference cancels and
# the rounding of x_i is amplified by |Z_r1 - Z_r2| / |x_i - z|. Measured
# over the 25 generations of the port's own run: the growing and bounded
# archives within 1.5e-6 of each field's scale, the ring within 1.5e-4 (the
# kernel values; the population 6.3e-5), with JAX's decisions throughout.
# Held at 1e-5, and the ring at 5e-4.
RUN_RTOL = {"growing": 1e-5, "ring": 5e-4, "bounded": 1e-5}


@pytest.mark.parametrize("name", list(CASES))
def test_demcz_run_fed_jax_draws(name):
    """The port's own run of the case from JAX's start, fed JAX's draws:
    the same accept decisions at every generation, the final state within
    ``RUN_RTOL``; no host synchronisation."""
    tsweep, (states, infos, draws) = _demcz_case(name)
    before = tsweep.counts["sweeps"]
    st = convert.demcz_state(states[0], "cpu")
    with torch.no_grad():
        for t, d in enumerate(draws):
            st, info = tsweep.transition(st, *as_tensors(d))
            np.testing.assert_array_equal(info["accepted"].numpy(),
                                          infos[t]["accepted"],
                                          err_msg=f"{name} gen {t}")
    assert_state(st, states[-1], RUN_RTOL[name], what=f"{name} final")
    assert tsweep.counts["sweeps"] - before == N_GENS
    assert tsweep.counts["syncs"] == 0


def test_convert_round_trip_and_distinct_triple():
    """``convert.demcz_state`` of one run gains the run axis and equals the
    batched conversion's first run; ``_distinct_triple`` maps JAX's
    integers to JAX's mutually distinct indices (and reaches every index
    of a 6-entry archive)."""
    _, (states, _, _) = _demcz_case("growing")
    both = convert.demcz_state(states[0], "cpu")
    one = convert.demcz_state(jax.tree_util.tree_map(lambda a: a[0],
                                                     states[0]), "cpu")
    assert one.X.shape == (1, N_POP, D) and one.m_total == N_INIT
    for f in ("X", "kernel_vals", "Z"):
        torch.testing.assert_close(getattr(one, f), getattr(both, f)[:1])
    keys = jax.random.split(jax.random.PRNGKey(0), 400)
    want = np.stack([np.asarray(a) for a in jax.vmap(
        jdz._distinct_triple, (0, None))(keys, 6)])
    ints = jax.vmap(lambda k: [jax.random.randint(kk, (), 0, hi) for kk, hi
                               in zip(jax.random.split(k, 3), (6, 5, 4))])(
        keys)
    got = tdz._distinct_triple(*(torch.from_numpy(np.array(a)).long()
                                 for a in ints))
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), want)
    r1, r2, r3 = want
    assert ((r1 != r2) & (r1 != r3) & (r2 != r3)).all()
    assert set(r3) == set(range(6))


def _ks_stat_vs_normal(x):
    x = np.sort(np.asarray(x, np.float64))
    n = len(x)
    cdf = 0.5 * (1.0 + np.vectorize(math.erf)(x / math.sqrt(2.0)))
    return max(np.max(np.arange(1, n + 1) / n - cdf),
               np.max(cdf - np.arange(0, n) / n))


def test_demcz_smallpop_correlated_and_replicas():
    """tests/test_demcz.py's ``test_smallpop_highdim_correlated`` and
    ``test_n_runs_independent_replicas`` at 10 dims: 8 runs of 6 walkers
    (700 + 1,000 generations) on the rho = 0.8 Gaussian, draws ``(n_keep,
    48, 10)``, means within 0.15, variances in (0.8, 1.25), the first
    correlation within 0.08 of 0.8, cross-run split R-hat < 1.06."""
    d, rho = 10, 0.8
    cov = rho * np.ones((d, d)) + (1 - rho) * np.eye(d)
    P = torch.tensor(np.linalg.inv(cov), dtype=torch.float32)
    out = mcmc_tpu_torch.demcz(
        np.zeros(d), lambda x: -0.5 * ((x @ P) * x).sum(-1),
        mcmc_tpu_torch.DEMCZSettings(n_pop=6, n_burnin_draws=700,
                                     n_keep_draws=1000),
        n_runs=8, key=0, device="cpu")
    assert out.draws.shape == (1000, 48, d)
    pooled = out.draws.reshape(-1, d).numpy()
    assert np.abs(pooled.mean(0)).max() < 0.15
    assert 0.8 < pooled.var(0).min() and pooled.var(0).max() < 1.25
    assert abs(np.corrcoef(pooled[:, 0], pooled[:, 1])[0, 1] - rho) < 0.08
    assert float(td.split_rhat(out.draws).max()) < 1.06


def test_demcz_snooker_exactness():
    """``test_snooker_exactness_ks`` at 4 runs of 8 walkers and 500 + 1,500
    pure-snooker generations on N(0, 1)^2: the thinned first coordinate
    passes the KS test at 1.95/sqrt(n), both variances within 0.08 of 1
    (the (d-1) Jacobian term is load-bearing)."""
    out = mcmc_tpu_torch.demcz(
        np.zeros(2), lambda v: -0.5 * (v * v).sum(-1),
        mcmc_tpu_torch.DEMCZSettings(n_pop=8, n_burnin_draws=500,
                                     n_keep_draws=1500, snooker_prob=1.0),
        n_runs=4, key=1, device="cpu")
    d = out.draws.numpy()
    samples = d[::8, :, 0].reshape(-1)
    assert _ks_stat_vs_normal(samples) < 1.95 / math.sqrt(len(samples))
    assert np.allclose(d.reshape(-1, 2).var(0), 1.0, atol=0.08)


def test_demcz_ring_archive_bounded_and_archive_fill():
    """``test_ring_archive_bounded_memory`` (a 128-entry ring: mean within
    0.1, variance within 0.1 of 1, at 4 runs of 8 walkers and 500 + 1,500
    generations), ``test_bounded_draws_inside`` (inside (0, 1), mean in
    (0.2, 0.45)), and ``test_archive_stride_and_fill``'s counts: appends
    after generations 3, 6 and 9."""
    out = mcmc_tpu_torch.demcz(
        np.zeros(2), lambda v: -0.5 * (v * v).sum(-1),
        mcmc_tpu_torch.DEMCZSettings(n_pop=8, n_burnin_draws=500,
                                     n_keep_draws=1500, archive_size=128),
        n_runs=4, key=7, device="cpu")
    pooled = out.draws.reshape(-1, 2).numpy()
    assert np.abs(pooled.mean(0)).max() < 0.1
    assert np.allclose(pooled.var(0), 1.0, atol=0.1)

    out = mcmc_tpu_torch.demcz(
        np.array([0.5]), lambda v: -8.0 * (v[:, 0] - 0.3) ** 2,
        mcmc_tpu_torch.AlgoSettings(
            vals_bound=True, lower_bounds=np.array([0.0]),
            upper_bounds=np.array([1.0]),
            demcz_settings=mcmc_tpu_torch.DEMCZSettings(
                n_pop=8, n_burnin_draws=300, n_keep_draws=800)),
        key=4, device="cpu")
    d = out.draws.numpy()
    assert (d > 0.0).all() and (d < 1.0).all() and 0.2 < d.mean() < 0.45

    s = mcmc_tpu_torch.DEMCZSettings(n_pop=4, n_initial_archive=6,
                                     archive_stride=3)
    capacity = 6 + 4 * 3
    sweep = tdz.build_demcz_sweep(lambda v: -0.5 * (v * v).sum(-1), s, 2,
                                  capacity)
    Z0 = torch.zeros((1, capacity, 2))
    Z0[:, :6] = 1.0
    state = tdz.DEMCZState(X=torch.ones((1, 4, 2)),
                           kernel_vals=torch.full((1, 4), -1.0), Z=Z0,
                           m_total=6, gen_ind=0)
    gen = torch.Generator().manual_seed(6)
    fills = []
    with torch.no_grad():
        for _ in range(9):
            state, _ = sweep(gen, state)
            fills.append(state.m_total)
    assert fills == [6, 6, 10, 10, 10, 14, 14, 14, 18]
    assert state.gen_ind == 9


def test_demcz_mean_determinism_resume_and_refusals(tmp_path):
    """``test_gaussian_mean_posterior`` (mean within 0.1, acceptance in
    (0.05, 0.95)); one seed repeats bit for bit; a warm ``resume`` carries
    the archive; ``thin=2``; the refusals of ``test_validation_errors``,
    ``n_runs < 1``, and a non-mesh ``mesh``; ``checkpoint_dir=`` gives
    the in-memory run's draws."""
    x = (2.0 + np.random.default_rng(1).standard_normal(100)).astype(
        np.float32)
    lk = tmodels.gaussian_mean_model(x, device="cpu")
    s = mcmc_tpu_torch.DEMCZSettings(n_pop=8, n_burnin_draws=300,
                                     n_keep_draws=800)
    out = mcmc_tpu_torch.demcz(np.array([1.0]), lk, s, key=3, device="cpu",
                               return_resume=True)
    post_mean = (x.sum() + 0.25) / (100 + 0.25)
    assert abs(float(out.draws.mean()) - post_mean) < 0.1
    acc = float(out.diagnostics["accept_rate_per_walker"].mean())
    assert 0.05 < acc < 0.95
    again = mcmc_tpu_torch.demcz(np.array([1.0]), lk, s, key=3, device="cpu")
    assert torch.equal(out.draws, again.draws)
    more = out.diagnostics["resume"](5, 30)
    assert more.draws.shape == (30, 8, 1)
    t2 = mcmc_tpu_torch.demcz(np.array([1.0]), lk, s, key=3, device="cpu",
                              thin=2, n_runs=2)
    assert t2.draws.shape == (800, 16, 1) and t2.diagnostics["thin"] == 2
    sq = lambda v: -0.5 * (v * v).sum(-1)
    for kw, msg in ((dict(n_pop=3), "n_pop"),
                    (dict(snooker_prob=1.5), "snooker_prob"),
                    (dict(archive_stride=0), "archive_stride"),
                    (dict(archive_size=4, n_initial_archive=16),
                     "archive_size")):
        with pytest.raises(ValueError, match=msg):
            mcmc_tpu_torch.demcz(np.zeros(2), sq,
                                 mcmc_tpu_torch.DEMCZSettings(**kw),
                                 device="cpu")
    with pytest.raises(ValueError, match="single center point"):
        mcmc_tpu_torch.demcz(np.zeros((4, 2)), sq, device="cpu")
    with pytest.raises(TypeError):
        mcmc_tpu_torch.demcz(np.zeros(2), sq, mcmc_tpu_torch.DESettings(),
                             device="cpu")
    with pytest.raises(ValueError, match="n_runs"):
        mcmc_tpu_torch.demcz(np.zeros(2), sq, n_runs=0, device="cpu")
    with pytest.raises(ValueError, match="n_runs"):
        mcmc_tpu_torch.demcz(np.zeros(2), sq, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        mcmc_tpu_torch.demcz(np.zeros(2), sq, mesh=object(), n_runs=2,
                             device="cpu")
    small = mcmc_tpu_torch.DEMCZSettings(n_pop=4, n_burnin_draws=5,
                                         n_keep_draws=7)
    assert torch.equal(
        mcmc_tpu_torch.demcz(np.zeros(2), sq, small, key=2,
                             device="cpu").draws,
        mcmc_tpu_torch.demcz(np.zeros(2), sq, small, key=2, device="cpu",
                             checkpoint_dir=tmp_path / "ck",
                             checkpoint_every=3).draws)
