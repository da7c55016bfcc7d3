"""The PyTorch port's stretch-move ensemble sampler against the JAX
package's, on the CPU.

A sweep is held exactly: JAX's sweep, and the port's fed the partner
integers, stretch uniforms and accept uniforms each of JAX's two
half-updates draws from its key, on a correlated Gaussian and on a bounded
target (the box kernel on the unconstrained space). Every state field at
rtol 1e-5 and both halves' accept decisions exactly, one sweep at a time and
over the port's own run. The rest is distributional, on the cases of
``tests/test_stretch.py`` at smaller sizes.
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
from mcmc_tpu.samplers import common as jcommon
from mcmc_tpu_torch import convert
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


jst = importlib.import_module("mcmc_tpu.samplers.stretch")
tst = importlib.import_module("mcmc_tpu_torch.samplers.stretch")

N_W, D, N_SWEEPS = 24, 3, 25
_COV = np.array([[1.0, 0.9, 0.3], [0.9, 1.0, 0.2], [0.3, 0.2, 0.5]],
                np.float32)
_PREC = np.linalg.inv(_COV).astype(np.float32)
CASES = ("correlated", "bounded")
_RUNS = {}


def _targets(name):
    jP, tP = jnp.asarray(_PREC), torch.tensor(_PREC)
    jlk = lambda v: -0.5 * v @ jP @ v
    tlk = lambda v: -0.5 * ((v @ tP) * v).sum(-1)
    kw = dict(vals_bound=True, lower_bounds=np.array([-1.0, 0.0, -np.inf]),
              upper_bounds=np.array([2.0, np.inf, np.inf])) \
        if name == "bounded" else {}
    return jlk, tlk, kw


def _jax_draws(key):
    """The random numbers JAX's sweep takes from ``key``: per half, the
    partners, the stretch uniforms and the accept uniforms."""
    out = []
    for k in jax.random.split(key):
        k_j, k_z, k_u = jax.random.split(k, 3)
        h = N_W // 2
        out += [jax.random.randint(k_j, (h,), 0, N_W - h),
                jax.random.uniform(k_z, (h,), jnp.float32),
                jax.random.uniform(k_u, (h,), jnp.float32)]
    return tuple(out)


def _stretch_case(name):
    """JAX's ``N_SWEEPS`` sweeps of the case (cached) with the draws they
    take, and the port's sweep."""
    jlk, tlk, kw = _targets(name)
    tprob = tcommon.setup_problem(torch.zeros(D), tlk,
                                  mcmc_tpu_torch.AlgoSettings(**kw), None)
    s = dict(n_walkers=N_W, par_a=2.0)
    tsweep = tst.build_stretch_sweep(tprob.box_log_kernel,
                                     mcmc_tpu_torch.StretchSettings(**s), D)
    if name not in _RUNS:
        jprob = jcommon.setup_problem(jnp.full(D, 0.5), jlk,
                                      mcmc_tpu.AlgoSettings(**kw), None)
        X0 = jprob.first_draw[0] + 0.7 * np.random.default_rng(3) \
            .standard_normal((N_W, D)).astype(np.float32)
        kv0 = jax.vmap(jprob.box_log_kernel)(X0)
        st = jst.StretchState(X=X0, kernel_vals=jnp.where(
            jnp.isfinite(kv0), kv0, -jnp.inf))
        sweep = jax.jit(jst.build_stretch_sweep(
            jprob.box_log_kernel, mcmc_tpu.StretchSettings(**s), D))
        draws_of = jax.jit(_jax_draws)
        as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
        states, infos, draws = [as_np(st)], [], []
        for k in jax.random.split(jax.random.PRNGKey(17), N_SWEEPS):
            draws.append(as_np(draws_of(k)))
            st, info = sweep(k, st)
            states.append(as_np(st))
            infos.append(as_np(info))
        _RUNS[name] = (states, infos, draws)
    return tsweep, _RUNS[name]


@pytest.mark.parametrize("name", CASES)
def test_stretch_sweep_matches_jax(name):
    """Each of JAX's sweeps from JAX's state before it, fed its draws: the
    ensemble and kernel values at rtol 1e-5, both halves' accept decisions
    exactly (some accepted and some rejected in each half)."""
    tsweep, (states, infos, draws) = _stretch_case(name)
    with torch.no_grad():
        for t, d in enumerate(draws):
            new, info = tsweep.transition(
                convert.stretch_state(states[t], "cpu"), *as_tensors(d))
            assert_state(new, states[t + 1], what=f"state after {t}")
            np.testing.assert_array_equal(info["accepted"].numpy(),
                                          infos[t]["accepted"])
    acc = np.stack([i["accepted"] for i in infos])
    h = N_W // 2
    for half in (acc[:, :h], acc[:, h:]):
        assert 0.1 < half.mean() < 0.9, half.mean()


# Nothing adapts, but a proposal is a partner plus z times a difference of
# walkers, so rounding spreads through the ensemble: over 25 sweeps the
# ensemble and kernel values stay within 1.4e-6 of their scale (measured);
# held at 1e-5.
RUN_RTOL = 1e-5


@pytest.mark.parametrize("name", CASES)
def test_stretch_run_fed_jax_draws(name):
    """The port's own run of the case from JAX's start, fed JAX's draws:
    the same accept decisions at every sweep and the final ensemble within
    ``RUN_RTOL``; no host synchronisation."""
    tsweep, (states, infos, draws) = _stretch_case(name)
    st = convert.stretch_state(states[0], "cpu")
    with torch.no_grad():
        for t, d in enumerate(draws):
            st, info = tsweep.transition(st, *as_tensors(d))
            np.testing.assert_array_equal(info["accepted"].numpy(),
                                          infos[t]["accepted"],
                                          err_msg=f"{name} sweep {t}")
    assert_state(st, states[-1], RUN_RTOL, what=f"{name} final")
    assert tsweep.counts == {"sweeps": N_SWEEPS, "syncs": 0}


@pytest.mark.parametrize("name", CASES)
def test_convert_round_trip(name):
    """``convert.stretch_state`` carries the case's ensemble from JAX
    across: the ensemble, and the kernel values as the port's box kernel
    gives them."""
    _, tlk, kw = _targets(name)
    tprob = tcommon.setup_problem(torch.zeros(D), tlk,
                                  mcmc_tpu_torch.AlgoSettings(**kw), None)
    _, (states, _, _) = _stretch_case(name)
    got = convert.stretch_state(states[0], "cpu")
    np.testing.assert_array_equal(got.X.numpy(), states[0].X)
    torch.testing.assert_close(got.kernel_vals,
                               tprob.box_log_kernel(got.X))


def test_z_distribution_and_partnering():
    """tests/test_stretch.py's unit checks on the port: z follows g(z) ∝
    1/sqrt(z) on [1/a, a] (its CDF within 5e-3 at three points over the
    port's draws), and with one half frozen at a far point every accepted
    move of the other lies on the line through it."""
    s = mcmc_tpu_torch.StretchSettings(n_walkers=8, par_a=2.0)
    sweep = tst.build_stretch_sweep(lambda v: torch.zeros(v.shape[0]), s, 2)
    gen = torch.Generator().manual_seed(0)
    X = torch.cat([torch.tensor([[0.0, 1.0], [1.0, 0.0], [1.0, 1.0],
                                 [-1.0, 0.5]]), torch.full((4, 2), 100.0)])
    state = tst.StretchState(X=X, kernel_vals=torch.zeros(8))
    us = []
    for _ in range(4000):
        d = sweep.draw(gen, state)
        us.append(torch.cat([d[1], d[4]]))
    u = torch.cat(us).numpy()
    z = ((2.0 - 1.0) * u + 1.0) ** 2 / 2.0
    assert z.min() >= 0.5 - 1e-6 and z.max() <= 2.0 + 1e-6
    for t in (0.6, 1.0, 1.5):
        np.testing.assert_allclose((z <= t).mean(), np.sqrt(2 * t) - 1.0,
                                   atol=5e-3)
    new, info = sweep(gen, state)
    moved, old = new.X[:4].numpy(), X[:4].numpy()
    acc = info["accepted"][:4].numpy()
    assert acc.any()
    for i in np.flatnonzero(acc):
        v1, v2 = moved[i] - 100.0, old[i] - 100.0
        cross = v1[0] * v2[1] - v1[1] * v2[0]
        assert abs(cross) < 1e-2 * np.linalg.norm(v1) * np.linalg.norm(v2)


def test_stretch_gaussian_mean_and_correlated_moments():
    """tests/test_stretch.py's moment anchors at 64 walkers: the conjugate
    Gaussian-mean posterior's mean within 5 standard errors of 50 effective
    draws and acceptance in (0.3, 0.95); a rho = 0.8 Gaussian's covariance
    within 0.15 over 1,500 kept sweeps."""
    x = (2.0 + np.random.default_rng(1).standard_normal(100)).astype(
        np.float32)
    s = mcmc_tpu_torch.StretchSettings(n_walkers=64, n_burnin_draws=300,
                                       n_keep_draws=600)
    out = mcmc_tpu_torch.stretch(np.array([1.0]), tmodels.gaussian_mean_model(
        x, device="cpu"), s, key=2, device="cpu")
    assert out.draws.shape == (600, 64, 1)
    post_prec = 100 / 1.0 + 1 / 4.0
    post_mean = (x.sum() + 1.0 / 4.0) / post_prec
    se = np.sqrt(1.0 / post_prec)
    assert abs(float(out.draws.mean()) - post_mean) < 5 * se / np.sqrt(50)
    assert 0.3 < float(out.diagnostics["accept_rate_per_walker"].mean()) \
        < 0.95
    prec = torch.tensor(np.linalg.inv([[1.0, 0.8], [0.8, 1.0]]),
                        dtype=torch.float32)
    s = mcmc_tpu_torch.StretchSettings(n_walkers=64, n_burnin_draws=300,
                                       n_keep_draws=1500)
    out = mcmc_tpu_torch.stretch(np.zeros(2), lambda v: -0.5 * (
        (v @ prec) * v).sum(-1), s, key=3, device="cpu")
    emp = np.cov(out.draws.reshape(-1, 2).numpy().T)
    np.testing.assert_allclose(emp, [[1.0, 0.8], [0.8, 1.0]], atol=0.15)


def test_stretch_affine_equivariance_exact():
    """``test_affine_equivariance_exact`` on the port: an axis-scaled
    Gaussian (scale a power of two) with the mapped initial spread gives
    exactly the scaled draws of the isotropic run under one seed."""
    scale = torch.tensor([1.0, 8.0])
    kw = dict(n_walkers=16, n_burnin_draws=50, n_keep_draws=100)
    iso = mcmc_tpu_torch.stretch(
        np.zeros(2), lambda v: -0.5 * (v * v).sum(-1),
        mcmc_tpu_torch.StretchSettings(init_spread=0.5, **kw), key=7,
        device="cpu")
    aniso = mcmc_tpu_torch.stretch(
        np.zeros(2), lambda v: -0.5 * ((v / scale) ** 2).sum(-1),
        mcmc_tpu_torch.StretchSettings(init_spread=(0.5 * scale).numpy(),
                                       **kw), key=7, device="cpu")
    assert torch.equal(aniso.draws, iso.draws * scale)
    assert int(iso.n_accept_draws) == int(aniso.n_accept_draws)


def test_stretch_bounded_thin_resume_and_refusals(tmp_path):
    """``test_bounded_draws_inside`` (draws inside (0, 1), mean in (0.2,
    0.45)); ``thin=2`` with a warm ``resume``; the walker-count, ``par_a``
    and dimension refusals of ``test_validation_errors``, a batched start,
    and a non-mesh ``mesh``; ``checkpoint_dir=`` gives the in-memory
    run's draws."""
    algo = mcmc_tpu_torch.AlgoSettings(
        vals_bound=True, lower_bounds=np.array([0.0]),
        upper_bounds=np.array([1.0]),
        stretch_settings=mcmc_tpu_torch.StretchSettings(
            n_walkers=32, n_burnin_draws=200, n_keep_draws=300))
    out = mcmc_tpu_torch.stretch(np.array([0.5]),
                                 lambda v: -8.0 * (v[:, 0] - 0.3) ** 2, algo,
                                 device="cpu", thin=2, return_resume=True)
    d = out.draws.numpy()
    assert (d > 0.0).all() and (d < 1.0).all() and 0.2 < d.mean() < 0.45
    assert out.diagnostics["thin"] == 2
    assert out.diagnostics["resume"](3, 20).draws.shape == (20, 32, 1)
    lk = lambda v: -0.5 * (v ** 2).sum(-1)
    for kw, msg in ((dict(n_walkers=7), "even"), (dict(n_walkers=2), "even"),
                    (dict(par_a=1.0), "par_a"),
                    (dict(n_walkers=4), "twice as many")):
        with pytest.raises(ValueError, match=msg):
            mcmc_tpu_torch.stretch(np.zeros(3), lk,
                                   mcmc_tpu_torch.StretchSettings(**kw),
                                   device="cpu")
    with pytest.raises(ValueError, match="n_walkers"):
        mcmc_tpu_torch.stretch(np.zeros((4, 2)), lk, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        mcmc_tpu_torch.stretch(np.zeros(2), lk, mesh=object(), device="cpu")
    small = mcmc_tpu_torch.StretchSettings(n_walkers=8, n_burnin_draws=5,
                                           n_keep_draws=6)
    assert torch.equal(
        mcmc_tpu_torch.stretch(np.zeros(2), lk, small, key=3,
                               device="cpu").draws,
        mcmc_tpu_torch.stretch(np.zeros(2), lk, small, key=3, device="cpu",
                               checkpoint_dir=tmp_path / "ck",
                               checkpoint_every=4).draws)
