"""The PyTorch port's elliptical slice sampler against the JAX package's,
on the CPU.

The draw is held exactly: JAX's step under ``jax.vmap`` and the port's
transition fed the random numbers JAX's step takes from its keys: the
prior's normals, the slice level's and the first angle's uniforms and the
uniforms of the shrinkage loop's key chain, one split an iteration, as many
as the cap. The cases: GP regression on an RBF prior, the Poisson latent GP
(``latent_gp_poisson_model``), a diagonal prior with a mean, the identity
prior with a mean, and a shrinkage cap of 3 (capped draws stay in place).
Every state field at rtol 1e-5, and the accept decisions and each chain's
``shrink_steps`` exactly. The anchors are the exact conjugate moments of
``tests/test_elliptical.py`` and ``tests/test_models_zoo.py`` at smaller
sizes.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import mcmc_tpu_torch
from mcmc_tpu import models as jmodels
from mcmc_tpu.samplers import common as jcommon
from mcmc_tpu_torch import convert
from mcmc_tpu_torch import models as tmodels
from mcmc_tpu_torch.samplers import common as tcommon
from test_torch_chees import as_tensors, assert_close, jax_run, start


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for every test here: the tests run in several
    worker processes at once, and torch's default of a thread per core
    oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


jell = importlib.import_module("mcmc_tpu.samplers.ellipse")
tell = importlib.import_module("mcmc_tpu_torch.samplers.ellipse")

D, C, N_TRANS = 8, 32, 40
_XS = np.linspace(0.0, 3.0, D).astype(np.float32)
_Y = np.sin(2.0 * _XS).astype(np.float32)
_COUNTS = np.random.default_rng(7).poisson(
    np.exp(np.sin(3.0 * _XS) + 1.0)).astype(np.float32)
_DIAG = np.linspace(0.5, 3.0, D).astype(np.float32)
_MEAN = np.linspace(-1.0, 1.0, D).astype(np.float32)

# likelihood, prior covariance, prior mean, max_shrink_steps
CASES = {"gp_regression": ("gauss", "rbf", None, 64),
         "poisson_gp": ("poisson", "rbf", None, 64),
         "diag_with_mean": ("gauss", "diag", "mean", 64),
         "identity_with_mean": ("gauss", None, "mean", 64),
         "capped": ("gauss", "rbf", None, 3)}
_RUNS = {}


def ellipse_draws(d, max_steps):
    """The random numbers of JAX's elliptical slice draw, from its key
    (``mcmc_tpu/samplers/ellipse.py``'s ``step``)."""
    def draws(key):
        k_nu, k_u, k_t, k_loop = jax.random.split(key, 4)

        def body(kk, _):
            kk, sub = jax.random.split(kk)
            return kk, jax.random.uniform(sub, dtype=jnp.float32)

        _, us = lax.scan(body, k_loop, None, length=max_steps)
        return (jax.random.normal(k_nu, (d,), jnp.float32),
                jax.random.uniform(k_u, dtype=jnp.float32),
                jax.random.uniform(k_t, dtype=jnp.float32), us)
    return draws


def _pair(name):
    """JAX's single-chain and the port's batched likelihood, the prior's
    covariance (numpy) and mean (numpy or None)."""
    lik, cov, mean, _ = CASES[name]
    if lik == "poisson":
        jl, jK = jmodels.latent_gp_poisson_model(jnp.asarray(_XS), _COUNTS,
                                                 length_scale=0.5)
        tl, _ = tmodels.latent_gp_poisson_model(_XS, _COUNTS,
                                                length_scale=0.5,
                                                device="cpu")
    else:
        yj, yt = jnp.asarray(_Y), torch.from_numpy(_Y)
        jl = lambda f: -0.5 * jnp.sum((yj - f) ** 2) / 0.25
        tl = lambda f: -0.5 * ((yt - f) ** 2).sum(-1) / 0.25
    K = {"rbf": np.array(jmodels.rbf_kernel(jnp.asarray(_XS), 0.7)),
         "diag": _DIAG, None: None}[cov]
    return jl, tl, K, (_MEAN if mean else None)


def _case(name):
    jl, tl, K, m = _pair(name)
    msh = CASES[name][3]
    x0 = start(4, C, D, 0.5)
    tprob = tcommon.setup_problem(torch.from_numpy(x0), tl,
                                  mcmc_tpu_torch.AlgoSettings(), None)
    tspd = tcommon.make_spd(K, D, torch.float32, "cpu")
    tmu = torch.zeros(D) if m is None else torch.from_numpy(m)
    if name not in _RUNS:
        jspd = jcommon.make_spd(None if K is None else jnp.asarray(K), D,
                                jnp.float32)
        jmu = jnp.zeros(D) if m is None else jnp.asarray(m)
        jinit, jstep = jell.build_elliptical_kernel(jl, jmu, jspd, D,
                                                    jnp.float32, msh)
        st0 = jax.vmap(jinit)(jnp.asarray(x0))
        _RUNS[name] = jax_run(jstep, ellipse_draws(D, msh), st0, N_TRANS, 9)
    tinit, tstep = tell.build_elliptical_kernel(tl, tmu, tspd, msh)
    return tprob, tinit, tstep, _RUNS[name]


@pytest.mark.parametrize("name", list(CASES))
def test_elliptical_draw_matches_jax(name):
    """Each of JAX's 40 draws from JAX's state before it, fed its random
    numbers: every state field at rtol 1e-5, the accept decisions and each
    chain's ``shrink_steps`` exactly; the port's ``init`` gives JAX's first
    state. Every draw moves but in the capped case, where some stay."""
    tprob, tinit, tstep, (states, infos, draws) = _case(name)
    with torch.no_grad():
        assert_close(tinit(tprob.first_draw), states[0], what="init")
        for t, d in enumerate(draws):
            new, info = tstep.transition(
                convert.elliptical_state(states[t], "cpu"), *as_tensors(d))
            assert_close(new, states[t + 1], what=f"state after {t}")
            for k in ("accepted", "shrink_steps"):
                np.testing.assert_array_equal(info[k].numpy(), infos[t][k],
                                              err_msg=f"{k} of {t}")
    acc = np.mean([i["accepted"].mean() for i in infos])
    if name == "capped":
        assert 0.1 < acc < 0.95, acc
    else:
        assert acc == 1.0, acc


@pytest.mark.parametrize("name", list(CASES))
def test_elliptical_run_fed_jax_draws(name):
    """The port's 40 draws from JAX's start, fed JAX's random numbers: the
    same accept decisions and ``shrink_steps`` at every draw, the final
    state within 1e-4; one batched likelihood evaluation per shrink step,
    and one host synchronisation per step short of the cap."""
    _, _, tstep, (states, infos, draws) = _case(name)
    st = convert.elliptical_state(states[0], "cpu")
    evals = 0
    with torch.no_grad():
        for t, d in enumerate(draws):
            st, info = tstep.transition(st, *as_tensors(d))
            for k in ("accepted", "shrink_steps"):
                np.testing.assert_array_equal(info[k].numpy(), infos[t][k],
                                              err_msg=f"{k} of {t}")
            evals += int(info["shrink_steps"].max())
    assert_close(st, states[-1], 1e-4, "final state")
    c = tstep.counts
    assert c["draws"] == N_TRANS and c["evaluations"] == evals
    assert c["syncs"] == evals - sum(int(i["shrink_steps"].max())
                                     == CASES[name][3] for i in infos)


def _conjugate_posterior(Sigma0, Sigma_l, y):
    P = np.linalg.inv(np.linalg.inv(Sigma0) + np.linalg.inv(Sigma_l))
    return P @ (np.linalg.inv(Sigma_l) @ y), P


def test_correlated_conjugate_posterior_exact_moments():
    """``tests/test_elliptical.py::test_correlated_conjugate_posterior_exact
    _moments`` at a smaller size: a 2-d correlated prior and Gaussian
    likelihood; mean and covariance at the closed form."""
    Sigma0 = np.array([[2.0, 1.4], [1.4, 1.5]])
    Sigma_l = np.array([[0.5, 0.0], [0.0, 1.0]])
    y = np.array([1.0, -0.5])
    m_exact, P_exact = _conjugate_posterior(Sigma0, Sigma_l, y)
    Sl_inv = torch.tensor(np.linalg.inv(Sigma_l), dtype=torch.float32)
    yt = torch.tensor(y, dtype=torch.float32)

    def log_lik(x):
        r = x - yt
        return -0.5 * ((r @ Sl_inv) * r).sum(-1)

    out = mcmc_tpu_torch.elliptical_slice(
        np.zeros(2), log_lik, mcmc_tpu_torch.EllipticalSettings(
            n_burnin_draws=200, n_keep_draws=1000),
        prior_cov=Sigma0, n_chains=32, key=0, device="cpu")
    d = out.draws.reshape(-1, 2).double().numpy()
    assert float(out.accept_rate.mean()) == 1.0
    assert np.allclose(d.mean(0), m_exact, atol=0.05)
    assert np.allclose(np.cov(d.T), P_exact, atol=0.06)
    assert 1.0 <= float(out.diagnostics["mean_shrink_steps"].mean()) <= 10.0


def test_gp_regression_exact_posterior_anchors_elliptical():
    """``tests/test_models_zoo.py::test_gp_regression_exact_posterior_
    anchors_elliptical`` at a smaller size: the latent field's mean and
    pointwise variance at ``gp_regression_exact_posterior``'s closed form,
    which the port computes as the JAX package does."""
    xs = np.linspace(0.0, 3.0, 12)
    K = tmodels.rbf_kernel(xs, length_scale=0.7, device="cpu")
    np.testing.assert_allclose(
        K.numpy(), np.asarray(jmodels.rbf_kernel(jnp.asarray(xs, jnp.float32),
                                                 length_scale=0.7)),
        rtol=1e-6, atol=1e-7)
    y = np.sin(2.0 * xs)
    m_exact, P_exact = tmodels.gp_regression_exact_posterior(K, y, 0.05)
    jm, jP = jmodels.gp_regression_exact_posterior(
        jnp.asarray(K.numpy()), jnp.asarray(y, jnp.float32), 0.05)
    np.testing.assert_allclose(m_exact.numpy(), np.asarray(jm), atol=2e-4)
    np.testing.assert_allclose(P_exact.numpy(), np.asarray(jP), atol=2e-4)
    yt = torch.tensor(y, dtype=torch.float32)
    out = mcmc_tpu_torch.elliptical_slice(
        np.zeros(12), lambda f: -0.5 * ((yt - f) ** 2).sum(-1) / 0.05,
        mcmc_tpu_torch.EllipticalSettings(n_burnin_draws=300,
                                          n_keep_draws=1200),
        prior_cov=K, n_chains=16, key=6, device="cpu")
    d = out.draws.reshape(-1, 12)
    assert float((d.mean(0) - m_exact).abs().max()) < 0.04
    np.testing.assert_allclose(d.var(0).numpy(), np.diag(P_exact.numpy()),
                               atol=0.012)


def test_validation_and_impossible_likelihood():
    """Bounds and a cap below 1 are refused as in JAX; a likelihood that is
    -inf off the start caps out in place."""
    with pytest.raises(ValueError, match="vals_bound"):
        mcmc_tpu_torch.elliptical_slice(
            np.zeros(2), lambda f: -(f * f).sum(-1),
            mcmc_tpu_torch.AlgoSettings(vals_bound=True), device="cpu")
    with pytest.raises(ValueError, match="max_shrink_steps"):
        mcmc_tpu_torch.elliptical_slice(
            np.zeros(2), lambda f: -(f * f).sum(-1),
            mcmc_tpu_torch.EllipticalSettings(max_shrink_steps=0),
            device="cpu")
    spike = lambda f: torch.where((f == 0).all(-1), 0.0, -torch.inf)
    out = mcmc_tpu_torch.elliptical_slice(
        np.zeros(2, np.float32), spike, mcmc_tpu_torch.EllipticalSettings(
            n_burnin_draws=2, n_keep_draws=4, max_shrink_steps=5),
        n_chains=3, key=1, device="cpu")
    assert float(out.accept_rate.max()) == 0.0
    assert bool((out.draws == 0).all())
    assert float(out.diagnostics["mean_shrink_steps"].min()) == 5.0
