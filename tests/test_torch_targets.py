"""The PyTorch port's targets against ``mcmc_tpu.models``.

Each batched log-kernel of ``mcmc_tpu_torch.models.targets`` (the NUTS test
targets, the Poisson, Student-t and horseshoe regressions and the Poisson
latent GP's likelihood) and
``jax.vmap`` of its JAX counterpart get the same numpy parameters (and the
same numpy data); values and gradients (``integrators.grad_of`` against
``jax.grad``) agree at rtol 1e-6 in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_tpu import models as jmodels
from mcmc_tpu_torch import integrators as tint
from mcmc_tpu_torch import models as tmodels

N = 16
RTOL = 1e-6
_DATA = 2.0 + 2.0 * np.random.default_rng(11).standard_normal(200)


def _params(dim, seed, positive=()):
    """``(N, dim)`` float32 parameters from a numpy seed; the columns in
    ``positive`` are made positive (a scale parameter)."""
    x = np.random.default_rng(seed).standard_normal((N, dim))
    for k in positive:
        x[:, k] = 0.5 + np.abs(x[:, k])
    return x.astype(np.float32)


def _eight_schools(non_centered, tau_prior):
    # the schools' data passed to both packages as numpy constants
    y = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
    sigma = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])
    kw = dict(non_centered=non_centered, tau_prior=tau_prior)
    return (jmodels.eight_schools_model(y, sigma, **kw),
            tmodels.eight_schools_model(y, sigma, device="cpu", **kw), 10, ())


_RX = np.random.default_rng(12).standard_normal((40, 4)).astype(np.float32)
_RY_COUNT = np.random.default_rng(13).poisson(2.0, 40).astype(np.float32)
_RY = (_RX @ np.array([1.0, 0.0, -0.5, 0.0], np.float32)
       + np.random.default_rng(14).standard_t(4.0, 40)).astype(np.float32)
_GP_X = np.linspace(0.0, 2.0, 6).astype(np.float32)


def _regression(name, **kw):
    """One of the regressions on the same numpy data for both packages."""
    y = _RY_COUNT if name == "poisson_regression_model" else _RY
    return (getattr(jmodels, name)(jnp.asarray(_RX), jnp.asarray(y), **kw),
            getattr(tmodels, name)(_RX, y, device="cpu", **kw))


CASES = {
    "gaussian_mean_scale": lambda: (
        jmodels.gaussian_mean_scale_model(_DATA),
        tmodels.gaussian_mean_scale_model(_DATA, device="cpu"), 2, (1,)),
    "banana": lambda: (jmodels.banana_model(b=0.2, sigma=3.0),
                       tmodels.banana_model(b=0.2, sigma=3.0), 2, ()),
    **{f"eight_schools_{'non_centered' if nc else 'centered'}_{prior}":
       (lambda nc=nc, prior=prior: _eight_schools(nc, prior))
       for nc in (True, False) for prior in ("lognormal", "half_cauchy")},
    "poisson_regression": lambda: (
        *_regression("poisson_regression_model", prior_scale=3.0), 4, ()),
    "student_t_regression": lambda: (
        *_regression("student_t_regression_model", df=3.0, scale=0.7), 4,
        ()),
    "horseshoe_regression": lambda: (
        *_regression("horseshoe_regression_model", sigma=1.3,
                     tau_scale=0.5), 9, ()),
    "latent_gp_poisson": lambda: (
        jmodels.latent_gp_poisson_model(jnp.asarray(_GP_X), _RY_COUNT[:6],
                                        length_scale=0.4)[0],
        tmodels.latent_gp_poisson_model(_GP_X, _RY_COUNT[:6],
                                        length_scale=0.4, device="cpu")[0],
        6, ()),
}


@pytest.mark.parametrize("name", list(CASES))
def test_target_matches_jax(name):
    """Value and gradient of the batched log-kernel against JAX's, on the
    same parameters, at rtol 1e-6 (atol 1e-6 of the largest entry)."""
    jk, tk, dim, positive = CASES[name]()
    x = _params(dim, list(CASES).index(name), positive)
    want = np.asarray(jax.vmap(jk)(jnp.asarray(x)))
    want_grad = np.asarray(jax.vmap(jax.grad(jk))(jnp.asarray(x)))
    got = tk(torch.from_numpy(x))
    got_grad = tint.grad_of(tk)(torch.from_numpy(x))
    assert got.shape == (N,) and got_grad.shape == (N, dim)
    assert np.isfinite(want).all() and np.isfinite(want_grad).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
    np.testing.assert_allclose(got_grad.numpy(), want_grad, rtol=RTOL,
                               atol=RTOL * np.abs(want_grad).max())
    # a single (d,) vector gives a scalar
    assert tk(torch.from_numpy(x[0])).shape == ()


def test_eight_schools_defaults_are_the_published_data():
    """With no ``y`` / ``sigma`` both packages use Rubin's data: equal
    values on the same parameters."""
    x = _params(10, 3)
    for nc in (True, False):
        want = np.asarray(jax.vmap(jmodels.eight_schools_model(
            non_centered=nc))(jnp.asarray(x)))
        got = tmodels.eight_schools_model(non_centered=nc, device="cpu")(
            torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("kw", [dict(), dict(length_scale=0.4, amplitude=1.7,
                                             jitter=1e-3)])
def test_rbf_kernel_and_gp_posterior_match_jax(kw):
    """``rbf_kernel`` on 1-d and 2-d inputs, the Poisson latent GP's prior
    covariance, and ``gp_regression_exact_posterior``'s mean and
    covariance against the JAX package's on the same numpy data (rtol
    1e-6; the posterior's solves at atol 2e-5 of values of order 1)."""
    xs2 = np.stack([_GP_X, _GP_X[::-1] ** 2], axis=1)
    for xs in (_GP_X, xs2):
        want = np.asarray(jmodels.rbf_kernel(jnp.asarray(xs), **kw))
        got = tmodels.rbf_kernel(xs, device="cpu", **kw)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-7)
    _, K = tmodels.latent_gp_poisson_model(_GP_X, _RY_COUNT[:6],
                                           device="cpu", **kw)
    np.testing.assert_allclose(
        K.numpy(), np.asarray(jmodels.latent_gp_poisson_model(
            jnp.asarray(_GP_X), _RY_COUNT[:6], **kw)[1]), rtol=RTOL,
        atol=1e-7)
    y = np.sin(2.0 * _GP_X)
    jm, jP = jmodels.gp_regression_exact_posterior(
        jnp.asarray(K.numpy()), jnp.asarray(y, jnp.float32), 0.1)
    m, P = tmodels.gp_regression_exact_posterior(K, y, 0.1)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=2e-5)
    np.testing.assert_allclose(P.numpy(), np.asarray(jP), atol=2e-5)
