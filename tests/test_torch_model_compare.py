"""The PyTorch port's WAIC, PSIS-LOO and model comparison against the JAX
package's, on the CPU, fed the same seeded log-likelihood arrays: the GPD
fit, the smoothed weights, ``psis_loo`` (elpd, p_loo, se, every Pareto k),
``waic`` and ``compare`` at rtol 1e-5, and the error cases of
``tests/test_model_compare.py:118``, ``:123`` and ``:142``. A GPD shape k
(the fit's and every Pareto k) is also allowed ``K_ATOL`` absolute: it is a
mean of thousands of O(1) logarithms, summed in float32 in another order by
each package, and sits near 0 for well-behaved observations, where a
relative tolerance means nothing (measured up to 7.7e-6)."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_tpu import model_compare as jmc
from mcmc_tpu_torch import model_compare as tmc

RTOL = 1e-5
K_ATOL = 2e-5

# the JAX side jitted: its eager, vmapped PSIS compiles each small op
# (about 6 s a shape), the jitted one about 1 s
_jloo = jax.jit(jmc.psis_loo)
_jwaic = jax.jit(jmc.waic)
_jgpd = jax.jit(jmc.gpd_fit)


def _norm_logpdf(y, mu, var):
    return -0.5 * (np.log(2 * np.pi * var) + (y - mu) ** 2 / var)


def _conjugate_ll(seed, n_obs=30, S=8000, outlier=None):
    """y_i ~ N(theta, 1), theta ~ N(0, 100): exact posterior draws and
    their pointwise log-likelihood ``(S, n_obs)`` (float32)."""
    rng = np.random.default_rng(seed)
    y = 1.3 + rng.standard_normal(n_obs)
    if outlier is not None:
        y[outlier] = 9.0
    prec = 1.0 / 100.0 + n_obs
    draws = y.sum() / prec + math.sqrt(1.0 / prec) * rng.standard_normal(S)
    return y, _norm_logpdf(y[None, :], draws[:, None], 1.0).astype(
        np.float32)


def _degenerate_ll():
    """The degenerate tails of ``tests/test_model_compare.py``: a tied
    block across the cutoff, one dominating draw, an exactly flat column."""
    rng = np.random.default_rng(0)
    S = 1000
    tied = np.concatenate([rng.normal(-3.0, 0.1, S - 200), np.zeros(200)])
    dominated = rng.normal(0.0, 0.1, S)
    dominated[0] = -200.0
    flat = np.full(S, -1.0)
    return np.stack([tied, dominated, flat], axis=1).astype(np.float32)


def _close(got, want, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=atol)


@pytest.mark.parametrize("k_true,sig_true", [(0.3, 1.0), (0.1, 2.0),
                                             (0.7, 0.5)])
def test_gpd_fit_matches_jax(k_true, sig_true):
    """Both fits on the same sorted GPD exceedances; the port's batched fit
    of the three rows at once gives each row's own fit."""
    rng = np.random.default_rng(3)
    xs = np.sort(sig_true / k_true * ((1 - rng.uniform(size=(3, 4000)))
                                      ** (-k_true) - 1.0), axis=1)
    xs = xs.astype(np.float32)
    k_t, s_t = tmc.gpd_fit(torch.tensor(xs))
    for i in range(3):
        k_j, s_j = _jgpd(jnp.asarray(xs[i]))
        _close(k_t[i], k_j, atol=K_ATOL)
        _close(s_t[i], s_j)
    assert float(k_t[0]) == pytest.approx(k_true, abs=0.08)


@pytest.mark.parametrize("column", [0, 7])
def test_smoothed_weights_match_jax(column):
    """One observation's Pareto-smoothed log weights and shape, JAX's
    ``_psis_smooth_one`` against the port's (column 7 is an outlier)."""
    _, ll = _conjugate_ll(5, n_obs=20, S=6000, outlier=7)
    lw = -ll[:, column]
    M = int(min(0.2 * 6000, 3.0 * math.sqrt(6000)))
    w_j, k_j = jax.jit(functools.partial(jmc._psis_smooth_one, M=M))(
        jnp.asarray(lw))
    w_t, k_t = tmc._psis_smooth_one(torch.tensor(lw), M)
    _close(w_t, w_j)
    _close(k_t, k_j, atol=K_ATOL)


@pytest.mark.parametrize("case", ["conjugate", "outlier", "degenerate"])
def test_psis_loo_and_waic_match_jax(case):
    if case == "degenerate":
        ll = _degenerate_ll()
    else:
        _, ll = _conjugate_ll(0 if case == "conjugate" else 5, n_obs=20,
                              S=6000, outlier=7 if case == "outlier" else None)
    want = _jloo(jnp.asarray(ll))
    got = tmc.psis_loo(torch.tensor(ll))
    for key in ("elpd", "p_eff", "se", "pointwise"):
        _close(got[key], want[key])
    k_j, k_t = np.asarray(want["pareto_k"]), got["pareto_k"].numpy()
    assert np.array_equal(np.isinf(k_j), np.isinf(k_t))
    fin = np.isfinite(k_j)
    _close(k_t[fin], k_j[fin], atol=K_ATOL)
    if case == "degenerate":
        assert k_t[1] == np.inf and k_t[2] == 0.0
    if case == "outlier":
        assert int(k_t.argmax()) == 7
    # the (n_draws, n_chains, n_obs) layout gives the same answer
    got3 = tmc.psis_loo(torch.tensor(ll).reshape(-1, 4, ll.shape[1]))
    _close(got3["elpd"], got["elpd"])
    for key in ("elpd", "p_eff", "se", "pointwise"):
        _close(tmc.waic(torch.tensor(ll))[key],
               _jwaic(jnp.asarray(ll))[key])


def test_compare_matches_jax():
    y, ll_a = _conjugate_ll(2, n_obs=20, S=6000)
    ll_b = np.broadcast_to(_norm_logpdf(y, -2.0, 1.0).astype(np.float32),
                           ll_a.shape)
    ll_c = np.broadcast_to(_norm_logpdf(y, 1.0, 1.5).astype(np.float32),
                           ll_a.shape)
    want = jmc.compare({"good": _jloo(jnp.asarray(ll_a)),
                        "bad": _jwaic(jnp.asarray(ll_b)),
                        "wide": _jwaic(jnp.asarray(ll_c))})
    got = tmc.compare({"good": tmc.psis_loo(torch.tensor(ll_a)),
                       "bad": tmc.waic(torch.tensor(np.array(ll_b))),
                       "wide": tmc.waic(torch.tensor(np.array(ll_c)))})
    assert [r["name"] for r in got] == [r["name"] for r in want] \
        == ["good", "wide", "bad"]
    for g, w in zip(got, want):
        assert g["rank"] == w["rank"]
        # the best model's elpd_diff is 0: 1e-4 absolute beside rtol on
        # sums of O(10) pointwise terms
        for key in ("elpd", "se", "elpd_diff", "se_diff"):
            _close(g[key], w[key], atol=1e-4)
    assert got[0]["elpd_diff"] == 0.0
    assert got[2]["elpd_diff"] > 2.0 * got[2]["se_diff"] > 0.0


def test_error_cases():
    _, ll = _conjugate_ll(0)
    ll = torch.tensor(ll)
    with pytest.raises(ValueError, match="at least two"):
        tmc.compare({"only": tmc.waic(ll)})
    with pytest.raises(ValueError, match="same data"):
        tmc.compare({"a": tmc.waic(ll), "b": {"pointwise": torch.zeros(7)}})
    with pytest.raises(ValueError, match="more draws"):
        tmc.psis_loo(torch.zeros((20, 4)))
    with pytest.raises(ValueError, match="2-D or 3-D"):
        tmc.pointwise_log_lik(torch.zeros(4), lambda th: th)


def test_pointwise_log_lik_layouts_match_jax():
    """The batched ``log_lik_fn`` over ``(n, d)`` and ``(n, c, d)`` draws
    gives JAX's ``vmap`` of the per-draw function."""
    obs = np.array([0.3, -0.4, 1.0], np.float32)
    draws = np.linspace(-1, 1, 12, dtype=np.float32).reshape(6, 2)
    jfn = lambda th: -0.5 * (jnp.asarray(obs) - th.sum()) ** 2
    tfn = lambda th: -0.5 * (torch.tensor(obs) - th.sum(-1)[:, None]) ** 2
    want = jmc.pointwise_log_lik(jnp.asarray(draws), jfn)
    got = tmc.pointwise_log_lik(torch.tensor(draws), tfn)
    _close(got, want)
    got3 = tmc.pointwise_log_lik(torch.tensor(draws).reshape(3, 2, 2), tfn)
    assert got3.shape == (3, 2, 3)
    _close(got3.reshape(6, 3), want)
