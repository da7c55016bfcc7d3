"""The PyTorch port's generated quantities, posterior predictive and
simulation-based calibration, on the CPU: port analogs of
``tests/test_predictive.py:29-70`` (the deterministic map against direct
evaluation and against JAX's ``generated_quantities`` on the same draws,
the predictive against the exact conjugate law, chunking, shapes, the key
check) and ``tests/test_sbc.py:31-49`` (a calibrated sampler gives uniform
ranks, a broken one is flagged, the protocol checks fire); SBC's chi-squared
statistics and p-values fed the same ranks as JAX's agree at rtol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmc_tpu
import mcmc_tpu_torch
from mcmc_tpu_torch import models


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for every test here: the tests run in several
    worker processes at once, and torch's default of a thread per core
    oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_X = 2.0 + np.random.default_rng(0).normal(size=100).astype(np.float32)


def _mu_draws():
    """RWMH draws of mu for the conjugate normal-mean model (prior N(1, 4),
    likelihood sd 1): posterior and predictive in closed form."""
    out = mcmc_tpu_torch.rwmh(
        torch.tensor([1.0]), models.gaussian_mean_model(_X, device="cpu"),
        mcmc_tpu_torch.RWMHSettings(n_burnin_draws=500, n_keep_draws=2000,
                                    par_scale=0.3), n_chains=8, key=1)
    n = _X.shape[0]
    return out, (_X.sum() + 0.25) / (n + 0.25), 1.0 / (n + 0.25)


def test_deterministic_mapping_matches_direct_and_jax():
    out, _, _ = _mu_draws()
    gq = mcmc_tpu_torch.generated_quantities(
        out, lambda p: {"mu2": p[:, 0] ** 2, "expmu": torch.exp(p)})
    assert gq["mu2"].shape == (2000, 8)
    assert gq["expmu"].shape == (2000, 8, 1)
    np.testing.assert_allclose(gq["mu2"].numpy(),
                               out.draws[..., 0].numpy() ** 2, rtol=1e-6)
    want = mcmc_tpu.generated_quantities(jnp.asarray(out.draws.numpy()),
                                         lambda p: jnp.exp(p))
    np.testing.assert_allclose(gq["expmu"].numpy(), np.asarray(want),
                               rtol=1e-6)


def test_posterior_predictive_matches_conjugate_law():
    """y_new | data ~ N(post_mean, post_var + 1)."""
    out, post_mean, post_var = _mu_draws()
    pp = mcmc_tpu_torch.posterior_predictive(
        out, lambda g, p: p[:, 0] + torch.randn(p.shape[0], generator=g),
        key=2)
    y = pp.reshape(-1).numpy()
    assert y.shape == (16000,)
    assert abs(y.mean() - post_mean) < 0.05
    assert abs(y.var() - (post_var + 1.0)) < 0.08


def test_batch_size_chunks():
    """Chunked (300 draws a chunk, a non-divisor) equals unchunked bit for
    bit for a deterministic map; a stochastic one repeats bit for bit under
    one seed and one ``batch_size`` and keeps its law."""
    out, post_mean, post_var = _mu_draws()
    fn = lambda p: torch.sin(p) * p + p ** 2
    a = mcmc_tpu_torch.generated_quantities(out, fn)
    b = mcmc_tpu_torch.generated_quantities(out, fn, batch_size=300)
    assert a.shape == (2000, 8, 1) and torch.equal(a, b)
    noisy = lambda g, p: p + torch.randn(p.shape[0], 3, generator=g)
    c = mcmc_tpu_torch.generated_quantities(out, noisy, key=3,
                                            batch_size=300)
    d = mcmc_tpu_torch.generated_quantities(out, noisy, key=3,
                                            batch_size=300)
    assert c.shape == (2000, 8, 3) and torch.equal(c, d)
    assert abs(float(c.mean()) - post_mean) < 0.05
    assert abs(float(c.var()) - (post_var + 1.0)) < 0.08


def test_plain_array_and_single_chain_shapes():
    draws = torch.linspace(0.0, 1.0, 50)[:, None]          # (n_keep, 1)
    gq = mcmc_tpu_torch.generated_quantities(draws, lambda p: 2.0 * p[:, 0])
    assert gq.shape == (50,)
    np.testing.assert_allclose(gq.numpy(), 2.0 * draws[:, 0].numpy(),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="key"):
        mcmc_tpu_torch.posterior_predictive(torch.zeros((10, 2)),
                                            lambda g, p: p, None)


# mu ~ N(1, 2^2), x_i ~ N(mu, 1): the conjugate generative model whose
# posterior gaussian_mean_model targets exactly
_PRIOR = lambda g: 1.0 + 2.0 * torch.randn((1,), generator=g)
_SIM = lambda g, th: th[0] + torch.randn((40,), generator=g)


def _rwmh_sampler(n_burnin, par_scale, start):
    def run(g, data):
        return mcmc_tpu_torch.rwmh(
            torch.tensor([start]), models.gaussian_mean_model(data),
            mcmc_tpu_torch.RWMHSettings(n_burnin_draws=n_burnin,
                                        n_keep_draws=256,
                                        par_scale=par_scale), key=g).draws
    return run


@pytest.mark.parametrize("calibrated", [True, False])
def test_sbc_flags_only_the_broken_sampler(calibrated):
    """A calibrated RWMH gives uniform ranks; no burn-in from a far start
    with a tiny proposal piles them at the edges."""
    sampler = (_rwmh_sampler(300, 0.4, 1.0) if calibrated
               else _rwmh_sampler(0, 0.02, 8.0))
    r = mcmc_tpu_torch.sbc(0, _PRIOR, _SIM, sampler, n_sims=60,
                           n_rank_draws=31, thin=8, n_bins=8, device="cpu")
    assert r["ranks"].shape == (60, 1)
    assert r["ranks"].min() >= 0 and r["ranks"].max() <= 31
    if calibrated:
        assert r["p_value"][0] > 0.01, (r["p_value"], r["chi2"])
    else:
        assert r["p_value"][0] < 1e-4, r["p_value"]


def test_sbc_protocol_validation():
    good = _rwmh_sampler(10, 0.4, 1.0)
    with pytest.raises(ValueError, match="n_bins"):
        mcmc_tpu_torch.sbc(0, _PRIOR, _SIM, good, n_sims=2, n_rank_draws=31,
                           n_bins=7, device="cpu")
    with pytest.raises(ValueError, match="need n_rank_draws"):
        mcmc_tpu_torch.sbc(0, _PRIOR, _SIM, good, n_sims=1, n_rank_draws=31,
                           thin=32, n_bins=8, device="cpu")


def test_sbc_statistics_match_jax_on_the_same_ranks():
    """Both harnesses fed one table of ranks (a posterior whose draws put
    exactly the tabled number below the true 0): the same ranks, chi2 and
    p-values at rtol 1e-6."""
    L, n_sims = 31, 48
    table = np.random.default_rng(6).integers(0, L + 1, size=(n_sims, 3))
    table[:, 2] = np.minimum(table[:, 2], 12)       # a miscalibrated column

    def harness(zeros, below):
        i = [0]

        def posterior(_key, _data):
            r = table[i[0]]
            i[0] += 1
            return below(np.where(np.arange(L)[:, None] < r[None, :], -1.0,
                                  1.0).astype(np.float32))
        return zeros, lambda _k, th: th, posterior

    want = mcmc_tpu.sbc(jax.random.PRNGKey(0),
                        *harness(lambda _k: jnp.zeros(3), jnp.asarray),
                        n_sims=n_sims, n_rank_draws=L, n_bins=8)
    got = mcmc_tpu_torch.sbc(0, *harness(lambda _g: torch.zeros(3),
                                         torch.tensor),
                             n_sims=n_sims, n_rank_draws=L, n_bins=8,
                             device="cpu")
    np.testing.assert_array_equal(got["ranks"], table)
    np.testing.assert_array_equal(np.asarray(want["ranks"]), table)
    np.testing.assert_allclose(got["chi2"], want["chi2"], rtol=1e-6)
    np.testing.assert_allclose(got["p_value"], want["p_value"], rtol=1e-6)
    assert got["p_value"][2] < 1e-4
