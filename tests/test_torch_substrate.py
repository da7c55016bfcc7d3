"""The PyTorch port's substrate for RWMH, MALA, RM-HMC and DE against the
JAX package's, on the CPU: ``stats``, the two ``bounds`` helpers and the four
targets on the same numpy inputs; the population runner, and
``SamplerResult.summary`` (the ported ``diagnostics.summary``, which
``tests/test_torch_diagnostics.py`` holds against JAX's) and ``to_arviz``;
the cases of ``tests/test_bounds.py`` (``sampling_bounds_check``),
``tests/test_utilities.py`` (batched dmvnorm, summary and the arviz gate)
and the RWMH and DE cases of ``tests/test_edge_cases.py``.

Tolerance rtol 1e-5 (f32 on both sides, summation orders differ), unless a
test says otherwise.
"""

import jax
import numpy as np
import pytest
import torch

import mcmc_tpu_torch
from mcmc_tpu import bounds as jbounds
from mcmc_tpu import models as jmodels
from mcmc_tpu import stats as jstats
from mcmc_tpu_torch import bounds as tbounds
from mcmc_tpu_torch import models as tmodels
from mcmc_tpu_torch import stats as tstats
from mcmc_tpu_torch.results import SamplerResult
from mcmc_tpu_torch.samplers import common as tcommon

RTOL = 1e-5
LK = lambda v: -0.5 * (v ** 2).sum(-1)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _spd(rng, k):
    a = rng.standard_normal((k, k))
    return (a @ a.T + k * np.eye(k)).astype(np.float32)


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("log", [True, False])
def test_dnorm_matches_jax(log):
    """Element-wise normal density, IEEE semantics included: a zero sigma
    gives +inf (log) at x == mu, NaN propagates."""
    rng = np.random.default_rng(0)
    x = np.concatenate([_f32(rng, 20), [0.5, np.nan]]).astype(np.float32)
    for mu, sigma in ((0.0, 1.0), (0.5, 2.5)):
        want = np.asarray(jstats.dnorm(x, mu, sigma, log=log))
        got = tstats.dnorm(torch.from_numpy(x), mu, sigma, log=log).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, equal_nan=True)
    want = np.asarray(jstats.dnorm(x, 0.5, 0.0, log=log))
    got = tstats.dnorm(torch.from_numpy(x), 0.5, 0.0, log=log).numpy()
    np.testing.assert_array_equal(got, want)
    assert tstats.LOG_2PI == jstats.LOG_2PI


@pytest.mark.parametrize("log", [True, False])
@pytest.mark.parametrize("kind", ["scalar", "diag", "dense"])
def test_dmvnorm_matches_jax(kind, log):
    """``dmvnorm`` of a batch of rows with a shared scalar, diagonal or
    dense sigma, and of one row, against JAX's."""
    rng = np.random.default_rng(1)
    k = 4
    x, mu = _f32(rng, 6, k), _f32(rng, k)
    sigma = {"scalar": np.float32(1.7),
             "diag": rng.uniform(0.5, 2.0, k).astype(np.float32),
             "dense": _spd(rng, k)}[kind]
    for xx in (x, x[0]):
        want = np.asarray(jstats.dmvnorm(xx, mu, sigma, log=log))
        got = tstats.dmvnorm(torch.from_numpy(xx), torch.from_numpy(mu),
                             torch.as_tensor(sigma), log=log)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


@pytest.mark.parametrize("kind", ["scalar", "diag", "dense"])
def test_dmvnorm_batched_sigma_matches_jax_vmap(kind):
    """``batched=True``: one sigma per row (scalar, diagonal or matrix), as
    JAX's ``dmvnorm`` under ``jax.vmap`` over rows and sigmas; a matrix that
    is not positive definite gives NaN (JAX's Cholesky does), and no
    error."""
    rng = np.random.default_rng(2)
    n, k = 7, 3
    x, mu = _f32(rng, n, k), _f32(rng, n, k)
    sigma = {"scalar": rng.uniform(0.5, 2.0, n),
             "diag": rng.uniform(0.5, 2.0, (n, k)),
             "dense": np.stack([_spd(rng, k) for _ in range(n)])}[kind]
    sigma = sigma.astype(np.float32)
    if kind == "dense":
        sigma[3] = -sigma[3]
    want = np.asarray(jax.vmap(lambda a, b, s: jstats.dmvnorm(
        a, b, s, log=True))(x, mu, sigma))
    got = tstats.dmvnorm(torch.from_numpy(x), torch.from_numpy(mu),
                         torch.from_numpy(sigma), log=True, batched=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, equal_nan=True)
    assert np.isnan(want[3]) == (kind == "dense")


def test_dmvnorm_batched_full_matrix():
    """tests/test_utilities.py::test_dmvnorm_batched_full_matrix: the batch
    of rows against each row alone."""
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(_f32(rng, 5, 3))
    sigma = torch.tensor([[2.0, 0.5, 0.0], [0.5, 1.5, 0.2], [0.0, 0.2, 1.0]])
    batched = tstats.dmvnorm(xs, torch.zeros(3), sigma, log=True)
    singles = torch.stack([tstats.dmvnorm(x, torch.zeros(3), sigma, log=True)
                           for x in xs])
    np.testing.assert_allclose(batched.numpy(), singles.numpy(), rtol=1e-5)


def test_gumbel_topk_draws_distinct_and_by_weight():
    """``n`` distinct indices; a weight far above the rest is always
    drawn; the first draw's frequencies follow the weights (within 5
    binomial standard errors over 4,000 repeats)."""
    gen = torch.Generator().manual_seed(0)
    lw = torch.log(torch.tensor([0.1, 0.2, 0.3, 0.4]))
    first = np.zeros(4)
    for _ in range(4000):
        idx = tstats.gumbel_topk(gen, lw, 3)
        assert len(set(idx.tolist())) == 3
        first[int(idx[0])] += 1
    p = np.array([0.1, 0.2, 0.3, 0.4])
    se = np.sqrt(p * (1 - p) / 4000)
    assert (np.abs(first / 4000 - p) <= 5 * se).all(), first
    big = torch.tensor([0.0, 50.0, 0.0, 0.0, 0.0])
    assert int(tstats.gumbel_topk(gen, big, 1)[0]) == 1


# ---------------------------------------------------------------------------
# bounds
# ---------------------------------------------------------------------------

_LB = np.array([-np.inf, 0.0, -np.inf, -1.0], np.float32)
_UB = np.array([np.inf, np.inf, 2.0, 1.0], np.float32)


def _codes():
    return (jbounds.determine_bounds_type(True, 4, _LB, _UB),
            tbounds.determine_bounds_type(True, 4, torch.from_numpy(_LB),
                                          torch.from_numpy(_UB)))


def test_sampling_bounds_check():
    """tests/test_bounds.py::test_sampling_bounds_check, and JAX's output:
    the box clipped to the finite bounds of codes 2-4; ``vals_bound=False``
    leaves it."""
    jc, tc = _codes()
    lb, ub = np.full(4, -5.0, np.float32), np.full(4, 5.0, np.float32)
    out_lb, out_ub = tbounds.sampling_bounds_check(
        True, tc, torch.from_numpy(_LB), torch.from_numpy(_UB),
        torch.from_numpy(lb), torch.from_numpy(ub))
    np.testing.assert_allclose(out_lb.numpy(), [-5.0, 0.0, -5.0, -1.0])
    np.testing.assert_allclose(out_ub.numpy(), [5.0, 5.0, 2.0, 1.0])
    want = jbounds.sampling_bounds_check(True, jc, _LB, _UB, lb, ub)
    for g, w in zip((out_lb, out_ub), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    same = tbounds.sampling_bounds_check(False, tc, _LB, _UB, lb, ub)
    np.testing.assert_array_equal(same[0].numpy(), lb)
    np.testing.assert_array_equal(same[1].numpy(), ub)


def test_inv_jacobian_adjust_matches_jax():
    """The full diagonal matrix of each row, against JAX's under vmap."""
    jc, tc = _codes()
    z = _f32(np.random.default_rng(3), 5, 4)
    want = np.asarray(jax.vmap(lambda zz: jbounds.inv_jacobian_adjust(
        zz, jc, _LB, _UB))(z))
    got = tbounds.inv_jacobian_adjust(torch.from_numpy(z), tc,
                                      torch.from_numpy(_LB),
                                      torch.from_numpy(_UB))
    assert got.shape == (5, 4, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


# ---------------------------------------------------------------------------
# targets
# ---------------------------------------------------------------------------

def _target_pairs():
    rng = np.random.default_rng(4)
    x = (2.0 + rng.standard_normal(100)).astype(np.float32)
    mu = np.array([[-2.0, -2.0], [2.0, 2.0], [0.5, -1.0]], np.float32)
    sig = np.array([0.5, 0.3, 1.2], np.float32)
    w = np.array([0.5, 0.3, 0.2], np.float32)
    return {
        "gaussian_mean": (jmodels.gaussian_mean_model(x, sigma=1.5),
                          tmodels.gaussian_mean_model(x, sigma=1.5,
                                                      device="cpu"), 1),
        "gaussian_mean_prior": (
            jmodels.gaussian_mean_model(x, 1.0, -1.0, 0.5),
            tmodels.gaussian_mean_model(x, 1.0, -1.0, 0.5, device="cpu"), 1),
        "mixture": (jmodels.gaussian_mixture_model(mu, sig, w),
                    tmodels.gaussian_mixture_model(mu, sig, w, device="cpu"),
                    2),
        "funnel": (jmodels.neals_funnel(4, 3.0), tmodels.neals_funnel(4, 3.0),
                   4),
    }


@pytest.mark.parametrize("name", ["gaussian_mean", "gaussian_mean_prior",
                                  "mixture", "funnel"])
def test_target_matches_jax(name):
    """Each batched log-kernel and its autograd gradient against JAX's
    ``vmap`` of the single-chain kernel and of its ``jax.grad`` (rtol 1e-5
    of the values' scale)."""
    jlk, tlk, d = _target_pairs()[name]
    p = (1.5 * _f32(np.random.default_rng(5), 16, d)).astype(np.float32)
    want = np.asarray(jax.vmap(jlk)(p))
    wgrad = np.asarray(jax.vmap(jax.grad(jlk))(p))
    tp = torch.from_numpy(p).requires_grad_(True)
    got = tlk(tp)
    (g,) = torch.autograd.grad(got.sum(), tp)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
    np.testing.assert_allclose(g.numpy(), wgrad, rtol=1e-4,
                               atol=1e-4 * np.abs(wgrad).max())
    if name == "funnel":
        assert tlk.dim == 4


def test_normal_fisher_metric_and_its_jvp_match_jax():
    """``diag(n/sigma^2, 2n/sigma^2)`` per row, and ``torch.func.jvp`` of
    it along each coordinate against ``jax.jacfwd``."""
    p = np.array([[2.0, 1.5], [0.0, 0.7], [-1.0, 3.0]], np.float32)
    jm, tm = jmodels.normal_fisher_metric(1000), \
        tmodels.normal_fisher_metric(1000)
    want = np.asarray(jax.vmap(jm)(p))
    wjac = np.asarray(jax.vmap(jax.jacfwd(jm))(p))      # (c, a, b, i)
    tp = torch.from_numpy(p)
    np.testing.assert_allclose(tm(tp).numpy(), want, rtol=RTOL)
    for i in range(2):
        e = torch.zeros_like(tp)
        e[:, i] = 1.0
        G, dG = torch.func.jvp(tm, (tp,), (e,))
        np.testing.assert_allclose(G.numpy(), want, rtol=RTOL)
        np.testing.assert_allclose(dG.numpy(), wjac[..., i], rtol=RTOL)


# ---------------------------------------------------------------------------
# the population runner, results and the RWMH / DE edge cases
# ---------------------------------------------------------------------------

def test_population_runner_and_accept_diag():
    """``make_population_runner`` discards the burn-in sweeps and stores
    every kept sweep's population and accepts; ``population_accept_diag``
    gives each walker's rate over the transitions, ``thin`` recorded."""
    from mcmc_tpu_torch.samplers.de import DEState

    def sweep(gen, st):
        acc = torch.rand(st.X.shape[:1], generator=gen) < 0.5
        return DEState(st.X + 1.0, st.kernel_vals, st.gen_ind + 1), \
            {"accepted": acc}

    st0 = DEState(torch.zeros(5, 2), torch.zeros(5),
                  torch.zeros((), dtype=torch.int32))
    run = tcommon.make_population_runner(sweep)
    final, (draws, acc) = run(st0, torch.Generator().manual_seed(0), 3, 4)
    assert draws.shape == (4, 5, 2) and acc.shape == (4, 5)
    np.testing.assert_array_equal(draws[:, 0, 0].numpy(), [4, 5, 6, 7])
    assert int(final.gen_ind) == 7
    diag = tcommon.population_accept_diag(acc, 1)
    assert set(diag) == {"accept_rate_per_walker"}
    np.testing.assert_allclose(diag["accept_rate_per_walker"].numpy(),
                               acc.float().mean(0).numpy())
    diag = tcommon.population_accept_diag(2 * acc.int(), 2)
    assert diag["thin"] == 2
    np.testing.assert_allclose(diag["accept_rate_per_walker"].numpy(),
                               acc.float().mean(0).numpy())


def test_summary_is_the_ported_summary():
    """``SamplerResult.summary`` is the port's ``diagnostics.summary`` of
    the draws, key for key and bit for bit (tests/test_torch_diagnostics.py
    holds that against the JAX package's on the same draws); the result's
    properties as tests/test_utilities.py checks them."""
    from mcmc_tpu_torch import diagnostics as tdiag
    rng = np.random.default_rng(6)
    d = torch.from_numpy(
        (rng.standard_normal((200, 4, 3)) + 2.0).astype(np.float32))
    res = SamplerResult(draws=d, n_accept_draws=torch.tensor([50, 60, 70,
                                                              80]))
    got, want = res.summary(), tdiag.summary(d)
    assert set(got) == set(want) and {"mean", "ess_bulk"} <= set(got)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    np.testing.assert_allclose(res.mean.numpy(), 2.0, atol=0.2)
    np.testing.assert_allclose(res.accept_rate.numpy(),
                               [0.25, 0.3, 0.35, 0.4])
    assert res.var.shape == (3,)


def test_result_summary_and_arviz_gate():
    """tests/test_utilities.py::test_result_summary_and_arviz_gate: an
    ``rwmh`` result's summary has the full diagnostic set, and
    ``to_arviz`` raises a helpful ImportError without arviz."""
    out = mcmc_tpu_torch.rwmh(np.zeros(2), LK,
                              mcmc_tpu_torch.RWMHSettings(
                                  n_burnin_draws=100, n_keep_draws=200,
                                  par_scale=1.0),
                              n_chains=4, key=0, device="cpu")
    summ = out.summary()
    for k in ("mean", "sd", "mcse", "rhat", "ess", "rhat_rank", "ess_bulk",
              "ess_tail"):
        assert k in summ, k
    try:
        import arviz  # noqa: F401
        idata = out.to_arviz()
        assert idata.posterior["x"].shape == (4, 200, 2)
    except ImportError:
        with pytest.raises(ImportError, match="arviz"):
            out.to_arviz()


def test_zero_burnin_and_tiny_population():
    """tests/test_edge_cases.py: RWMH with no burn-in keeps 50 draws of one
    chain; DE with ``n_pop=3``, the smallest population with distinct
    ``(i, c1, c2)``, gives finite draws of shape (50, 3, 1)."""
    out = mcmc_tpu_torch.rwmh(np.zeros(2), LK,
                              mcmc_tpu_torch.RWMHSettings(n_burnin_draws=0,
                                                          n_keep_draws=50),
                              key=0, device="cpu")
    assert out.draws.shape == (50, 2)
    out = mcmc_tpu_torch.de(np.zeros(1), LK,
                            mcmc_tpu_torch.DESettings(n_pop=3,
                                                      n_burnin_draws=50,
                                                      n_keep_draws=50),
                            key=4, device="cpu")
    assert out.draws.shape == (50, 3, 1)
    assert bool(torch.isfinite(out.draws).all())


@pytest.mark.parametrize("kwargs", [
    dict(adapt_scale=True, adapt_precond="dense", pooled_adaptation=True),
    dict(adapt_precond="diag"),
])
def test_rwmh_option_combinations_smoke(kwargs):
    """tests/test_edge_cases.py::test_rwmh_option_combinations_smoke."""
    s = mcmc_tpu_torch.RWMHSettings(n_burnin_draws=80, n_keep_draws=80,
                                    par_scale=0.8)
    out = mcmc_tpu_torch.rwmh(np.zeros(3), LK, s, n_chains=4, key=0,
                              device="cpu", **kwargs)
    assert out.draws.shape == (80, 4, 3)
    assert bool(torch.isfinite(out.draws).all())


@pytest.mark.parametrize("name", ["rwmh", "mala", "rmhmc", "de"])
def test_entry_points_default_to_the_card(name, tmp_path):
    """With no ``device=`` and numpy inputs the entry point allocates on
    ``cuda``: where there is none it raises, and never falls back to the
    CPU; ``mesh=`` raises ``NotImplementedError``; ``checkpoint_dir=``
    gives the in-memory run's draws."""
    fn = getattr(mcmc_tpu_torch, name)
    args = (np.zeros(2), LK) if name != "rmhmc" else \
        (np.zeros(2), LK, lambda v: torch.diag_embed(torch.ones_like(v)))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            fn(*args, key=0)
    with pytest.raises(NotImplementedError):
        fn(*args, key=0, device="cpu", mesh=object())
    cls = {"rwmh": mcmc_tpu_torch.RWMHSettings,
           "mala": mcmc_tpu_torch.MALASettings,
           "rmhmc": mcmc_tpu_torch.RMHMCSettings,
           "de": mcmc_tpu_torch.DESettings}[name]
    small = cls(n_burnin_draws=3, n_keep_draws=5)
    plain = fn(*args, small, key=0, device="cpu")
    ck = fn(*args, small, key=0, device="cpu",
            checkpoint_dir=tmp_path / "ck", checkpoint_every=2)
    assert torch.equal(plain.draws, ck.draws)
