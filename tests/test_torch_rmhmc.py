"""The PyTorch port's RM-HMC and SoftAbs metric against the JAX package's,
on the CPU.

The transition is held exactly: JAX's step under ``jax.vmap`` and the
port's transition fed the normals and uniforms JAX's step draws from its
keys (``jax_run`` of ``tests/test_torch_chees.py``), with the Fisher metric
of the (mu, sigma) model (unbounded, and with a box on sigma, which chains
the kick by the inverse Jacobian) and with the SoftAbs metric on Neal's
funnel. Every state field (the metric, its inverse, Cholesky factor and
derivative cube included) at a stated rtol, and the accept decisions
exactly; RM-HMC adapts nothing, so the fed runs cover every transition.
The rest follows ``tests/test_softabs.py`` (the eigenvalue map, the
derivative against finite differences, finite and exact at a degenerate
Hessian where autograd through ``eigh`` is not) and the RM-HMC cases of
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
from mcmc_tpu import models as jmodels
from mcmc_tpu.samplers import common as jcommon
from mcmc_tpu_torch import convert
from mcmc_tpu_torch import models as tmodels
from mcmc_tpu_torch.samplers import common as tcommon
from test_torch_chees import assert_close, jax_run, run_fed

jrmhmc = importlib.import_module("mcmc_tpu.samplers.rmhmc")
trmhmc = importlib.import_module("mcmc_tpu_torch.samplers.rmhmc")


def _normal_data(n=100, seed=8):
    return (2.0 + 2.0 * np.random.default_rng(seed).standard_normal(n)
            ).astype(np.float32)


def _fisher_case(bounded):
    x = _normal_data()
    kw = dict(vals_bound=True, lower_bounds=np.array([-np.inf, 0.2]),
              upper_bounds=np.array([np.inf, 8.0])) if bounded else {}
    starts = np.random.default_rng(9).uniform(1.5, 3.0, (32, 2))
    return (jmodels.gaussian_mean_scale_model(x),
            jmodels.normal_fisher_metric(x.shape[0]),
            tmodels.gaussian_mean_scale_model(x, device="cpu"),
            tmodels.normal_fisher_metric(x.shape[0]), kw,
            starts.astype(np.float32),
            dict(step_size=0.15, n_leap_steps=3, n_fp_steps=3), 20)


def _funnel_case(_bounded):
    # one leapfrog (the Fisher cases take three): JAX compiles the SoftAbs
    # kernel's nested derivatives in a scan of two leapfrogs six times
    # slower
    jlk, tlk = jmodels.neals_funnel(3, 3.0), tmodels.neals_funnel(3, 3.0)
    starts = np.random.default_rng(10).standard_normal((12, 3))
    starts[:, 0] *= 1.5
    return (jlk, mcmc_tpu.softabs_metric(jlk, 1.0), tlk,
            mcmc_tpu_torch.softabs_metric(tlk, 1.0), {},
            starts.astype(np.float32),
            dict(step_size=0.5, n_leap_steps=1, n_fp_steps=2), 8)


# (case function, bounded). One transition agrees with JAX's to 5.3e-7 of
# each field's scale with the Fisher metric and 1.9e-6 with SoftAbs (the
# derivative cube the largest; measured): held at rtol 1e-5.
CASES = {"fisher": (_fisher_case, False),
         "fisher_bounded": (_fisher_case, True),
         "softabs_funnel": (_funnel_case, False)}
_RUNS = {}


def _draws_of(dim):
    def draws(key):
        k_mom, k_accept = jax.random.split(key)
        return (jax.random.normal(k_mom, (dim,), jnp.float32),
                jax.random.uniform(k_accept, dtype=jnp.float32))
    return draws


def _rmhmc_case(name):
    build, bounded = CASES[name]
    jlk, jmetric, tlk, tmetric, kw, x0, cfg, n = build(bounded)
    tprob = tcommon.setup_problem(torch.from_numpy(x0), tlk,
                                  mcmc_tpu_torch.AlgoSettings(**kw), None)
    if name not in _RUNS:
        jprob = jcommon.setup_problem(jnp.asarray(x0), jlk,
                                      mcmc_tpu.AlgoSettings(**kw), None)
        jinit, jstep = jrmhmc.build_rmhmc_kernel(
            jprob, jmetric, mcmc_tpu.RMHMCSettings(**cfg))
        st0 = jax.vmap(jinit)(jprob.first_draw)
        _RUNS[name] = jax_run(jstep, _draws_of(x0.shape[1]), st0, n, 11)
    tinit, tstep = trmhmc.build_rmhmc_kernel(
        tprob, tmetric, mcmc_tpu_torch.RMHMCSettings(**cfg))
    return tprob, tinit, tstep, _RUNS[name]


@pytest.mark.parametrize("name", list(CASES))
def test_rmhmc_transition_matches_jax(name):
    """Each of JAX's transitions, from JAX's state before it and fed its
    draws: every state field at rtol 1e-5 and the accept decisions
    exactly; the port's ``init`` gives JAX's first state, and
    ``convert.rmhmc_state`` carries it across."""
    tprob, tinit, tstep, (states, infos, draws) = _rmhmc_case(name)
    with torch.no_grad():
        assert_close(tinit(tprob.first_draw), states[0], what="init")
        assert_close(convert.rmhmc_state(states[0], "cpu"), states[0],
                     0.0, what="convert")
        for t, d in enumerate(draws):
            new, info = tstep.transition(
                convert.rmhmc_state(states[t], "cpu"),
                *(torch.from_numpy(np.array(x)) for x in d))
            assert_close(new, states[t + 1], what=f"state after {t}")
            np.testing.assert_array_equal(info["accepted"].numpy(),
                                          infos[t]["accepted"])
    acc = np.mean([i["accepted"].mean() for i in infos])
    assert 0.3 < acc <= 1.0, acc


# Nothing adapts, so the drift does not grow: the final state of the
# port's own run is within 4.9e-7 of each field's scale after 20 Fisher
# transitions and 2.1e-6 after 8 SoftAbs ones (measured); held at 1e-5.
RUN_RTOL = 1e-5


@pytest.mark.parametrize("name", list(CASES))
def test_rmhmc_run_fed_jax_draws(name):
    """The port's own run from JAX's start, fed JAX's draws: the same
    accept decisions at every transition and the final state within
    ``RUN_RTOL``; ``n_leap_steps`` leapfrogs a transition, and the metric
    evaluated ``n_leap (n_fp + d)`` times (each derivative JVP evaluates
    it once; the last leapfrog's tensor serves the accept test)."""
    _, _, tstep, (states, infos, draws) = _rmhmc_case(name)
    d = states[0].position.shape[1]
    n_leap, n_fp = (3, 3) if name.startswith("fisher") else (1, 2)
    before = dict(tstep.counts)
    with torch.no_grad():
        final = run_fed(convert.rmhmc_state, tstep.transition, states, infos,
                        draws)
    assert_close(final, states[-1], RUN_RTOL, "final state")
    n = len(draws)
    assert tstep.counts["draws"] - before["draws"] == n
    assert tstep.counts["leapfrogs"] - before["leapfrogs"] == n * n_leap
    assert tstep.counts["metric_evaluations"] \
        - before["metric_evaluations"] == n * n_leap * (n_fp + d)


# ---------------------------------------------------------------------------
# SoftAbs, after tests/test_softabs.py
# ---------------------------------------------------------------------------

def test_softabs_eigenvalue_map():
    """An indefinite Hessian becomes SPD: negative eigenvalues flip, zero
    floors at 1/alpha, large ones pass as |l|."""
    A = torch.diag(torch.tensor([-5.0, 0.0, 2.0]))
    m = mcmc_tpu_torch.softabs_metric(
        lambda x: -0.5 * (x * (x @ A)).sum(-1), alpha=10.0)
    ev = torch.linalg.eigvalsh(m(torch.zeros(3))).sort().values
    np.testing.assert_allclose(ev.numpy(), [0.1, 2.0, 5.0], rtol=1e-4)
    with pytest.raises(ValueError, match="alpha"):
        mcmc_tpu_torch.softabs_metric(lambda x: -(x * x).sum(-1), alpha=0.0)


def _jac(m, x0):
    """``(c, a, b, i)``: ``torch.func.jvp`` of the batched metric along each
    coordinate."""
    cols = []
    for i in range(x0.shape[-1]):
        e = torch.zeros_like(x0)
        e[..., i] = 1.0
        cols.append(torch.func.jvp(m, (x0,), (e,))[1])
    return torch.stack(cols, dim=-1)


def _fd_jac(m, x0, eps):
    cols = []
    for i in range(x0.shape[-1]):
        e = torch.zeros_like(x0)
        e[..., i] = eps
        cols.append((m(x0 + e) - m(x0 - e)) / (2 * eps))
    return torch.stack(cols, dim=-1)


def test_softabs_derivative_matches_fd_and_jax():
    """Distinct eigenvalues, float64: the derivative from the
    Daleckii-Krein ``jvp`` against central differences (atol 1e-7), and
    against ``jax.jacfwd`` of the JAX package's metric on each chain."""
    rng = np.random.default_rng(0)
    W = 0.3 * rng.standard_normal((4, 4))
    x0 = rng.standard_normal((3, 4))
    Wt = torch.from_numpy(W)
    lk = lambda x: (-0.5 * (x * x).sum(-1) - 0.1 * ((x @ Wt.T) ** 4).sum(-1)
                    - 0.05 * (x ** 3).sum(-1))
    m = mcmc_tpu_torch.softabs_metric(lk, alpha=2.0)
    xt = torch.from_numpy(x0)
    J = _jac(m, xt)
    np.testing.assert_allclose(J.numpy(), _fd_jac(m, xt, 1e-6).numpy(),
                               atol=1e-7)
    with jax.enable_x64():
        Wj = jnp.asarray(W)
        jlk = lambda x: (-0.5 * x @ x - 0.1 * jnp.sum((Wj @ x) ** 4)
                         - 0.05 * jnp.sum(x ** 3))
        jm = mcmc_tpu.softabs_metric(jlk, alpha=2.0)
        want = np.asarray(jax.jit(jax.vmap(jax.jacfwd(jm)))(x0))
        G = np.asarray(jax.jit(jax.vmap(jm))(x0))
    np.testing.assert_allclose(m(xt).numpy(), G, rtol=1e-10)
    np.testing.assert_allclose(J.numpy(), want, rtol=1e-8, atol=1e-10)


def test_softabs_derivative_finite_and_exact_at_degeneracy():
    """U = 0.5 (x.x)^2: eigenvalue 2|x|^2 of multiplicity d-1. At the JAX
    test's point and at an exactly representable one the Daleckii-Krein
    ``jvp`` stays finite and matches central differences (atol 1e-6,
    float64). The control, autograd's forward derivative through ``eigh``
    of the same map, is off by more than 0.1 at the first point (its
    eigenvalues split by rounding) and not finite at the second."""
    lk = lambda x: -0.5 * (x * x).sum(-1) ** 2
    m = mcmc_tpu_torch.softabs_metric(lk, alpha=1.0)
    x0 = torch.tensor([[1.0, 0.5, -0.3, 0.2], [1.0, 0.0, 0.0, 0.0]],
                      dtype=torch.float64)
    J = _jac(m, x0)
    fd = _fd_jac(m, x0, 1e-6)
    assert bool(torch.isfinite(J).all())
    np.testing.assert_allclose(J.numpy(), fd.numpy(), atol=1e-6)

    neg_grad = torch.func.grad(lambda x: -lk(x).sum())

    def naive(x):
        H = torch.func.jacfwd(neg_grad)(x)
        lam, Q = torch.linalg.eigh(H)
        return (Q * (lam / torch.tanh(lam))) @ Q.T

    assert float((torch.func.jacfwd(naive)(x0[0]) - fd[0]).abs().max()) > 0.1
    assert not bool(torch.isfinite(torch.func.jacfwd(naive)(x0[1])).all())


def test_softabs_symmetric_spd_on_the_funnel():
    """The funnel's SoftAbs metric is symmetric and positive definite at
    scattered points, and NaN (no error) where the log-kernel overflows."""
    m = mcmc_tpu_torch.softabs_metric(tmodels.neals_funnel(3, 3.0), 1.0)
    x = 2.0 * torch.from_numpy(np.random.default_rng(0).standard_normal(
        (5, 3)).astype(np.float32))
    G = m(x)
    np.testing.assert_allclose(G.numpy(), G.transpose(1, 2).numpy(),
                               atol=1e-5)
    assert float(torch.linalg.eigvalsh(G).min()) > 0
    bad = m(torch.tensor([[-200.0, 1.0, 1.0], [0.0, 1.0, 1.0]]))
    assert bool(torch.isnan(bad[0]).all()) and bool(
        torch.isfinite(bad[1]).all())


# ---------------------------------------------------------------------------
# distributional, on the RM-HMC cases of tests/test_rmhmc_de_aees.py and
# tests/test_bounded_samplers.py
# ---------------------------------------------------------------------------

def test_rmhmc_mean_scale_unbounded_and_bounded():
    """The Fisher metric on the (mu, sigma) posterior of 1,000 points
    (reference rmhmc_normal.cpp; tests/test_rmhmc_de_aees.py:14-32 and
    tests/test_bounded_samplers.py:59-72): both means within 0.2 of the
    data's mean and sd, acceptance above 0.3; with a box on sigma every
    draw inside it, within 0.35."""
    x = _normal_data(1000, 8)
    lk = tmodels.gaussian_mean_scale_model(x, device="cpu")
    metric = tmodels.normal_fisher_metric(1000)
    s = mcmc_tpu_torch.RMHMCSettings(n_burnin_draws=40, n_keep_draws=80,
                                     step_size=0.2, n_leap_steps=4)
    out = mcmc_tpu_torch.rmhmc(np.array([3.0, 3.0]), lk, metric, s,
                               n_chains=32, key=13, device="cpu")
    mean = out.mean.numpy()
    assert abs(mean[0] - x.mean()) < 0.2 and abs(mean[1] - x.std()) < 0.2
    assert float(out.accept_rate.mean()) > 0.3

    algo = mcmc_tpu_torch.AlgoSettings(
        rng_seed_value=7, vals_bound=True,
        lower_bounds=np.array([-np.inf, 0.2]),
        upper_bounds=np.array([np.inf, 8.0]),
        rmhmc_settings=mcmc_tpu_torch.RMHMCSettings(
            n_burnin_draws=40, n_keep_draws=80, step_size=0.15,
            n_leap_steps=2))
    out = mcmc_tpu_torch.rmhmc(np.array([2.5, 2.5]), lk, metric, algo,
                               n_chains=32, device="cpu")
    d = out.draws
    assert bool(((d[..., 1] > 0.2) & (d[..., 1] < 8.0)).all())
    assert abs(float(d[..., 0].mean()) - x.mean()) < 0.35
    assert abs(float(d[..., 1].mean()) - x.std()) < 0.35


def test_rmhmc_constant_metric_is_standard_normal():
    """With a constant identity metric RM-HMC samples N(0, I) like plain HMC
    (tests/test_rmhmc_de_aees.py:35-47): means within 0.12 and variances
    within 0.2, as there; ``thin`` and ``return_resume`` work."""
    metric = lambda v: torch.eye(2).expand(v.shape[0], 2, 2)
    s = mcmc_tpu_torch.RMHMCSettings(n_burnin_draws=30, n_keep_draws=120,
                                     step_size=0.5, n_leap_steps=3)
    out = mcmc_tpu_torch.rmhmc(np.zeros(2), lambda v: -0.5 * (v ** 2).sum(-1),
                               metric, s, n_chains=64, key=3, device="cpu",
                               return_resume=True)
    d = out.draws.reshape(-1, 2)
    np.testing.assert_allclose(d.mean(0).numpy(), 0.0, atol=0.12)
    np.testing.assert_allclose(d.var(0).numpy(), 1.0, atol=0.2)
    more = out.diagnostics["resume"](4, 3)
    assert more.draws.shape == (3, 64, 2)
