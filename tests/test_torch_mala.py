"""The PyTorch port's MALA against the JAX package's, on the CPU.

The transition is held exactly: JAX's step under ``jax.vmap`` with the
chain axis named, and the port's transition fed the normals and uniforms
JAX's step draws from its keys (``jax_run`` of
``tests/test_torch_chees.py``), for the identity, a diagonal and a full
user preconditioner, the bounded ``"reference"`` mode (its Jacobian quirk,
and with the full preconditioner its asymmetric-covariance solve with
``slogdet``), the bounded ``"exact"`` mode, dual averaging, and the
windowed diagonal and pooled dense preconditioner (its triangular-solve
asymmetry term). Every state field at rtol 1e-5 and the accept decisions
exactly; the long fed runs adapt where the loop contracts. The rest is
distributional, on the cases of ``tests/test_hmc_mala.py`` and
``tests/test_bounded_samplers.py`` at smaller sizes: the truncated normal's
1.40 (reference mode, the quirk's bias) against 1.288 (exact mode).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmc_tpu
import mcmc_tpu_torch
from mcmc_tpu import adaptation as jadapt
from mcmc_tpu.samplers import common as jcommon
from mcmc_tpu_torch import adaptation as tadapt
from mcmc_tpu_torch import convert
from mcmc_tpu_torch import diagnostics as td
from mcmc_tpu_torch import stats as tstats
from mcmc_tpu_torch.models import (gaussian_mean_scale_model,
                                   ill_conditioned_gaussian)
from mcmc_tpu_torch.samplers import common as tcommon
from test_torch_chees import (AX, _COV, assert_close, check_transitions,
                              gaussian_pair, jax_run, run_fed, start)
from test_torch_nuts import _assert_moment


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for every test here: the tests run in several
    worker processes at once, and torch's default of a thread per core
    oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


jmala = importlib.import_module("mcmc_tpu.samplers.mala")
tmala = importlib.import_module("mcmc_tpu_torch.samplers.mala")

D, C, N_TRANS = 4, 32, 62
N_ADAPT = 66          # window ends at draws 33 and 59
STEP = 0.5
_DIAG = np.array([0.5, 1.0, 2.0, 4.0], np.float32)
_LB = np.array([-np.inf, 0.0, -np.inf, -1.0], np.float32)
_UB = np.array([np.inf, np.inf, 2.0, 3.0], np.float32)

# (precond_mat, bounded_grad or None for unbounded, dual averaging,
#  preconditioner adaptation, pooled)
CASES = {"identity": (None, None, False, None, False),
         "diag_precond": (_DIAG, None, False, None, False),
         "full_precond": (_COV, None, False, None, False),
         "bounded_reference": (_DIAG, "reference", False, None, False),
         "bounded_reference_full": (_COV, "reference", False, None, False),
         "bounded_exact": (None, "exact", False, None, False),
         "adapt": (None, None, True, None, False),
         "adapt_diag": (None, None, True, "diag", False),
         "adapt_dense_pooled": (None, None, True, "dense", True)}
_RUNS = {}


def _start():
    """Chains inside the bounds of the bounded cases (dims 1-3 bounded)."""
    x = start(3)
    x[:, 1] = np.abs(x[:, 1]) + 0.1
    x[:, 2] = np.minimum(x[:, 2], 1.9)
    x[:, 3] = np.clip(x[:, 3], -0.9, 2.9)
    return x


def _draws(key):
    k_noise, k_accept = jax.random.split(key)
    return (jax.random.normal(k_noise, (D,), jnp.float32),
            jax.random.uniform(k_accept, dtype=jnp.float32))


def _mala_case(name, target):
    """JAX's 62 transitions of the case, with 40 transitions of dual
    averaging toward ``target`` (cached), and the port's problem and
    kernel."""
    precond, bounded, adapt, mode, pooled = CASES[name]
    target = target if adapt else None
    cfg = {"n_burnin": 40, "target": target} if adapt else None
    jlk, tlk = gaussian_pair()
    kw = dict(vals_bound=True, lower_bounds=_LB, upper_bounds=_UB) \
        if bounded else {}
    grad_mode = bounded or "reference"
    x0 = _start()
    tprob = tcommon.setup_problem(torch.from_numpy(x0), tlk,
                                  mcmc_tpu_torch.AlgoSettings(**kw), None)
    if (name, target) not in _RUNS:
        jprob = jcommon.setup_problem(jnp.asarray(x0), jlk,
                                      mcmc_tpu.AlgoSettings(**kw), None)
        jcfg = None
        if mode:
            jcfg = jadapt.make_precond_cfg(N_ADAPT, pooled, AX)
            jcfg["mode"] = mode
        jinit, jstep = jmala.build_mala_kernel(
            jprob, jcommon.make_spd(precond, D, jnp.float32), STEP,
            grad_mode, cfg, jcfg)
        st0 = jax.vmap(jinit, axis_name=AX)(jprob.first_draw)
        _RUNS[name, target] = jax_run(jstep, _draws, st0, N_TRANS, 6)
    tcfg = None
    if mode:
        tcfg = tadapt.make_precond_cfg(N_ADAPT, pooled, "cpu")
        tcfg["mode"] = mode
    tinit, tstep = tmala.build_mala_kernel(
        tprob, tcommon.make_spd(precond, D, torch.float32), STEP, grad_mode,
        cfg, tcfg)
    return tprob, tinit, tstep, _RUNS[name, target]


@pytest.mark.parametrize("name", list(CASES))
def test_mala_transition_matches_jax(name):
    """Each of JAX's 62 transitions (both window ends, the end of dual
    averaging at 40), from JAX's state before it and fed its draws: every
    state field at rtol 1e-5 (``assert_close``), the accept decisions
    exactly; the port's ``init`` gives JAX's first state; both accepts and
    rejections occur."""
    tprob, tinit, tstep, (states, infos, draws) = _mala_case(name, 0.574)
    with torch.no_grad():
        assert_close(tinit(tprob.first_draw), states[0], what="init")
        check_transitions(convert.mala_state, tstep.transition, states,
                          infos, draws)
    acc = np.mean([i["accepted"].mean() for i in infos])
    assert 0.05 < acc < 0.99, acc


# The port's own run drifts from JAX's by the f32 rounding of two
# summation orders. At the default target 0.574 the early dual-averaging
# iterates (up to 10x the initial step and more) put some chains' step past
# the stiffest direction's stability limit, where each accepted move
# multiplies the drift: 2e-7 in the positions grew to 1e-1 over 50
# transitions while the accept decisions still agreed, then they parted
# (measured). At a target of 0.95 the step stays small and the loop
# contracts: over all 62 transitions (dual averaging through 40, both
# window ends) every final field stays within 1.2e-5 of its scale and the
# logs within 3.3e-4 (measured; the pooled dense case has the largest); the
# run is held to 1e-3.
RUN_TARGET, RUN_RTOL = 0.95, 1e-3


@pytest.mark.parametrize("name", list(CASES))
def test_mala_run_fed_jax_draws(name):
    """The port's 62 transitions from JAX's start, fed JAX's draws: the
    same accept decisions at every transition and the final state within
    ``RUN_RTOL``; one gradient a transition and no host
    synchronisation."""
    _, _, tstep, (states, infos, draws) = _mala_case(name, RUN_TARGET)
    with torch.no_grad():
        final = run_fed(convert.mala_state, tstep.transition, states, infos,
                        draws)
    assert_close(final, states[-1], RUN_RTOL, "final state")
    assert tstep.counts == {"draws": N_TRANS, "gradients": N_TRANS,
                            "syncs": 0}


def test_convert_round_trip():
    """``convert.mala_state`` carries JAX's ``init`` state across and equals
    the port's ``init`` on the same positions (dense, and bounded)."""
    for name in ("adapt_dense_pooled", "bounded_reference"):
        tprob, tinit, _, (states, _, _) = _mala_case(name, 0.574)
        got = convert.mala_state(states[0], "cpu")
        want = tinit(tprob.first_draw)
        for f, g, w in zip(got._fields, got, want):
            for gg, ww in (zip(g, w) if isinstance(g, tuple) else [(g, w)]):
                assert gg.dtype == ww.dtype, f
                torch.testing.assert_close(gg, ww, rtol=1e-5, atol=1e-6)


def test_dense_asymmetry_triangular_identity():
    """tests/test_hmc_mala.py::test_mala_dense_asymmetry_triangular_identity
    on the port's ``stats.dmvnorm``: the dense mode's two triangular solves
    against the carried Cholesky give the difference of the two MVN
    log-densities (float64, rtol 1e-9)."""
    rng = np.random.default_rng(7)
    for _ in range(5):
        d = int(rng.integers(2, 8))
        A = rng.normal(size=(d, d))
        eps = float(rng.uniform(0.1, 1.5))
        M = torch.from_numpy(A @ A.T + d * np.eye(d))
        a, b, m1, m2 = (torch.from_numpy(rng.normal(size=d)) for _ in range(4))
        ref = tstats.dmvnorm(a, m1, eps ** 2 * M, log=True) \
            - tstats.dmvnorm(b, m2, eps ** 2 * M, log=True)
        L = torch.linalg.cholesky(M)
        r1 = torch.linalg.solve_triangular(L, (a - m1)[:, None],
                                           upper=False)[:, 0] / eps
        r2 = torch.linalg.solve_triangular(L, (b - m2)[:, None],
                                           upper=False)[:, 0] / eps
        np.testing.assert_allclose(float(0.5 * (r2 @ r2 - r1 @ r1)),
                                   float(ref), rtol=1e-9)


# ---------------------------------------------------------------------------
# distributional, on the cases of tests/test_hmc_mala.py and
# tests/test_bounded_samplers.py
# ---------------------------------------------------------------------------

def test_mala_truncated_normal_exactness():
    """tests/test_bounded_samplers.py::test_mala_truncated_normal_exactness
    on N(1, 1) | x > 0 (mean 1.2876, sd 0.7935) at 256 chains: the exact
    mode within 0.05 of both; the reference mode's quirk bias present (mean
    above 1.34; the JAX package measures 1.40); an unknown mode raises."""
    lk = lambda x: -0.5 * ((x - 1.0) ** 2).sum(-1)
    algo = mcmc_tpu_torch.AlgoSettings(
        vals_bound=True, lower_bounds=np.zeros(1),
        mala_settings=mcmc_tpu_torch.MALASettings(n_burnin_draws=300,
                                                  n_keep_draws=600))
    kw = dict(n_chains=256, key=0, device="cpu")
    exact = mcmc_tpu_torch.mala(np.full(1, 0.5), lk, algo,
                                bounded_grad="exact", **kw)
    d = exact.draws
    assert abs(float(d.mean()) - 1.2876) < 0.05, float(d.mean())
    assert abs(float(d.std()) - 0.7935) < 0.05, float(d.std())
    ref = mcmc_tpu_torch.mala(np.full(1, 0.5), lk, algo,
                              bounded_grad="reference", **kw)
    assert float(ref.draws.mean()) > 1.34, float(ref.draws.mean())
    assert bool((ref.draws > 0).all() and (exact.draws > 0).all())
    with pytest.raises(ValueError, match="bounded_grad"):
        mcmc_tpu_torch.mala(np.full(1, 0.5), lk, algo, bounded_grad="box",
                            device="cpu")


def test_mala_standard_normal_and_bounded_mean_scale():
    """N(0, 1) in 3-d at step 0.9 (tests/test_hmc_mala.py:69-77): means and
    variances within 4 MC standard errors; the (mu, sigma) posterior with a
    box on sigma in both gradient modes (tests/test_bounded_samplers.py:
    29-42): every sigma inside, both means within 0.3 of the data's mean
    and sd."""
    out = mcmc_tpu_torch.mala(
        np.zeros(3), lambda v: -0.5 * (v ** 2).sum(-1),
        mcmc_tpu_torch.MALASettings(n_burnin_draws=100, n_keep_draws=400,
                                    step_size=0.9),
        n_chains=64, key=2, device="cpu")
    for k in range(3):
        _assert_moment(out.draws[..., k], 0.0, f"mean {k}")
        _assert_moment(out.draws[..., k] ** 2, 1.0, f"variance {k}")

    x = (2.0 + 2.0 * np.random.default_rng(123).standard_normal(1000)
         ).astype(np.float32)
    lk = gaussian_mean_scale_model(x, device="cpu")
    for mode in ("reference", "exact"):
        algo = mcmc_tpu_torch.AlgoSettings(
            rng_seed_value=3, vals_bound=True,
            lower_bounds=np.array([-np.inf, 0.2]),
            upper_bounds=np.array([np.inf, 8.0]),
            mala_settings=mcmc_tpu_torch.MALASettings(
                n_burnin_draws=400, n_keep_draws=200, step_size=0.03))
        out = mcmc_tpu_torch.mala(np.array([3.0, 3.0]), lk, algo,
                                  n_chains=32, bounded_grad=mode,
                                  device="cpu")
        d = out.draws
        assert bool(((d[..., 1] > 0.2) & (d[..., 1] < 8.0)).all()), mode
        assert abs(float(d[..., 0].mean()) - x.mean()) < 0.3, mode
        assert abs(float(d[..., 1].mean()) - x.std()) < 0.3, mode


def test_step_and_precond_adaptation():
    """Dual averaging lands the acceptance near 0.574 from a step of 3
    (tests/test_hmc_mala.py:119-138); on the 16-d ill-conditioned Gaussian
    the pooled windowed diagonal preconditioner learns the marginal
    variances and beats the plain sampler more than tenfold on min ESS
    (tests/test_hmc_mala.py:171-194)."""
    lk = lambda v: -0.5 * (v ** 2).sum(-1)
    out = mcmc_tpu_torch.mala(
        np.zeros(10), lk, mcmc_tpu_torch.MALASettings(
            n_burnin_draws=500, n_keep_draws=300, step_size=3.0),
        n_chains=16, key=0, device="cpu", adapt_step_size=True)
    rate = float(out.accept_rate.mean())
    assert 0.45 < rate < 0.75, rate

    lk = ill_conditioned_gaussian(16, 1e4, device="cpu")
    s = mcmc_tpu_torch.MALASettings(n_burnin_draws=800, n_keep_draws=800,
                                    step_size=0.1)
    kw = dict(n_chains=8, key=0, device="cpu", adapt_step_size=True)
    base = mcmc_tpu_torch.mala(np.zeros(16), lk, s, **kw)
    ada = mcmc_tpu_torch.mala(np.zeros(16), lk, s, adapt_precond=True,
                              pooled_adaptation=True, **kw)
    ess_base = float(td.ess(base.draws).min())
    ess_ada = float(td.ess(ada.draws).min())
    assert ess_ada > 10 * ess_base, (ess_base, ess_ada)
    ratio = ada.diagnostics["precond_var"][0] / lk.variances
    assert bool(((ratio > 0.5) & (ratio < 2.0)).all()), ratio
    vr = ada.draws.reshape(-1, 16).var(0) / lk.variances
    assert bool(((vr > 0.6) & (vr < 1.5)).all()), vr


def test_dense_precond_beats_diag_and_refuses_bounds():
    """On a rho = 0.9 Gaussian the pooled dense preconditioner beats the
    diagonal one on min ESS (tests/test_hmc_mala.py:243-282); dense with
    bounds raises "unbounded-only", as a learned preconditioner beside a
    user ``precond_mat`` raises."""
    rho, dim = 0.9, 6
    cov = (1 - rho) * np.eye(dim) + rho * np.ones((dim, dim))
    prec = torch.from_numpy(np.linalg.inv(cov).astype(np.float32))
    lk = lambda v: -0.5 * (v * (v @ prec)).sum(-1)
    sm = mcmc_tpu_torch.MALASettings(n_burnin_draws=700, n_keep_draws=700,
                                     step_size=0.3)
    ess = {}
    for mode in ("diag", "dense"):
        out = mcmc_tpu_torch.mala(np.zeros(dim), lk, sm, n_chains=16, key=1,
                                  device="cpu", adapt_step_size=True,
                                  adapt_precond=mode, pooled_adaptation=True)
        ess[mode] = float(td.ess(out.draws).min())
    assert ess["dense"] > 2 * ess["diag"], ess
    sb = mcmc_tpu_torch.AlgoSettings(vals_bound=True,
                                     lower_bounds=np.zeros(dim),
                                     upper_bounds=np.full(dim, 9.0))
    with pytest.raises(ValueError, match="unbounded-only"):
        mcmc_tpu_torch.mala(np.ones(dim), lk, sb, n_chains=4, key=2,
                            device="cpu", adapt_precond="dense")
    with pytest.raises(ValueError, match="precond_mat"):
        mcmc_tpu_torch.mala(np.ones(dim), lk, mcmc_tpu_torch.MALASettings(
            precond_mat=np.ones(dim)), device="cpu", adapt_precond=True)
