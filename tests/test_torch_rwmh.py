"""The PyTorch port's random-walk Metropolis (with delayed rejection, and
DRAM) against the JAX package's, on the CPU.

The transition is held exactly: JAX's step under ``jax.vmap`` with the
chain axis named, and the port's transition fed the normals and uniforms
JAX's step draws from its keys (``jax_run`` of
``tests/test_torch_chees.py``): a fixed scale, dual averaging, the windowed
diagonal and (pooled) dense proposal covariance, delayed rejection, DRAM,
and delayed rejection at a wall where the log-kernel is -inf, so that the
two-stage ratio's NaN and ``c_den >= 0`` guards decide stage two. Every
state field at rtol 1e-5 and the accept decisions exactly; the long fed
runs adapt where the loop contracts (Queue C's adaptation drift). The rest
is distributional, on the cases of ``tests/test_rwmh.py`` and
``tests/test_hmc_mala.py`` at smaller sizes.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmc_tpu_torch
from mcmc_tpu import adaptation as jadapt
from mcmc_tpu_torch import adaptation as tadapt
from mcmc_tpu_torch import convert
from mcmc_tpu_torch import diagnostics as td
from mcmc_tpu_torch.models import gaussian_mean_model
from test_torch_chees import (AX, assert_close, check_transitions,
                              gaussian_pair, jax_run, run_fed, start)
from test_torch_nuts import _assert_moment

# the packages' samplers/__init__ re-export the rwmh *function* under the
# module's name
jrwmh_mod = importlib.import_module("mcmc_tpu.samplers.rwmh")
trwmh_mod = importlib.import_module("mcmc_tpu_torch.samplers.rwmh")

D, C, N_TRANS = 4, 32, 62
N_ADAPT = 66          # window ends at draws 33 and 59
SCALE, DR_SHRINK = 0.9, 0.2

# (dual averaging, proposal-covariance mode, pooled, delayed rejection, wall)
CASES = {"fixed": (False, None, False, False, False),
         "adapt": (True, None, False, False, False),
         "diag": (True, "diag", False, False, False),
         "dense_pooled": (True, "dense", True, False, False),
         "dr": (False, None, False, True, False),
         "dram": (True, "dense", True, True, False),
         "dr_wall": (False, None, False, True, True)}
_RUNS = {}
WALL = -1.5


def _pair(wall):
    jlk, tlk = gaussian_pair()
    if not wall:
        return jlk, tlk
    return (lambda x: jnp.where(x[0] > WALL, jlk(x), -jnp.inf),
            lambda x: torch.where(x[..., 0] > WALL, tlk(x), -torch.inf))


def _draws(key):
    k_noise, k_accept, k_noise2, k_accept2 = jax.random.split(key, 4)
    return (jax.random.normal(k_noise, (D,), jnp.float32),
            jax.random.uniform(k_accept, dtype=jnp.float32),
            jax.random.normal(k_noise2, (D,), jnp.float32),
            jax.random.uniform(k_accept2, dtype=jnp.float32))


def _rwmh_case(name, n_burnin):
    """JAX's 62 transitions of the case with ``n_burnin`` transitions of
    dual averaging (cached) and the port's kernel on the same target."""
    adapt, mode, pooled, dr, wall = CASES[name]
    n_burnin = n_burnin if adapt else None
    cfg = {"n_burnin": n_burnin, "target": 0.234} if adapt else None
    jlk, tlk = _pair(wall)
    dr_shrink = DR_SHRINK if dr else None
    x0 = start(3, scale=2.0 if wall else 1.0)
    if (name, n_burnin) not in _RUNS:
        jcfg = None
        if mode:
            jcfg = jadapt.make_precond_cfg(N_ADAPT, pooled, AX)
            jcfg["mode"] = mode
        jinit, jstep = jrwmh_mod.build_rwmh_kernel(
            jlk, lambda v: v, SCALE, cfg, jcfg, dr_shrink)
        st0 = jax.vmap(jinit)(jnp.asarray(x0))
        _RUNS[name, n_burnin] = jax_run(jstep, _draws, st0, N_TRANS, 5)
    tcfg = None
    if mode:
        tcfg = tadapt.make_precond_cfg(N_ADAPT, pooled, "cpu")
        tcfg["mode"] = mode
    tinit, tstep = trwmh_mod.build_rwmh_kernel(tlk, lambda v: v, SCALE, cfg,
                                               tcfg, dr_shrink)
    return x0, tinit, tstep, _RUNS[name, n_burnin]


@pytest.mark.parametrize("name", list(CASES))
def test_rwmh_transition_matches_jax(name):
    """Each of JAX's 62 transitions (both window ends, the end of dual
    averaging at 40), from JAX's state before it and fed its draws: every
    state field and the accepts at rtol 1e-5 (``assert_close``); the
    port's ``init`` gives JAX's first state."""
    x0, tinit, tstep, (states, infos, draws) = _rwmh_case(name, 40)
    with torch.no_grad():
        assert_close(tinit(torch.from_numpy(x0)), states[0], what="init")
        check_transitions(convert.rwmh_state, tstep.transition, states,
                          infos, draws)
    acc = np.mean([i["accepted"].mean() for i in infos])
    assert 0.05 < acc < 0.95, acc
    if CASES[name][4]:
        # chains that start beyond the wall have log_prob -inf: a NaN
        # first-stage ratio, which the guards turn into a rejection
        assert np.isneginf(states[0].log_prob).sum() >= 3


# The port's own run drifts from JAX's by the f32 rounding of two
# summation orders, and dual averaging feeds it back (Queue C): adapting
# only the first 4 transitions (the windowed covariance still adapts
# through both window ends, which restart the scale) the loop contracts:
# every final field is within 2.5e-6 of its scale and the logs within
# 1.9e-7 (measured, the windowed variance of the diag case the largest);
# the run is held to 1e-4.
RUN_BURNIN, RUN_RTOL = 4, 1e-4


@pytest.mark.parametrize("name", list(CASES))
def test_rwmh_run_fed_jax_draws(name):
    """The port's 62 transitions from JAX's start, fed JAX's draws: the
    same accept decisions at every transition and the final state within
    ``RUN_RTOL``; one log-kernel evaluation a transition (two with delayed
    rejection) and no host synchronisation."""
    _, _, tstep, (states, infos, draws) = _rwmh_case(name, RUN_BURNIN)
    with torch.no_grad():
        final = run_fed(convert.rwmh_state, tstep.transition, states, infos,
                        draws)
    assert_close(final, states[-1], RUN_RTOL, "final state")
    evals = (2 if CASES[name][3] else 1) * N_TRANS
    assert tstep.counts == {"draws": N_TRANS, "evaluations": evals,
                            "syncs": 0}


def test_convert_round_trip():
    """``convert.rwmh_state`` carries JAX's ``init`` state across and equals
    the port's ``init`` on the same positions, dense and diagonal."""
    for name in ("dense_pooled", "diag"):
        x0, tinit, _, (states, _, _) = _rwmh_case(name, 40)
        got = convert.rwmh_state(states[0], "cpu")
        want = tinit(torch.from_numpy(x0))
        for f, g, w in zip(got._fields, got, want):
            if isinstance(g, tuple):
                for gg, ww in zip(g, w):
                    torch.testing.assert_close(gg, ww, rtol=1e-6, atol=0)
            else:
                assert g.dtype == w.dtype, f
                torch.testing.assert_close(g, w, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# distributional, on the cases of tests/test_rwmh.py and test_hmc_mala.py
# ---------------------------------------------------------------------------

def _gaussian_data():
    x = (2.0 + np.random.default_rng(7).standard_normal(100)).astype(
        np.float32)
    n, s0 = x.shape[0], 2.0
    prec = n + 1.0 / s0 ** 2
    return x, float((x.sum() + 1.0 / s0 ** 2) / prec), 1.0 / prec


def test_rwmh_posterior_mean_many_chains():
    """The Gaussian-mean posterior (tests/test_rwmh.py:34-72): the mean
    within 4 MC standard errors of the analytic one, split R-hat under 1.1,
    acceptance counted after burn-in only."""
    x, post_mean, _ = _gaussian_data()
    lk = gaussian_mean_model(x, device="cpu")
    s = mcmc_tpu_torch.RWMHSettings(n_burnin_draws=300, n_keep_draws=500,
                                    par_scale=0.4)
    out = mcmc_tpu_torch.rwmh(np.array([1.0]), lk, s, n_chains=32, key=3,
                              device="cpu")
    assert out.draws.shape == (500, 32, 1)
    assert out.n_accept_draws.shape == (32,)
    assert bool((out.n_accept_draws <= 500).all())
    _assert_moment(out.draws[..., 0], post_mean, "posterior mean")
    assert float(td.split_rhat(out.draws)[0]) < 1.1
    assert 0.05 < float(out.accept_rate.mean()) < 0.99


def test_rwmh_deterministic_and_bounded():
    """One seed repeats bit for bit; a two-sided box keeps every draw inside
    and finds the posterior (tests/test_rwmh.py:75-106)."""
    x, post_mean, post_var = _gaussian_data()
    lk = gaussian_mean_model(x, device="cpu")
    s = mcmc_tpu_torch.RWMHSettings(n_burnin_draws=50, n_keep_draws=50,
                                    par_scale=0.4)
    a = mcmc_tpu_torch.rwmh(np.array([1.0]), lk, s, key=0, device="cpu")
    b = mcmc_tpu_torch.rwmh(np.array([1.0]), lk, s, key=0, device="cpu")
    assert torch.equal(a.draws, b.draws)
    algo = mcmc_tpu_torch.AlgoSettings(
        rng_seed_value=11, vals_bound=True, lower_bounds=np.array([0.5]),
        upper_bounds=np.array([10.0]),
        rwmh_settings=mcmc_tpu_torch.RWMHSettings(
            n_burnin_draws=300, n_keep_draws=300, par_scale=0.5))
    out = mcmc_tpu_torch.rwmh(np.array([1.0]), lk, algo, n_chains=16,
                              device="cpu")
    d = out.draws
    assert bool(((d >= 0.5) & (d <= 10.0)).all())
    assert abs(float(d.mean()) - post_mean) < 5 * math.sqrt(post_var)


def _ks_normal(x):
    x = np.sort(x.astype(np.float64))
    n = len(x)
    cdf = 0.5 * (1.0 + np.vectorize(math.erf)(x / math.sqrt(2.0)))
    return max(np.max(np.arange(1, n + 1) / n - cdf),
               np.max(cdf - np.arange(0, n) / n)), n


def test_delayed_rejection_exactness_ks():
    """At an overshooting scale (6) the stage-two ratio keeps N(0, 1)
    invariant (KS at the 0.1% level on thinned draws), and the fallback
    more than doubles the plain chain's acceptance
    (tests/test_rwmh.py:109-131)."""
    lk = lambda v: -0.5 * (v ** 2).sum(-1)
    s = mcmc_tpu_torch.RWMHSettings(n_burnin_draws=300, n_keep_draws=2000,
                                    par_scale=6.0)
    kw = dict(n_chains=16, key=20, device="cpu")
    dr = mcmc_tpu_torch.rwmh(np.zeros(1), lk, s, delayed_rejection=True,
                             **kw)
    plain = mcmc_tpu_torch.rwmh(np.zeros(1), lk, s, **kw)
    acc_dr = float(dr.accept_rate.mean())
    acc_plain = float(plain.accept_rate.mean())
    assert acc_dr > 2.0 * acc_plain, (acc_dr, acc_plain)
    ks, n = _ks_normal(dr.draws[::8, :, 0].reshape(-1).numpy())
    assert ks < 1.95 / math.sqrt(n), ks


def test_dram_composition():
    """DRAM (dense pooled covariance with dual averaging and delayed
    rejection) on a correlated 2-d Gaussian recovers its covariance
    (tests/test_rwmh.py:134-148); the learned proposal covariance is
    ``pchol pchol^T``, one for all chains."""
    cov = np.array([[2.0, 0.9], [0.9, 1.0]], np.float32)
    prec = torch.from_numpy(np.linalg.inv(cov).astype(np.float32))
    lk = lambda v: -0.5 * (v * (v @ prec)).sum(-1)
    out = mcmc_tpu_torch.rwmh(
        np.zeros(2), lk, mcmc_tpu_torch.RWMHSettings(n_burnin_draws=800,
                                                     n_keep_draws=1200),
        n_chains=64, key=21, device="cpu", adapt_scale=True,
        adapt_precond="dense", pooled_adaptation=True,
        delayed_rejection=True)
    d = out.draws.reshape(-1, 2).numpy()
    np.testing.assert_allclose(np.cov(d.T), cov, rtol=0.2, atol=0.1)
    assert 0.1 < float(out.accept_rate.mean()) < 0.9
    pv = out.diagnostics["proposal_var"]
    assert pv.shape == (64, 2, 2) and bool((pv == pv[0]).all())
    assert out.diagnostics["adapted_scale"].shape == (64,)


def test_scale_adaptation_hits_target_and_precond_helps():
    """Dual averaging lands the acceptance near 0.234 from a scale of 5
    (tests/test_hmc_mala.py:119-131); on the 16-d ill-conditioned Gaussian
    the pooled diagonal covariance beats the plain walk on min ESS
    (tests/test_hmc_mala.py:197-211)."""
    lk = lambda v: -0.5 * (v ** 2).sum(-1)
    out = mcmc_tpu_torch.rwmh(
        np.zeros(10), lk, mcmc_tpu_torch.RWMHSettings(
            n_burnin_draws=800, n_keep_draws=500, par_scale=5.0),
        n_chains=16, key=0, device="cpu", adapt_scale=True)
    rate = float(out.accept_rate.mean())
    assert 0.15 < rate < 0.35, rate
    assert out.diagnostics["adapted_scale"].shape == (16,)

    from mcmc_tpu_torch.models import ill_conditioned_gaussian
    lk = ill_conditioned_gaussian(16, 1e4, device="cpu")
    s = mcmc_tpu_torch.RWMHSettings(n_burnin_draws=1000, n_keep_draws=1000,
                                    par_scale=0.5)
    kw = dict(n_chains=8, key=0, device="cpu", adapt_scale=True)
    base = mcmc_tpu_torch.rwmh(np.zeros(16), lk, s, **kw)
    ada = mcmc_tpu_torch.rwmh(np.zeros(16), lk, s, adapt_precond=True,
                              pooled_adaptation=True, **kw)
    ess_base = float(td.ess(base.draws).min())
    ess_ada = float(td.ess(ada.draws).min())
    assert ess_ada > 2 * ess_base, (ess_base, ess_ada)


def test_options_and_validation():
    """JAX's errors for a learned covariance beside a user ``cov_mat`` and
    an unknown mode; a user ``cov_mat`` shapes the walk; ``thin`` and
    ``return_resume``."""
    lk = lambda v: -0.5 * (v ** 2).sum(-1)
    s = mcmc_tpu_torch.RWMHSettings(n_burnin_draws=10, n_keep_draws=20,
                                    cov_mat=np.eye(2))
    with pytest.raises(ValueError, match="cov_mat"):
        mcmc_tpu_torch.rwmh(np.zeros(2), lk, s, device="cpu",
                            adapt_precond=True)
    with pytest.raises(ValueError, match="adapt_precond"):
        mcmc_tpu_torch.rwmh(np.zeros(2), lk, mcmc_tpu_torch.RWMHSettings(),
                            device="cpu", adapt_precond="full")
    out = mcmc_tpu_torch.rwmh(np.zeros(2), lk, s, n_chains=4, key=1,
                              device="cpu", thin=3, return_resume=True)
    assert out.draws.shape == (20, 4, 2) and out.diagnostics["thin"] == 3
    assert bool((out.accept_rate <= 1.0).all())
    more = out.diagnostics["resume"](2, 5)
    assert more.draws.shape == (5, 4, 2)
