"""The PyTorch port's generalized HMC (persistent momentum, Horowitz 1991)
against the JAX package's, on the CPU.

The transition is held exactly: JAX's step under ``jax.vmap``, the port's
transition fed the normals and uniforms JAX's step draws from its keys
(``jax_run`` of ``tests/test_torch_chees.py``), with and without dual
averaging and step-size jitter, on a correlated Gaussian. The rest is
distributional, on the cases of ``tests/test_ghmc.py`` at smaller sizes:
moments within 4 Monte-Carlo standard errors of the exact answer (the
skewed, bounded target has power over a missing momentum flip), and the
adapted step size within the spread of 8 JAX seeds.
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
from mcmc_tpu.samplers import common as jcommon
from mcmc_tpu_torch import convert
from mcmc_tpu_torch import integrators as tint
from mcmc_tpu_torch.samplers import common as tcommon
from test_torch_chees import (AX, assert_close, check_transitions,
                              gaussian_pair, jax_run, run_fed, start)
from test_torch_nuts import JAX_SEEDS, _assert_in_seed_spread, _assert_moment

jghmc = importlib.import_module("mcmc_tpu.samplers.ghmc")
tghmc = importlib.import_module("mcmc_tpu_torch.samplers.ghmc")

D, C, N_TRANS = 4, 32, 62
ALPHA, N_LEAP = 0.9, 3

# (dual averaging, jitter, diagonal preconditioner)
CASES = {"adapt_jitter": (True, 0.2, None),
         "adapt": (True, 0.0, None),
         "jitter_diag_precond": (False, 0.3, [0.5, 1.0, 2.0, 4.0]),
         "fixed": (False, 0.0, None)}
_RUNS = {}


def _ghmc_case(name, n_burnin):
    """JAX's 62 transitions of the case with ``n_burnin`` transitions of
    dual averaging (cached) and the port's kernel."""
    adapt, jitter, precond = CASES[name]
    n_burnin = n_burnin if adapt else None
    cfg = {"n_burnin": n_burnin, "target": 0.95} if adapt else None
    jlk, tlk = gaussian_pair()
    if (name, n_burnin) not in _RUNS:
        jinit, jstep = jghmc.build_ghmc_kernel(
            jlk, jax.grad(jlk), jcommon.make_spd(precond, D, jnp.float32),
            0.4, ALPHA, N_LEAP, jitter, cfg)

        def draws(key):
            k_mom, k_jit, k_acc = jax.random.split(key, 3)
            return (jax.random.normal(k_mom, (D,), jnp.float32),
                    jax.random.uniform(k_jit, dtype=jnp.float32)
                    if jitter > 0.0 else None,
                    jax.random.uniform(k_acc, dtype=jnp.float32))

        st0 = jax.vmap(jinit)(jnp.asarray(start(3)))
        _RUNS[name, n_burnin] = jax_run(jstep, draws, st0, N_TRANS, 4)
    tinit, tstep = tghmc.build_ghmc_kernel(
        tlk, tint.grad_of(tlk), tcommon.make_spd(precond, D, torch.float32),
        0.4, ALPHA, N_LEAP, jitter, cfg)
    return tinit, tstep, _RUNS[name, n_burnin]


@pytest.mark.parametrize("name", list(CASES))
def test_ghmc_transition_matches_jax(name):
    """Each of JAX's 62 transitions (the end of dual averaging at 40
    included), from JAX's state before it and fed its draws: every state
    field and info at rtol 1e-5 (``assert_close``), the accept decisions
    exactly; the port's ``init`` gives JAX's first state. Rejections occur,
    so the momentum flip is exercised."""
    tinit, tstep, (states, infos, draws) = _ghmc_case(name, 40)
    with torch.no_grad():
        assert_close(tinit(torch.from_numpy(start(3))), states[0],
                     what="init")
        check_transitions(convert.ghmc_state, tstep.transition, states,
                          infos, draws)
    rejected = sum(int((~i["accepted"]).sum()) for i in infos)
    assert 0 < rejected < 0.5 * N_TRANS * C, rejected


# The port's own run drifts from JAX's by the f32 rounding of two
# summation orders. Per-chain dual averaging feeds that back: over 40
# adapting transitions the positions drifted from 5e-7 to 1e-4 after 6
# transitions, and an accept decision differed after 18-26 (measured). A
# Gaussian's leapfrog is linear, so after adaptation the drift stops
# growing: with 4 adapting transitions every field of the final state is
# within 1.3e-4 of its scale and the logs within 2.2e-5, without adaptation
# within 5.3e-7 (measured); the run is held to 1e-3.
RUN_BURNIN, RUN_RTOL = 4, 1e-3


@pytest.mark.parametrize("name", list(CASES))
def test_ghmc_run_fed_jax_draws(name):
    """The port's 62 transitions from JAX's start with 4 of dual averaging,
    fed JAX's draws: the same accept decisions at every transition and the
    final state within ``RUN_RTOL``; no host synchronisation, three
    leapfrogs a transition."""
    _, tstep, (states, infos, draws) = _ghmc_case(name, RUN_BURNIN)
    with torch.no_grad():
        final = run_fed(convert.ghmc_state, tstep.transition, states, infos,
                        draws)
    assert_close(final, states[-1], RUN_RTOL, "final state")
    assert tstep.counts == {"draws": N_TRANS, "leapfrogs": N_LEAP * N_TRANS,
                            "syncs": 0}


# ---------------------------------------------------------------------------
# distributional, on the cases of tests/test_ghmc.py
# ---------------------------------------------------------------------------

_A3 = np.array([[1.0, 0.8, 0.0], [0.8, 1.0, 0.3], [0.0, 0.3, 1.0]],
               np.float32)


def test_adapted_correlated_gaussian_matches_jax():
    """Adapted GHMC on the correlated 3-d Gaussian (tests/test_ghmc.py:
    80-98) at 128 chains, 300 warmup and 300 kept draws: acceptance near
    the 0.95 target, every first and second moment within 4 MC standard
    errors; each chain's adapted step size differs (per-chain dual
    averaging), and their mean lies within the spread of 8 JAX seeds'."""
    prec = np.linalg.inv(_A3).astype(np.float32)
    jlk, tlk = gaussian_pair(prec)
    s = dict(n_burnin_draws=300, n_keep_draws=300)

    def run(key):
        r = mcmc_tpu.ghmc(jnp.zeros(3), jlk, mcmc_tpu.GHMCSettings(**s),
                          n_chains=128, key=key)
        return r.diagnostics["adapted_step_size"].mean()

    j_eps = np.asarray(jax.jit(jax.vmap(run))(
        jax.random.split(jax.random.PRNGKey(0), JAX_SEEDS)))
    out = mcmc_tpu_torch.ghmc(torch.zeros(3), tlk,
                              mcmc_tpu_torch.GHMCSettings(**s), n_chains=128,
                              key=0)
    assert 0.85 < float(out.accept_rate.mean()) <= 1.0
    d = out.draws
    for i in range(3):
        _assert_moment(d[..., i], 0.0, f"mean {i}")
        for j in range(i, 3):
            _assert_moment(d[..., i] * d[..., j], float(_A3[i, j]),
                           f"cov {i}{j}")
    eps = out.diagnostics["adapted_step_size"]
    assert eps.shape == (128,) and len(set(eps.tolist())) > 100
    _assert_in_seed_spread("mean step size", j_eps, eps.mean())
    assert 0.0 < out.diagnostics["momentum_persistence"] < 1.0


def test_exact_on_skewed_bounded_target():
    """Exp(1) through the box transform, high persistence, a fixed large
    step (tests/test_ghmc.py:53-77): the unconstrained target is skewed, so
    a missing momentum flip biases it; mean 1 and second moment 2 within 4
    MC standard errors, with frequent rejections."""
    algo = mcmc_tpu_torch.AlgoSettings(
        vals_bound=True, lower_bounds=np.zeros(1),
        upper_bounds=np.full(1, np.inf),
        ghmc_settings=mcmc_tpu_torch.GHMCSettings(
            n_burnin_draws=100, n_keep_draws=300, step_size=0.9,
            momentum_persistence=0.9, jitter=0.0))
    out = mcmc_tpu_torch.ghmc(torch.ones(1), lambda v: -v.sum(-1), algo,
                              n_chains=256, key=1, adapt_step_size=False,
                              bounded_grad="exact")
    assert 0.3 < float(out.accept_rate.mean()) < 0.995
    x = out.draws[..., 0]
    assert bool((x > 0).all())
    _assert_moment(x, 1.0, "mean")
    _assert_moment(x ** 2, 2.0, "second moment")


def test_alpha_zero_fixed_step_is_hmc():
    """Persistence 1e-9, no jitter, a fixed step of 0.9 and 3 leapfrogs
    (tests/test_ghmc.py:101-115): N(0, 1) moments within 4 MC standard
    errors."""
    out = mcmc_tpu_torch.ghmc(
        torch.zeros(2), lambda v: -0.5 * (v ** 2).sum(-1),
        mcmc_tpu_torch.GHMCSettings(n_burnin_draws=50, n_keep_draws=200,
                                    step_size=0.9, momentum_persistence=1e-9,
                                    jitter=0.0, n_leap_steps=3),
        n_chains=64, key=3, adapt_step_size=False)
    for k in range(2):
        _assert_moment(out.draws[..., k], 0.0, f"mean {k}")
        _assert_moment(out.draws[..., k] ** 2, 1.0, f"variance {k}")
    assert "adapted_step_size" not in out.diagnostics


def test_auto_alpha_validation_and_options(tmp_path):
    """Auto persistence ``exp(-step_size / sqrt(dim))`` from the nominal
    step; JAX's ``ValueError`` messages for out-of-range persistence and
    jitter; ``thin`` and ``return_resume``; a single chain squeezes; mesh
    raises; checkpoint_dir= gives the in-memory run's draws."""
    lk = lambda v: -0.5 * (v ** 2).sum(-1)
    s = mcmc_tpu_torch.GHMCSettings(n_burnin_draws=20, n_keep_draws=10)
    out = mcmc_tpu_torch.ghmc(torch.zeros(4), lk, s, n_chains=3, key=7,
                              thin=2, return_resume=True)
    assert out.draws.shape == (10, 3, 4)
    assert out.diagnostics["momentum_persistence"] == math.exp(-0.25 / 2.0)
    assert out.diagnostics["thin"] == 2
    assert out.diagnostics["energy_error"].shape == (10, 3)
    more = out.diagnostics["resume"](8, 5)
    assert more.draws.shape == (5, 3, 4)
    one = mcmc_tpu_torch.ghmc(torch.zeros(2), lk, s, key=1)
    assert one.draws.shape == (10, 2)
    assert one.diagnostics["energy_error"].shape == (10,)
    assert one.diagnostics["adapted_step_size"].shape == ()
    for bad, match in ((dict(momentum_persistence=1.5),
                        "momentum_persistence"), (dict(jitter=-0.1),
                                                  "jitter")):
        msgs = []
        for pkg, x0, k in ((mcmc_tpu, jnp.zeros(2),
                            lambda v: -jnp.sum(v ** 2)),
                           (mcmc_tpu_torch, torch.zeros(2), lk)):
            with pytest.raises(ValueError, match=match) as e:
                pkg.ghmc(x0, k, pkg.GHMCSettings(**bad))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    assert torch.equal(
        mcmc_tpu_torch.ghmc(torch.zeros(2), lk, s, key=4).draws,
        mcmc_tpu_torch.ghmc(torch.zeros(2), lk, s, key=4,
                            checkpoint_dir=tmp_path / "ck",
                            checkpoint_every=7).draws)
    with pytest.raises(NotImplementedError, match="A12"):
        mcmc_tpu_torch.ghmc(torch.zeros(2), lk, s, mesh=object())


def test_same_seed_same_draws():
    """Two CPU runs with one seed are bit-equal; another seed is not."""
    lk = lambda v: -0.5 * (v ** 2).sum(-1)
    s = mcmc_tpu_torch.GHMCSettings(n_burnin_draws=20, n_keep_draws=10)
    a = mcmc_tpu_torch.ghmc(torch.zeros(2), lk, s, n_chains=8, key=9)
    b = mcmc_tpu_torch.ghmc(torch.zeros(2), lk, s, n_chains=8, key=9)
    c = mcmc_tpu_torch.ghmc(torch.zeros(2), lk, s, n_chains=8, key=10)
    assert torch.equal(a.draws, b.draws)
    assert not torch.equal(a.draws, c.draws)
