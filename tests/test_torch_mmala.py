"""The PyTorch port's simplified manifold MALA against the JAX package's,
on the CPU.

The transition is held exactly: JAX's step under ``jax.vmap`` with the
chain axis named, and the port's transition fed the normals and the accept
uniform JAX's step draws from its keys (``jax_run`` of
``tests/test_torch_chees.py``): the Fisher metric on the (mu, sigma)
posterior (unbounded, and with sigma bounded below by 0, the metric at the
unconstrained point), the position-dependent metric ``(1 + |x|^2) I`` with a
fixed step and with dual averaging, and a metric that is not positive
definite past ``|x_0| = 1.39``, where JAX's Cholesky factor is NaN and the
port's ``cholesky_ex`` status marks it so: those proposals are rejected
alike. Every state field at rtol 1e-5 and the accept decisions exactly.
The anchors are ``tests/test_mmala.py``'s at smaller sizes: N(0, 1) stays
invariant under the position-dependent metric (KS), and a constant metric
equal to the target's precision recovers its scales.
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
from mcmc_tpu import models as jmodels
from mcmc_tpu.samplers import common as jcommon
from mcmc_tpu_torch import convert
from mcmc_tpu_torch import models as tmodels
from mcmc_tpu_torch.samplers import common as tcommon
from test_torch_chees import (AX, assert_close, check_transitions,
                              gaussian_pair, jax_run, run_fed, start)

jmmala = importlib.import_module("mcmc_tpu.samplers.mmala")
tmmala = importlib.import_module("mcmc_tpu_torch.samplers.mmala")

C, N_TRANS, N_DATA = 32, 40, 50
_X = (2.0 + 2.0 * np.random.default_rng(0).standard_normal(N_DATA)
      ).astype(np.float32)


def _position_metric():
    return (lambda z: (1.0 + z @ z) * jnp.eye(z.shape[0]),
            lambda z: (1.0 + (z * z).sum(-1))[:, None, None]
            * torch.eye(z.shape[1]))


def _not_pd_metric():
    """diag(1.94 - x_0^2, 1, ...): indefinite past |x_0| = sqrt(1.94)."""
    def jm(z):
        return jnp.diag(jnp.ones_like(z).at[0].set(1.94 - z[0] ** 2))

    def tm(z):
        d = torch.ones_like(z)
        d[:, 0] = 1.94 - z[:, 0] ** 2
        return torch.diag_embed(d)
    return jm, tm


# target, metric, step, dual averaging, bounded
CASES = {"fisher": ("ms", "fisher", 0.8, False, False),
         "fisher_bounded": ("ms", "fisher", 0.8, False, True),
         "position_metric": ("gauss", "position", 1.2, False, False),
         "position_metric_adapt": ("gauss", "position", 1.2, True, False),
         "not_pd": ("gauss", "not_pd", 1.0, False, False)}
_RUNS = {}


def _draws_of(d):
    def draws(key):
        k_noise, k_accept = jax.random.split(key)
        return (jax.random.normal(k_noise, (d,), jnp.float32),
                jax.random.uniform(k_accept, dtype=jnp.float32))
    return draws


def _case(name, n_da=20):
    target, metric, step, adapt, bounded = CASES[name]
    if target == "ms":
        jlk = jmodels.gaussian_mean_scale_model(jnp.asarray(_X))
        tlk = tmodels.gaussian_mean_scale_model(_X, device="cpu")
        x0 = np.stack([_X.mean() + 0.2 * start(1, d=1)[:, 0],
                       _X.std() * (1.0 + 0.1 * np.abs(start(2, d=1)[:, 0]))],
                      axis=1).astype(np.float32)
        jm, tm = (jmodels.normal_fisher_metric(N_DATA),
                  tmodels.normal_fisher_metric(N_DATA))
    else:
        jlk, tlk = gaussian_pair()
        x0 = start(3, scale=0.5)
        jm, tm = (_position_metric() if metric == "position"
                  else _not_pd_metric())
    kw = dict(vals_bound=True, lower_bounds=np.array([-np.inf, 0.0]),
              upper_bounds=np.array([np.inf, np.inf])) if bounded else {}
    cfg = {"n_burnin": n_da, "target": 0.574} if adapt else None
    tprob = tcommon.setup_problem(torch.from_numpy(x0), tlk,
                                  mcmc_tpu_torch.AlgoSettings(**kw), None)
    key = (name, n_da if adapt else None)
    if key not in _RUNS:
        jprob = jcommon.setup_problem(jnp.asarray(x0), jlk,
                                      mcmc_tpu.AlgoSettings(**kw), None)
        jinit, jstep = jmmala.build_mmala_kernel(jprob.box_log_kernel, jm,
                                                 step, cfg)
        st0 = jax.vmap(jinit, axis_name=AX)(jprob.first_draw)
        _RUNS[key] = jax_run(jstep, _draws_of(x0.shape[1]), st0, N_TRANS, 8)
    tinit, tstep = tmmala.build_mmala_kernel(tprob.box_log_kernel, tm, step,
                                             cfg)
    return tprob, tinit, tstep, _RUNS[key]


@pytest.mark.parametrize("name", list(CASES))
def test_mmala_transition_matches_jax(name):
    """Each of JAX's 40 transitions (the end of dual averaging at 20), from
    JAX's state before it and fed its draws: every state field at rtol 1e-5
    (the Cholesky factor included), the accept decisions exactly; the
    port's ``init`` gives JAX's first state; both accepts and rejections
    occur, and in the ``not_pd`` case no chain that starts inside the
    indefinite boundary crosses it, and one that starts past it (NaN
    factor) never moves."""
    tprob, tinit, tstep, (states, infos, draws) = _case(name)
    with torch.no_grad():
        assert_close(tinit(tprob.first_draw), states[0], what="init")
        check_transitions(convert.mmala_state, tstep.transition, states,
                          infos, draws)
    acc = np.mean([i["accepted"].mean() for i in infos])
    assert 0.05 < acc < 0.99, acc
    if name == "not_pd":
        x0 = np.abs(np.stack([s.position[:, 0] for s in states]))
        inside = x0[0] < np.sqrt(1.94)
        assert inside.sum() >= C - 2 and (x0[:, inside] < np.sqrt(1.94)).all()
        assert (~inside).any() and (x0[:, ~inside] == x0[0, ~inside]).all()


# Dual averaging multiplies the drift of two summation orders (as for
# Barker, tests/test_torch_barker.py): the long run adapts over its first
# RUN_DA transitions only
RUN_DA, RUN_RTOL = 10, 1e-3


@pytest.mark.parametrize("name", list(CASES))
def test_mmala_run_fed_jax_draws(name):
    """The port's 40 transitions from JAX's start, fed JAX's draws: the
    same accept decisions at every transition and the final state within
    ``RUN_RTOL``; one gradient and one metric a transition, and no host
    synchronisation."""
    _, _, tstep, (states, infos, draws) = _case(name, RUN_DA)
    with torch.no_grad():
        final = run_fed(convert.mmala_state, tstep.transition, states,
                        infos, draws)
    assert_close(final, states[-1], RUN_RTOL, "final state")
    assert tstep.counts == {"draws": N_TRANS, "gradients": N_TRANS,
                            "metrics": N_TRANS, "syncs": 0}


def _ks_vs_normal(x):
    x = np.sort(np.asarray(x, np.float64))
    n = len(x)
    cdf = 0.5 * (1.0 + np.vectorize(math.erf)(x / math.sqrt(2.0)))
    return max(np.max(np.arange(1, n + 1) / n - cdf),
               np.max(cdf - np.arange(0, n) / n)), n


def test_exact_under_position_dependent_metric():
    """``tests/test_mmala.py::test_exact_under_position_dependent_metric``
    at a smaller size: under ``G(x) = (1 + x^2) I`` the MH correction keeps
    N(0, 1) invariant (KS at the 5% level over every 6th draw)."""
    out = mcmc_tpu_torch.mmala(
        np.zeros(1, np.float32), lambda v: -0.5 * (v * v).sum(-1),
        _position_metric()[1], mcmc_tpu_torch.MMALASettings(
            n_burnin_draws=200, n_keep_draws=1500, step_size=1.0),
        n_chains=16, key=0, device="cpu")
    ks, n = _ks_vs_normal(out.draws[::6, :, 0].reshape(-1).numpy())
    assert ks < 1.95 / math.sqrt(n), ks
    assert 0.3 < float(out.accept_rate.mean()) < 0.99


def test_constant_metric_recovers_scales():
    """``tests/test_mmala.py::test_constant_metric_recovers_scales`` at a
    smaller size: ``G`` = the target's precision mixes scales 0.05, 1 and
    20 at one step size (sd within 15%)."""
    scales = torch.tensor([0.05, 1.0, 20.0])
    out = mcmc_tpu_torch.mmala(
        np.zeros(3, np.float32), lambda v: -0.5 * ((v / scales) ** 2).sum(-1),
        lambda z: torch.diag(1.0 / scales ** 2).expand(z.shape[0], 3, 3),
        mcmc_tpu_torch.MMALASettings(n_burnin_draws=200, n_keep_draws=800,
                                     step_size=1.2),
        n_chains=32, key=1, device="cpu")
    sd = out.draws.reshape(-1, 3).std(dim=0)
    np.testing.assert_allclose(sd.numpy(), scales.numpy(), rtol=0.15)


def test_validation_and_seeds():
    """A metric that is not callable raises JAX's TypeError; one seed, one
    run."""
    lk = lambda v: -0.5 * (v * v).sum(-1)
    with pytest.raises(TypeError, match="metric_fn must be callable"):
        mcmc_tpu_torch.mmala(np.zeros(2), lk, None, device="cpu")
    run = lambda k: mcmc_tpu_torch.mmala(
        np.zeros(2, np.float32), lk, _position_metric()[1],
        mcmc_tpu_torch.MMALASettings(n_burnin_draws=5, n_keep_draws=10),
        n_chains=4, key=k, device="cpu", adapt_step_size=True)
    a, b = run(3), run(3)
    assert torch.equal(a.draws, b.draws)
    assert a.diagnostics["adapted_step_size"].shape == (4,)
