"""The PyTorch port's Barker proposal sampler against the JAX package's, on
the CPU.

The transition is held exactly: JAX's step under ``jax.vmap`` with the
chain axis named, and the port's transition fed the normals, the sign
uniforms and the accept uniform JAX's step draws from its keys
(``jax_run`` of ``tests/test_torch_chees.py``), with a fixed step, dual
averaging, and dual averaging with the pooled windowed preconditioner, and
on a bounded problem. Every state field at rtol 1e-5 and the accept
decisions exactly; the long fed runs adapt where the loop contracts. The
rest is distributional, on ``tests/test_barker.py``'s cases at smaller
sizes.
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
from mcmc_tpu_torch.samplers import common as tcommon
from test_torch_chees import (AX, assert_close, check_transitions,
                              gaussian_pair, jax_run, run_fed, start)
from test_torch_nuts import _assert_moment

jbarker = importlib.import_module("mcmc_tpu.samplers.barker")
tbarker = importlib.import_module("mcmc_tpu_torch.samplers.barker")

D, C, N_TRANS = 4, 32, 62
N_ADAPT = 66          # window ends at draws 33 and 59
STEP = 0.8
_LB = np.array([-np.inf, 0.0, -np.inf, -1.0], np.float32)
_UB = np.array([np.inf, np.inf, 2.0, 3.0], np.float32)

# (bounded, dual averaging, preconditioner adaptation, pooled)
CASES = {"fixed": (False, False, False, False),
         "bounded": (True, False, False, False),
         "adapt": (False, True, False, False),
         "adapt_precond": (False, True, True, False),
         "adapt_precond_pooled": (False, True, True, True)}
_RUNS = {}


def _start():
    x = start(3)
    x[:, 1] = np.abs(x[:, 1]) + 0.1
    x[:, 2] = np.minimum(x[:, 2], 1.9)
    x[:, 3] = np.clip(x[:, 3], -0.9, 2.9)
    return x


def _draws(key):
    k_noise, k_sign, k_accept = jax.random.split(key, 3)
    return (jax.random.normal(k_noise, (D,), jnp.float32),
            jax.random.uniform(k_sign, (D,), jnp.float32),
            jax.random.uniform(k_accept, dtype=jnp.float32))


def _case(name, n_da):
    """JAX's 62 transitions of the case, with ``n_da`` transitions of dual
    averaging toward 0.574 (cached), and the port's problem and kernel."""
    bounded, adapt, precond, pooled = CASES[name]
    cfg = {"n_burnin": n_da, "target": 0.574} if adapt else None
    jlk, tlk = gaussian_pair()
    kw = dict(vals_bound=True, lower_bounds=_LB, upper_bounds=_UB) \
        if bounded else {}
    x0 = _start()
    tprob = tcommon.setup_problem(torch.from_numpy(x0), tlk,
                                  mcmc_tpu_torch.AlgoSettings(**kw), None)
    key = (name, n_da if adapt else None)
    if key not in _RUNS:
        jprob = jcommon.setup_problem(jnp.asarray(x0), jlk,
                                      mcmc_tpu.AlgoSettings(**kw), None)
        jcfg = jadapt.make_precond_cfg(N_ADAPT, pooled, AX) \
            if precond else None
        jinit, jstep = jbarker.build_barker_kernel(jprob, STEP, cfg, jcfg)
        st0 = jax.vmap(jinit, axis_name=AX)(jprob.first_draw)
        _RUNS[key] = jax_run(jstep, _draws, st0, N_TRANS, 6)
    tcfg = tadapt.make_precond_cfg(N_ADAPT, pooled, "cpu") \
        if precond else None
    tinit, tstep = tbarker.build_barker_kernel(tprob, STEP, cfg, tcfg)
    return tprob, tinit, tstep, _RUNS[key]


@pytest.mark.parametrize("name", list(CASES))
def test_barker_transition_matches_jax(name):
    """Each of JAX's 62 transitions (both window ends, the end of dual
    averaging at 40), from JAX's state before it and fed its draws: every
    state field at rtol 1e-5, the accept decisions exactly; the port's
    ``init`` gives JAX's first state; both accepts and rejections
    occur."""
    tprob, tinit, tstep, (states, infos, draws) = _case(name, 40)
    with torch.no_grad():
        assert_close(tinit(tprob.first_draw), states[0], what="init")
        check_transitions(convert.barker_state, tstep.transition, states,
                          infos, draws)
    acc = np.mean([i["accepted"].mean() for i in infos])
    assert 0.05 < acc < 0.99, acc


# The port's own run drifts from JAX's by the f32 rounding of two
# summation orders, and dual averaging multiplies that drift (its iterate is
# mu - h sqrt(t) / 0.05): over 40 adapting transitions the largest field
# error grew from 1e-6 to 1e-3 (fixed preconditioner) and to 1e-2 (the
# per-chain windowed one, after the window end at 33), with the accept
# decisions still JAX's (measured). With dual averaging over the first
# RUN_DA transitions only the loop contracts: the window ends at 33 and 59
# still move the preconditioner, and every final field stays within
# RUN_RTOL.
RUN_DA, RUN_RTOL = 10, 1e-3


@pytest.mark.parametrize("name", list(CASES))
def test_barker_run_fed_jax_draws(name):
    """The port's 62 transitions from JAX's start, fed JAX's draws: the
    same accept decisions at every transition and the final state within
    ``RUN_RTOL``; one gradient a transition and no host
    synchronisation."""
    _, _, tstep, (states, infos, draws) = _case(name, RUN_DA)
    with torch.no_grad():
        final = run_fed(convert.barker_state, tstep.transition, states,
                        infos, draws)
    assert_close(final, states[-1], RUN_RTOL, "final state")
    assert tstep.counts == {"draws": N_TRANS, "gradients": N_TRANS,
                            "syncs": 0}


def test_nonfinite_gradient_and_density_reject():
    """A log-kernel that is NaN (and its gradient NaN) past x = 1 in the
    first coordinate: every proposal there is rejected, the carried
    gradient stays finite and no chain leaves the region."""
    lk = lambda x: torch.where(x[:, 0] < 1.0, -0.5 * (x * x).sum(-1),
                               torch.sqrt(-(x * x).sum(-1) - 1.0))
    out = mcmc_tpu_torch.barker(
        np.zeros(2, np.float32), lk, mcmc_tpu_torch.BarkerSettings(
            n_burnin_draws=50, n_keep_draws=200, step_size=1.0),
        n_chains=16, key=3, device="cpu")
    assert bool(torch.isfinite(out.draws).all())
    assert float(out.draws[..., 0].max()) < 1.0
    assert 0.2 < float(out.accept_rate.mean()) < 1.0


def test_standard_normal_moments_and_adaptation():
    """``tests/test_barker.py``'s adapted run at a smaller size: a 3-d
    standard normal, pooled step and preconditioner adaptation; means
    within 4 MC standard errors of 0, variances near 1, the adapted scale
    the same on every chain (pooled) and acceptance near its 0.574
    target."""
    out = mcmc_tpu_torch.barker(
        np.zeros(3, np.float32), lambda x: -0.5 * (x * x).sum(-1),
        mcmc_tpu_torch.BarkerSettings(n_burnin_draws=300, n_keep_draws=600),
        n_chains=32, key=5, device="cpu", adapt_step_size=True,
        adapt_precond=True, pooled_adaptation=True)
    for j in range(3):
        _assert_moment(out.draws[..., j], 0.0, f"mean {j}")
    var = out.draws.reshape(-1, 3).var(dim=0)
    assert bool(((var > 0.85) & (var < 1.15)).all()), var
    pv = out.diagnostics["precond_var"]
    assert torch.equal(pv, pv[:1].expand_as(pv))
    assert 0.45 < float(out.accept_rate.mean()) < 0.7


def test_same_seed_same_draws_and_resume():
    """One seed, one run; another seed, another; the warm resume
    continues from the final state."""
    run = lambda k: mcmc_tpu_torch.barker(
        np.zeros(2, np.float32), lambda x: -0.5 * (x * x).sum(-1),
        mcmc_tpu_torch.BarkerSettings(n_burnin_draws=10, n_keep_draws=20),
        n_chains=4, key=k, device="cpu", return_resume=True)
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a.draws, b.draws)
    assert not torch.equal(a.draws, c.draws)
    more = a.diagnostics["resume"](9, 5)
    assert more.draws.shape == (5, 4, 2)
