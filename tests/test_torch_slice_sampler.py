"""The PyTorch port's univariate slice sampler against the JAX package's, on
the CPU. (``tests/test_torch_slice.py`` is the port's first slice as a
whole, not this sampler.)

The sweep is held exactly: JAX's step under ``jax.vmap`` with the chain
axis named, and the port's transition fed the random numbers JAX's step
takes from its keys: per coordinate the slice level's and the bracket's
uniforms, the stepping-out budget (``randint``) and the uniforms of the
shrinkage loop's key chain, one split an iteration, as many as the cap.
The cases: a correlated Gaussian at the default width, a narrow width
(long stepping out), per-dimension widths, a shrinkage cap of
2 (capped coordinates), a bounded problem, and pooled and per-chain width
adaptation (window ends at 33 and 59). Every state field at rtol 1e-5, and
the accept decisions and each chain's ``n_evals`` exactly. The anchors are
``tests/test_slice.py``'s at smaller sizes.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from scipy import stats as sps

import mcmc_tpu
import mcmc_tpu_torch
from mcmc_tpu import adaptation as jadapt
from mcmc_tpu.samplers import common as jcommon
from mcmc_tpu_torch import adaptation as tadapt
from mcmc_tpu_torch import convert
from mcmc_tpu_torch.samplers import common as tcommon
from test_torch_chees import (AX, as_tensors, assert_close, gaussian_pair,
                              jax_run, start)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for every test here: the tests run in several
    worker processes at once, and torch's default of a thread per core
    oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


jslice = importlib.import_module("mcmc_tpu.samplers.slice")
tslice = importlib.import_module("mcmc_tpu_torch.samplers.slice")

D, C, N_TRANS = 4, 32, 62
N_ADAPT = 66          # window ends at draws 33 and 59
_LB = np.array([-np.inf, 0.0, -np.inf, -1.0], np.float32)
_UB = np.array([np.inf, np.inf, 2.0, 3.0], np.float32)
_W_DIM = np.array([0.3, 1.0, 2.0, 5.0], np.float32)

# w, max_step_out, max_shrink, bounded, width adaptation (None, pooled)
CASES = {"default": (1.0, 8, 32, False, None),
         "narrow_w": (0.1, 8, 32, False, None),
         "per_dim_w": (_W_DIM, 8, 32, False, None),
         "capped": (4.0, 8, 2, False, None),
         "bounded": (1.0, 8, 32, True, None),
         "adapt_w": (1.0, 8, 32, False, False),
         "adapt_w_pooled": (1.0, 8, 32, False, True)}
_RUNS = {}


def assert_host_state(got, want, rtol=1e-5, what=""):
    """The port's state against JAX's field by field: host counters
    (``int``) equal to each of JAX's batched copies, the rest as
    ``assert_close`` holds it."""
    for name, g in zip(got._fields, got):
        w = getattr(want, name)
        if isinstance(g, int):
            np.testing.assert_array_equal(np.asarray(w).reshape(-1), g,
                                          err_msg=f"{what} {name}")
        else:
            assert_close({name: g}, {name: w}, rtol, what=what)


def slice_draws(d, max_step_out, max_shrink):
    """The random numbers of JAX's slice sweep on ``d`` coordinates, from
    its key (``mcmc_tpu/samplers/slice.py``'s ``step`` and
    ``coord_update``)."""
    def per_coord(k):
        k_y, k_place, k_alloc, k_shrink = jax.random.split(k, 4)

        def body(kk, _):
            kk, sub = jax.random.split(kk)
            return kk, jax.random.uniform(sub, dtype=jnp.float32)

        _, us = lax.scan(body, k_shrink, None, length=max_shrink)
        return (jax.random.uniform(k_y, dtype=jnp.float32),
                jax.random.uniform(k_place, dtype=jnp.float32),
                jax.random.randint(k_alloc, (), 0, max_step_out), us)

    return lambda key: jax.vmap(per_coord)(jax.random.split(key, d))


def _start():
    x = start(3)
    x[:, 1] = np.abs(x[:, 1]) + 0.1
    x[:, 2] = np.minimum(x[:, 2], 1.9)
    x[:, 3] = np.clip(x[:, 3], -0.9, 2.9)
    return x


def _case(name):
    w, mso, msh, bounded, pooled = CASES[name]
    jlk, tlk = gaussian_pair()
    kw = dict(vals_bound=True, lower_bounds=_LB, upper_bounds=_UB) \
        if bounded else {}
    x0 = _start()
    tprob = tcommon.setup_problem(torch.from_numpy(x0), tlk,
                                  mcmc_tpu_torch.AlgoSettings(**kw), None)
    if name not in _RUNS:
        jprob = jcommon.setup_problem(jnp.asarray(x0), jlk,
                                      mcmc_tpu.AlgoSettings(**kw), None)
        jcfg = None if pooled is None else \
            jadapt.make_precond_cfg(N_ADAPT, pooled, AX)
        jinit, jstep = jslice.build_slice_kernel(
            jprob.box_log_kernel, D, jnp.float32, w, mso, msh, jcfg)
        st0 = jax.vmap(jinit)(jprob.first_draw)
        _RUNS[name] = jax_run(jstep, slice_draws(D, mso, msh), st0,
                              N_TRANS, 6)
    tcfg = None if pooled is None else \
        tadapt.make_precond_cfg(N_ADAPT, pooled, "cpu")
    tinit, tstep = tslice.build_slice_kernel(
        tprob.box_log_kernel, D, torch.float32, w, mso, msh, tcfg)
    return tprob, tinit, tstep, _RUNS[name]


@pytest.mark.parametrize("name", list(CASES))
def test_slice_sweep_matches_jax(name):
    """Each of JAX's 62 sweeps from JAX's state before it, fed its random
    numbers: every state field at rtol 1e-5 (the draw counter equal), the
    accept decisions and each chain's ``n_evals`` exactly; the port's
    ``init`` gives JAX's first state. The capped case has sweeps that hit
    the cap, the narrow one long stepping out."""
    tprob, tinit, tstep, (states, infos, draws) = _case(name)
    with torch.no_grad():
        assert_host_state(tinit(tprob.first_draw), states[0], what="init")
        for t, d in enumerate(draws):
            new, info = tstep.transition(convert.slice_state(states[t],
                                                             "cpu"),
                                         *as_tensors(d))
            assert_host_state(new, states[t + 1], what=f"state after {t}")
            for k in ("accepted", "n_evals"):
                np.testing.assert_array_equal(info[k].numpy(), infos[t][k],
                                              err_msg=f"{k} of {t}")
    acc = np.mean([i["accepted"].mean() for i in infos])
    evals = np.mean([i["n_evals"].mean() for i in infos])
    if name == "capped":
        assert 0.1 < acc < 0.9, acc
    else:
        assert acc == 1.0, acc
    if name == "narrow_w":   # about 8 evaluations a coordinate (33.2 a
        # sweep of 4, measured), most of them stepping out
        assert evals > 4 * 7, evals


@pytest.mark.parametrize("name", list(CASES))
def test_slice_run_fed_jax_draws(name):
    """The port's 62 sweeps from JAX's start, fed JAX's random numbers:
    the same accept decisions and ``n_evals`` at every sweep and the final
    state within 1e-4 of JAX's; the host synchronisations are the loops'
    end tests, fewer than the evaluations."""
    _, _, tstep, (states, infos, draws) = _case(name)
    st = convert.slice_state(states[0], "cpu")
    with torch.no_grad():
        for t, d in enumerate(draws):
            st, info = tstep.transition(st, *as_tensors(d))
            for k in ("accepted", "n_evals"):
                np.testing.assert_array_equal(info[k].numpy(), infos[t][k],
                                              err_msg=f"{k} of {t}")
    assert_host_state(st, states[-1], 1e-4, "final state")
    c = tstep.counts
    assert c["draws"] == N_TRANS
    assert 0 < c["syncs"] < c["evaluations"], c


def test_uniform_between_is_jax_uniform():
    """``uniform_between`` from JAX's [0, 1) uniform of a key is JAX's
    ``uniform(key, minval, maxval)`` of the same key, bit for bit, on
    brackets of every sign and width."""
    rng = np.random.default_rng(0)
    lo = rng.normal(0.0, 3.0, 4000).astype(np.float32)
    hi = (lo + rng.exponential(2.0, 4000)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), 4000)
    u = jax.vmap(lambda k: jax.random.uniform(k, dtype=jnp.float32))(keys)
    want = jax.vmap(lambda k, a, b: jax.random.uniform(
        k, dtype=jnp.float32, minval=a, maxval=b))(keys, lo, hi)
    got = tslice.uniform_between(torch.tensor(np.asarray(u)),
                                 torch.from_numpy(lo), torch.from_numpy(hi))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ks_exact_standard_normal():
    """``tests/test_slice.py::test_ks_exact_standard_normal`` at its size:
    pooled, thinned draws of N(0, 1) pass a KS test (alpha 0.001) and every
    sweep moves."""
    out = mcmc_tpu_torch.slice_sampler(
        np.zeros(1, np.float32), lambda x: -0.5 * (x * x).sum(-1),
        mcmc_tpu_torch.SliceSettings(n_burnin_draws=200, n_keep_draws=500),
        n_chains=16, key=0, thin=2, device="cpu")
    assert float(out.accept_rate.mean()) == 1.0
    assert sps.kstest(out.draws.reshape(-1).numpy(), "norm").pvalue > 0.001


def test_adapt_w_learns_scales_and_bounded_halfline():
    """Pooled width adaptation on scales 0.1, 1, 10 learns widths near 2.5
    sd, the same on every chain; a half-line-bounded Exp(1) keeps every
    draw positive with mean near 1."""
    sd = torch.tensor([0.1, 1.0, 10.0])
    out = mcmc_tpu_torch.slice_sampler(
        np.zeros(3, np.float32), lambda x: -0.5 * ((x / sd) ** 2).sum(-1),
        mcmc_tpu_torch.SliceSettings(n_burnin_draws=300, n_keep_draws=300),
        n_chains=16, key=1, device="cpu", adapt_w=True,
        pooled_adaptation=True)
    w = out.diagnostics["adapted_w"]
    assert torch.equal(w, w[:1].expand_as(w))
    np.testing.assert_allclose(w[0].numpy(), 2.5 * sd.numpy(), rtol=0.3)
    algo = mcmc_tpu_torch.AlgoSettings(
        vals_bound=True, lower_bounds=np.array([0.0]),
        upper_bounds=np.array([np.inf]),
        slice_settings=mcmc_tpu_torch.SliceSettings(n_burnin_draws=100,
                                                    n_keep_draws=600))
    out = mcmc_tpu_torch.slice_sampler(np.ones(1, np.float32),
                                       lambda x: -x.sum(-1), algo,
                                       n_chains=16, key=2, device="cpu")
    d = out.draws.reshape(-1)
    assert bool((d > 0).all())
    assert abs(float(d.mean()) - 1.0) < 0.1


def test_validation_and_impossible_target():
    """JAX's validation errors; a target that is -inf everywhere but the
    start caps out every sweep in place, accept rate 0."""
    lk = lambda x: -0.5 * (x * x).sum(-1)
    for kw, msg in ((dict(max_step_out=0), "max_step_out"),
                    (dict(max_shrink_steps=0), "max_shrink_steps"),
                    (dict(w=0.0), "w \\(initial bracket width\\)")):
        with pytest.raises(ValueError, match=msg):
            mcmc_tpu_torch.slice_sampler(
                np.zeros(1), lk, mcmc_tpu_torch.SliceSettings(**kw),
                device="cpu")
    spike = lambda x: torch.where((x == 0).all(-1), 0.0, -torch.inf)
    out = mcmc_tpu_torch.slice_sampler(
        np.zeros(2, np.float32), spike, mcmc_tpu_torch.SliceSettings(
            n_burnin_draws=2, n_keep_draws=5, max_shrink_steps=4),
        n_chains=3, key=0, device="cpu")
    assert float(out.accept_rate.max()) == 0.0
    assert bool((out.draws == 0).all())
