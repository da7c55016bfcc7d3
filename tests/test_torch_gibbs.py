"""The PyTorch port's block Gibbs sampler against the JAX package's, on the
CPU.

A sweep is held exactly: JAX's step under ``jax.vmap`` and the port's
transition fed, block by block, the random numbers JAX's step takes from
the block's key (``split(key, n_blocks)``): an RWMH block's normals and
uniform, an HMC block's momenta and uniform (the port's
``build_hmc_kernel`` split into ``draw`` and ``transition`` for this), a
slice block's sweep numbers (``slice_draws`` of
``tests/test_torch_slice_sampler.py``), and an exact block's normals, which
the test's conditional ``fn(gen, full)`` takes in place of the generator.
The cases: the bivariate normal with two exact conditionals; an RWMH and an
HMC block with dual averaging on a correlated Gaussian; a slice block with
an exact block; and a bounded problem with an exact block in the
constrained space and an RWMH block. Every state field of every block at
rtol 1e-5, and the accept decisions and ``block_accepted`` exactly, for a
block of each method. The anchor is ``tests/test_gibbs.py``'s exact
conditionals on the bivariate normal; the validation errors are JAX's.
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
from mcmc_tpu_torch.samplers import common as tcommon
from test_torch_chees import assert_close, jax_run, start
from test_torch_slice_sampler import assert_host_state, slice_draws

jgibbs = importlib.import_module("mcmc_tpu.samplers.gibbs")
tgibbs = importlib.import_module("mcmc_tpu_torch.samplers.gibbs")

C, N_TRANS, RHO = 32, 30, 0.8
_SD = math.sqrt(1.0 - RHO ** 2)
_COV3 = np.array([[1.0, 0.5, 0.2], [0.5, 2.0, 0.4], [0.2, 0.4, 0.5]],
                 np.float32)
_PREC3 = np.linalg.inv(_COV3).astype(np.float32)


def _normals(g, shape, like):
    """The exact conditionals' normals: JAX's, fed as ``g``, or drawn from
    the run's generator ``g``."""
    if torch.is_tensor(g):
        return g
    return torch.randn(shape, generator=g, dtype=like.dtype,
                       device=like.device)


def _biv():
    jlk = lambda v: -0.5 * (v[0] ** 2 - 2 * RHO * v[0] * v[1] + v[1] ** 2) \
        / (1 - RHO ** 2)
    tlk = lambda v: -0.5 * (v[:, 0] ** 2 - 2 * RHO * v[:, 0] * v[:, 1]
                            + v[:, 1] ** 2) / (1 - RHO ** 2)

    def jcond(i, j):
        return lambda key, full: RHO * full[j] + _SD * jax.random.normal(
            key, (1,), full.dtype)

    def tcond(i, j):
        return lambda g, full: RHO * full[:, j:j + 1] + _SD * _normals(
            g, (full.shape[0], 1), full)
    return jlk, tlk, jcond, tcond


def _gauss3():
    jp, tp = jnp.asarray(_PREC3), torch.from_numpy(_PREC3)
    return (lambda v: -0.5 * v @ (jp @ v),
            lambda v: -0.5 * ((v @ tp) * v).sum(-1))


def _gauss3_cond():
    """x_2 | x_0, x_1 of the 3-d Gaussian, exactly."""
    s12 = _COV3[2, :2]
    w = np.linalg.solve(_COV3[:2, :2], s12).astype(np.float32)
    sd = float(np.sqrt(_COV3[2, 2] - s12 @ w))
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    return (lambda key, full: (full[:2] @ jw)[None]
            + sd * jax.random.normal(key, (1,), full.dtype),
            lambda g, full: (full[:, :2] @ tw)[:, None]
            + sd * _normals(g, (full.shape[0], 1), full))


def _block_draws(kinds):
    """The random numbers of JAX's Gibbs sweep: one key a block."""
    def draws(key):
        out = []
        for k, (kind, d_b) in zip(jax.random.split(key, len(kinds)), kinds):
            if kind == "exact":
                out.append(jax.random.normal(k, (d_b,), jnp.float32))
            elif kind == "rwmh":
                k_noise, k_accept, _, _ = jax.random.split(k, 4)
                out.append((jax.random.normal(k_noise, (d_b,), jnp.float32),
                            jax.random.uniform(k_accept, dtype=jnp.float32)))
            elif kind == "hmc":
                k_mom, k_accept = jax.random.split(k)
                out.append((jax.random.normal(k_mom, (d_b,), jnp.float32),
                            jax.random.uniform(k_accept, dtype=jnp.float32)))
            else:
                out.append(slice_draws(d_b, 8, 32)(k))
        return tuple(out)
    return draws


def _as_block_tensors(d):
    return tuple(tuple(torch.tensor(np.asarray(x)) for x in bd)
                 if isinstance(bd, tuple) else torch.tensor(np.asarray(bd))
                 for bd in d)


def _spec(name, n_da):
    """(JAX blocks, port blocks, block kinds and widths, JAX and port
    log-kernels, start, bounds)."""
    if name == "exact_pair":
        jlk, tlk, jc, tc = _biv()
        return ([([0], jc(0, 1)), ([1], jc(1, 0))],
                [([0], tc(0, 1)), ([1], tc(1, 0))],
                [("exact", 1), ("exact", 1)], jlk, tlk, start(5, C, 2), {})
    if name == "rwmh_hmc":
        jlk, tlk = _gauss3()
        opts_r = {"scale": 0.9, "target_accept": 0.4}
        opts_h = {"step_size": 0.3, "n_leap_steps": 4}
        return ([([0, 1], "rwmh", opts_r), ([2], "hmc", opts_h)],
                [([0, 1], "rwmh", opts_r), ([2], "hmc", opts_h)],
                [("rwmh", 2), ("hmc", 1)], jlk, tlk, start(6, C, 3), {})
    if name == "slice_exact":
        jlk, tlk = _gauss3()
        jc, tc = _gauss3_cond()
        opts = {"w": 1.5}
        return ([([0, 1], "slice", opts), ([2], jc)],
                [([0, 1], "slice", opts), ([2], tc)],
                [("slice", 2), ("exact", 1)], jlk, tlk, start(7, C, 3), {})
    # bounded: x_1 > 0 with an exact Exp(1) conditional, x_0 ~ N(0, 1) by
    # RWMH (the density factorises)
    jlk = lambda v: -0.5 * v[0] ** 2 - v[1]
    tlk = lambda v: -0.5 * v[:, 0] ** 2 - v[:, 1]
    # Exp(1) by inversion of a normal: -log(1 - Phi(z))
    jc = lambda key, full: -jnp.log1p(-jax.scipy.special.ndtr(
        jax.random.normal(key, (1,), full.dtype)))
    tc = lambda g, full: -torch.log1p(-torch.special.ndtr(
        _normals(g, (full.shape[0], 1), full)))
    x0 = np.abs(start(8, C, 2)) + 0.1
    bounds = dict(vals_bound=True, lower_bounds=np.array([-np.inf, 0.0]),
                  upper_bounds=np.array([np.inf, np.inf]))
    return ([([0], "rwmh"), ([1], jc)], [([0], "rwmh"), ([1], tc)],
            [("rwmh", 1), ("exact", 1)], jlk, tlk, x0.astype(np.float32),
            bounds)


CASES = ["exact_pair", "rwmh_hmc", "slice_exact", "bounded"]
_RUNS = {}


def _case(name, n_da=20):
    jblocks, tblocks, kinds, jlk, tlk, x0, bounds = _spec(name, n_da)
    tprob = tcommon.setup_problem(torch.from_numpy(x0), tlk,
                                  mcmc_tpu_torch.AlgoSettings(**bounds),
                                  None)
    if (name, n_da) not in _RUNS:
        jprob = jcommon.setup_problem(jnp.asarray(x0), jlk,
                                      mcmc_tpu.AlgoSettings(**bounds), None)
        handlers = jgibbs._make_handlers(
            jgibbs._parse_blocks(jblocks, x0.shape[1]), jprob, n_da)
        jinit, jstep = jgibbs.build_gibbs_kernel(jprob.box_log_kernel,
                                                 handlers, jprob)
        st0 = jax.vmap(jinit)(jprob.first_draw)
        _RUNS[name, n_da] = jax_run(jstep, _block_draws(kinds), st0,
                                    N_TRANS, 10)
    blocks = tgibbs._make_blocks(
        tgibbs._parse_blocks(tblocks, x0.shape[1]), tprob, n_da)
    tinit, tstep = tgibbs.build_gibbs_kernel(blocks, tprob)
    return tprob, tinit, tstep, _RUNS[name, n_da]


def assert_gibbs_state(got, want, rtol=1e-5, what=""):
    assert_close({"position": got.position}, {"position": want.position},
                 rtol, what)
    for b, (g, w) in enumerate(zip(got.substates, want.substates)):
        if torch.is_tensor(g):
            assert tuple(g.shape) == np.asarray(w).shape, (what, b)
        else:
            assert_host_state(g, w, rtol, f"{what} block {b}")


@pytest.mark.parametrize("name", CASES)
def test_gibbs_sweep_matches_jax(name):
    """Each of JAX's 30 sweeps (the end of dual averaging at 20) from JAX's
    state before it, fed its random numbers: the position and every
    block's state at rtol 1e-5, ``accepted`` and ``block_accepted``
    exactly; the port's ``init`` gives JAX's first state."""
    tprob, tinit, tstep, (states, infos, draws) = _case(name)
    with torch.no_grad():
        assert_gibbs_state(tinit(tprob.first_draw), states[0], what="init")
        for t, d in enumerate(draws):
            new, info = tstep.transition(convert.gibbs_state(states[t],
                                                             "cpu"),
                                         *_as_block_tensors(d))
            assert_gibbs_state(new, states[t + 1], what=f"after {t}")
            for k in ("accepted", "block_accepted"):
                np.testing.assert_array_equal(info[k].numpy(), infos[t][k],
                                              err_msg=f"{k} of {t}")
    rate = np.mean([i["block_accepted"].mean(axis=0) for i in infos], axis=0)
    for (kind, _), r in zip(_spec(name, 20)[2], rate):
        assert (r == 1.0) if kind == "exact" else (0.05 < r <= 1.0), rate


# Dual averaging multiplies the drift of two summation orders (as for
# Barker, tests/test_torch_barker.py): over 10 adapting sweeps of the RWMH
# and HMC blocks the HMC block's log step parted from JAX's by 7e-3 and the
# positions by 6e-3, with every decision still JAX's; over 4 (as RWMH's own
# long run, tests/test_torch_rwmh.py) the positions stay within 6e-5
# (measured). The long run adapts over its first RUN_DA sweeps.
RUN_DA, RUN_RTOL = 4, 1e-3


@pytest.mark.parametrize("name", CASES)
def test_gibbs_run_fed_jax_draws(name):
    """The port's 30 sweeps from JAX's start, fed JAX's random numbers:
    ``block_accepted`` equal to JAX's at every sweep and the final state
    within ``RUN_RTOL``."""
    _, _, tstep, (states, infos, draws) = _case(name, RUN_DA)
    st = convert.gibbs_state(states[0], "cpu")
    with torch.no_grad():
        for t, d in enumerate(draws):
            st, info = tstep.transition(st, *_as_block_tensors(d))
            np.testing.assert_array_equal(info["block_accepted"].numpy(),
                                          infos[t]["block_accepted"],
                                          err_msg=f"block_accepted of {t}")
    assert_gibbs_state(st, states[-1], RUN_RTOL, "final state")


def test_exact_conditional_gibbs_bivariate_normal():
    """``tests/test_gibbs.py::test_exact_conditional_gibbs_bivariate_normal``
    at a smaller size: the textbook Gibbs sampler with the exact
    conditionals ``fn(gen, full)`` matches the joint's moments; exact
    blocks report accepted."""
    _, tlk, _, tc = _biv()
    out = mcmc_tpu_torch.gibbs(
        np.zeros(2), tlk, mcmc_tpu_torch.GibbsSettings(n_burnin_draws=100,
                                                       n_keep_draws=800),
        blocks=[([0], tc(0, 1)), ([1], tc(1, 0))], n_chains=32, key=0,
        device="cpu")
    d = out.draws.reshape(-1, 2).double().numpy()
    cov = np.cov(d.T)
    assert abs(d.mean(axis=0)).max() < 0.06
    assert abs(cov[0, 0] - 1.0) < 0.08 and abs(cov[1, 1] - 1.0) < 0.08
    assert abs(cov[0, 1] - RHO) < 0.08
    assert bool((out.diagnostics["block_accept_rate"] == 1.0).all())
    assert out.diagnostics["block_methods"] == ["exact", "exact"]


def _ks_stat_vs_normal(x):
    x = np.sort(np.asarray(x, np.float64))
    n = len(x)
    cdf = 0.5 * (1.0 + np.vectorize(math.erf)(x / math.sqrt(2.0)))
    return max(np.max(np.arange(1, n + 1) / n - cdf),
               np.max(cdf - np.arange(0, n) / n))


@pytest.mark.parametrize("method,opts", [
    ("rwmh", {"scale": 2.4}),
    ("hmc", {"step_size": 0.7, "n_leap_steps": 3}),
    ("slice", {"w": 2.0}),
])
def test_mh_within_gibbs_exact_on_standard_normal(method, opts):
    """``tests/test_gibbs.py::test_mh_within_gibbs_exact_on_standard_
    normal`` at a smaller size: on an independent 2-d standard normal each
    conditional is the marginal, so the pooled, thinned draws of both
    blocks pass a KS test at the 5% level."""
    out = mcmc_tpu_torch.gibbs(
        np.zeros(2), lambda v: -0.5 * (v * v).sum(-1),
        mcmc_tpu_torch.GibbsSettings(n_burnin_draws=200, n_keep_draws=1200),
        blocks=[([0], method, opts), ([1], method, opts)], n_chains=16,
        key=3, device="cpu")
    thin = 8 if method == "rwmh" else 4
    samples = out.draws[::thin].reshape(-1).numpy()
    ks = _ks_stat_vs_normal(samples)
    assert ks < 1.95 / math.sqrt(len(samples)), (method, ks)


_BAD_SPECS = [
    [([0, 1], "rwmh")],
    [([0, 1], "rwmh"), ([1, 2], "rwmh")],
    [([0, 1, 2], "nuts")],
    [([0, 1, 3], "rwmh")],
    [([0, 1, 2], "hmc", {"step_sze": 0.1})],
    [([0, 1, 2], "hmc", {"scale": 0.5})],
    [([0, 1, 2], lambda k, v: v, {"adapt": True})],
    [],
    [([0, 1, 2],)],
    [([0.5, 1, 2], "rwmh")],
]


@pytest.mark.parametrize("spec", range(len(_BAD_SPECS)))
def test_block_validation_matches_jax(spec):
    """Every bad block spec of ``tests/test_gibbs.py`` (and three more)
    raises the JAX package's ValueError with its message, from
    ``gibbs``."""
    blocks = _BAD_SPECS[spec]
    with pytest.raises(ValueError) as want:
        jgibbs._parse_blocks(blocks, 3)
    with pytest.raises(ValueError) as got:
        mcmc_tpu_torch.gibbs(np.zeros(3), lambda v: -(v * v).sum(-1),
                             blocks=blocks, device="cpu")
    assert str(got.value) == str(want.value)


def test_same_seed_same_draws_thin_and_resume():
    """One seed, one run (an exact block drawing from the generator
    included); ``thin`` counts block accepts over the window; the warm
    resume continues."""
    _, tlk, _, tc = _biv()
    run = lambda k, thin=1: mcmc_tpu_torch.gibbs(
        np.zeros(2), tlk, mcmc_tpu_torch.GibbsSettings(n_burnin_draws=5,
                                                       n_keep_draws=10),
        blocks=[([0], "slice"), ([1], tc(1, 0))], n_chains=4, key=k,
        thin=thin, return_resume=True, device="cpu")
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a.draws, b.draws)
    assert not torch.equal(a.draws, c.draws)
    t = run(1, thin=3)
    assert t.diagnostics["block_accept_rate"].shape == (4, 2)
    assert float(t.diagnostics["block_accept_rate"].max()) <= 1.0
    assert a.diagnostics["resume"](3, 4).draws.shape == (4, 4, 2)
