"""The PyTorch port's ChEES-HMC and the windowed adaptation it shares with
RWMH and MALA, against the JAX package's, on the CPU.

Exact parts get the same numpy inputs on both sides: the Halton point, the
step count's float -> int cast, the windowed variance and preconditioner
steps (pooled and not), and the transition itself. For that, JAX's step runs
under ``jax.vmap`` with the chain axis named, and the port's transition is
fed the very normals and uniforms that JAX's step draws from its keys
(``jax_run``); every state field and info after one transition agree at
rtol 1e-5, and a run of 62 transitions that crosses two mass-window ends and
the end of warmup makes the same accept decisions. The rest is
distributional, on the cases of ``tests/test_chees.py`` at smaller sizes:
moments within 4 Monte-Carlo standard errors, and the adapted step size and
trajectory length within the spread of 8 JAX seeds run as one ``jax.vmap``.

``jax_run`` and ``assert_close`` serve ``tests/test_torch_ghmc.py`` and
``tests/test_torch_mclmc.py`` too.
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
from mcmc_tpu.models import logistic_regression_model as jlogreg
from mcmc_tpu.samplers import common as jcommon
from mcmc_tpu_torch import adaptation as tadapt
from mcmc_tpu_torch import convert
from mcmc_tpu_torch import diagnostics as td
from mcmc_tpu_torch import integrators as tint
from mcmc_tpu_torch.models import (logistic_regression_model as tlogreg,
                                   make_logistic_regression_data)
from test_torch_nuts import (JAX_SEEDS, _assert_in_seed_spread,
                             _assert_moment, _assert_same_moments)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for every test here: the tests run in several
    worker processes at once, and torch's default of a thread per core
    oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the packages' samplers/__init__ re-export the chees *function* under the
# module's name
jchees = importlib.import_module("mcmc_tpu.samplers.chees")
tchees = importlib.import_module("mcmc_tpu_torch.samplers.chees")
AX = jcommon.CHAIN_AXIS_NAME
RTOL = 1e-5     # one transition, f32 on both sides


# ---------------------------------------------------------------------------
# JAX's transitions with the draws they take from their keys
# ---------------------------------------------------------------------------

def jax_run(jstep, jdraws, state0, n, seed):
    """``n`` transitions of JAX's single-chain ``jstep`` under ``jax.vmap``
    with the chain axis named, each chain with its own key. ``jdraws(key)``
    returns the random numbers ``jstep`` draws from that key. Returns the
    states (``n + 1``, the first ``state0``), the infos and the draws, as
    numpy trees."""
    c = jax.tree_util.tree_leaves(state0)[0].shape[0]
    step = jax.jit(jax.vmap(jstep, axis_name=AX))
    draws_of = jax.jit(jax.vmap(jdraws))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    states, infos, draws = [as_np(state0)], [], []
    st = state0
    for k in jax.random.split(jax.random.PRNGKey(seed), n):
        keys = jax.random.split(k, c)
        draws.append(as_np(draws_of(keys)))
        st, info = step(keys, st)
        states.append(as_np(st))
        infos.append(as_np(info))
    return states, infos, draws


def _named(tree):
    """``(name, leaf)`` pairs of a state (named tuples, nested), an info
    dict or a single array."""
    if not isinstance(tree, (dict, tuple)):
        yield "", tree
        return
    if isinstance(tree, dict):
        items = tree.items()
    else:
        items = zip(tree._fields, tree)
    for name, v in items:
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            yield from ((f"{name}.{k}", x) for k, x in _named(v))
        else:
            yield name, v


# Fields held otherwise than at ``rtol`` of their own scale:
# - probabilities and dual averaging's running mean of them (``h``) on
#   their own scale, 1: exp(-80) carries the f32 error of an energy
#   difference (about 1e-5 relative) into its value;
# - energy differences on the scale of the energies they are differences
#   of (the largest potential or log density before and after);
# - logs at an absolute 1e-4, a relative 1e-4 of the value they are the log
#   of: dual averaging's iterate ``mu - h sqrt(t) / 0.05`` multiplies the
#   error of ``h`` (within 1e-6) by 20 sqrt(t) (measured: up to 1.4e-5);
# - the Adam moments of log T at 1e-4: the pooled ChEES gradient is a
#   difference of two sums of squared distances, which cancel (measured:
#   up to 2.1e-5).
_UNIT_SCALE = ("accept_stat", "da.h")
_ENERGY = ("energy_error", "energy_change")
_LOGS = ("da.log_eps", "da.log_eps_bar", "da.mu", "log_T", "log_L")
_FIELD_RTOL = {"adam_m": 1e-4, "adam_v": 1e-4,
               **{name: 1e-4 for name in _LOGS}}


def _energy_scale(state):
    """The largest magnitude of the state's potential or log density."""
    for name, v in _named(state):
        if name in ("potential", "logdens"):
            v = np.asarray(v)
            return float(np.abs(v[np.isfinite(v)]).max(initial=0.0))
    return 0.0


def assert_close(got, want, rtol=RTOL, what="", energy_scale=0.0):
    """Every leaf of the port's ``got`` against JAX's ``want`` by name:
    integers and booleans equal; floats within ``rtol`` of each element, or
    of the field's largest magnitude for elements near zero (with the
    exceptions above; ``energy_scale`` for the energy differences)."""
    want = dict(_named(want))
    names = []
    for name, g in _named(got):
        g, w = g.numpy(), np.asarray(want[name])
        assert g.shape == w.shape, (what, name, g.shape, w.shape)
        msg = f"{what} {name}"
        r = max(rtol, _FIELD_RTOL.get(name, 0.0))
        if g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=msg)
        elif name in _LOGS:
            np.testing.assert_allclose(g, w, rtol=0, atol=r, err_msg=msg)
        else:
            scale = float(np.abs(w[np.isfinite(w)]).max(initial=0.0))
            if name in _UNIT_SCALE:
                scale = 1.0
            elif name in _ENERGY:
                scale = max(scale, energy_scale)
            np.testing.assert_allclose(g, w, rtol=r, atol=r * scale,
                                       err_msg=msg)
        names.append(name)
    assert sorted(names) == sorted(want), (what, names, list(want))


def as_tensors(draws):
    return [None if d is None else torch.from_numpy(np.array(d))
            for d in draws]


def check_transitions(convert_state, transition, states, infos, draws):
    """Each transition from JAX's state before it, fed JAX's draws, against
    JAX's state after it and its info (``RTOL``)."""
    for t, d in enumerate(draws):
        new, info = transition(convert_state(states[t], "cpu"),
                               *as_tensors(d))
        assert_close(new, states[t + 1], what=f"state after {t}")
        assert_close(info, infos[t], what=f"info of {t}",
                     energy_scale=max(_energy_scale(states[t]),
                                      _energy_scale(states[t + 1])))


def run_fed(convert_state, transition, states, infos, draws):
    """The port's own run from JAX's first state, fed JAX's draws: the
    accept decisions of every transition equal JAX's; returns the final
    state."""
    st = convert_state(states[0], "cpu")
    for t, d in enumerate(draws):
        st, info = transition(st, *as_tensors(d))
        np.testing.assert_array_equal(info["accepted"].numpy(),
                                      infos[t]["accepted"],
                                      err_msg=f"accepts of {t}")
    return st


# ---------------------------------------------------------------------------
# small exact pieces
# ---------------------------------------------------------------------------

def test_vdc_base2_bit_for_bit():
    """The Halton point for n = 1 .. 65,536 and the 1,000 values below
    2^31: bit-equal to JAX's (uint32 shifts there, int64 under a mask
    here)."""
    n = np.concatenate([np.arange(1, 65537),
                        2 ** 31 - 1 - np.arange(1000)]).astype(np.int32)
    want = np.asarray(jax.jit(jchees._vdc_base2)(jnp.asarray(n)))
    got = tchees._vdc_base2(torch.from_numpy(n))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # (0, 1) in exact arithmetic; the f32 rounding of n near 2^31 reaches 1
    assert 0.0 < want.min() and want.max() <= 1.0


def test_leap_count_casts_like_jax():
    """``clip(round(t / eps), 1, max)`` with JAX's float -> int32 cast:
    NaN gives 1 step, +inf and overflow ``max_steps``, -inf 1, halves round
    to even; the same from JAX's own expression."""
    t = np.array([np.nan, np.inf, -np.inf, 1e12, 2.5, 3.5, 0.4, 7.0, 1.0,
                  1.0], np.float32)
    eps = np.array([1, 1, 1, 1, 1, 1, 1, 1, 0, np.nan], np.float32)
    want = np.array([1, 1000, 1, 1000, 2, 4, 1, 7, 1000, 1], np.int32)
    jax_steps = np.asarray(jnp.clip(
        jnp.round(jnp.asarray(t) / jnp.asarray(eps)).astype(jnp.int32), 1,
        1000))
    np.testing.assert_array_equal(jax_steps, want)
    got = tchees._leap_count(torch.from_numpy(t), torch.from_numpy(eps), 1000)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# chains at a window end, collecting, in a fast interval, after warmup
N_ADAPT_AT = 100       # window ends at draws 39 and 89, collecting 15..89
DRAW_IND = np.array([39, 39, 20, 5, 89, 95, 120, 50], np.int32)


def _adapt_inputs(rng, c, d):
    f32 = lambda a: np.asarray(a, np.float32)
    wv = jadapt.WindowedVariance(
        count=np.full((c,), 24, np.int32),
        mean=f32(rng.standard_normal((c, d))),
        m2=f32(24.0 * rng.uniform(0.5, 2.0, (c, d))),
        var=f32(rng.uniform(0.5, 2.0, (c, d))))
    da = jadapt.DualAveraging(*(f32(v) for v in (
        rng.normal(-1.0, 0.3, c), rng.normal(-1.0, 0.3, c),
        rng.normal(0.0, 0.1, c), np.full(c, 20.0),
        rng.normal(1.0, 0.3, c))))
    return wv, da, f32(rng.standard_normal((c, d)))


@pytest.mark.parametrize("pooled", [False, True])
def test_wv_update_matches_jax(pooled):
    """``wv_update`` on every kind of chain of ``DRAW_IND`` (collecting or
    not, at a window end or not) against JAX's under ``vmap``, the pooled
    form against ``lax.pmean`` (rtol 1e-5); pooled, the chains at a window
    end adopt one variance."""
    rng = np.random.default_rng(1)
    c, d = len(DRAW_IND), 3
    wv, _, x = _adapt_inputs(rng, c, d)
    collect, wend = (np.asarray(m)[np.minimum(DRAW_IND, N_ADAPT_AT - 1)]
                     & (DRAW_IND < N_ADAPT_AT)
                     for m in jadapt.window_schedule(N_ADAPT_AT))
    want = jax.vmap(lambda w, xx, a, b: jadapt.wv_update(
        w, xx, a, b, AX if pooled else None), axis_name=AX)(
            wv, x, collect, wend)
    got = tadapt.wv_update(convert._sampler_state(
        tadapt.WindowedVariance, wv, "cpu"), torch.from_numpy(x),
        torch.from_numpy(collect), torch.from_numpy(wend), pooled=pooled)
    assert_close(got, want)
    assert wend.sum() == 3 and (collect & ~wend).sum() == 2
    ends = torch.from_numpy(wend)
    assert pooled == bool((got.var[ends] == got.var[ends][0]).all())


@pytest.mark.parametrize("reset_da", [False, True])
@pytest.mark.parametrize("pooled", [False, True])
@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_windowed_steps_match_jax(kind, pooled, reset_da):
    """``windowed_precond_step`` (diag) and ``windowed_dense_step`` against
    JAX's under ``vmap`` with ``make_precond_cfg(pooled=...)``: each
    chain's draw counter picks its place in the schedule; every output,
    the dual-averaging restart at window ends included, at rtol 1e-5."""
    rng = np.random.default_rng(2)
    c, d = len(DRAW_IND), 3
    wv, da, x = _adapt_inputs(rng, c, d)
    jcfg = jadapt.make_precond_cfg(N_ADAPT_AT, pooled=pooled, axis_name=AX)
    tcfg = tadapt.make_precond_cfg(N_ADAPT_AT, pooled=pooled, device="cpu")
    assert tcfg["pooled"] == pooled and tcfg["n_adapt"] == N_ADAPT_AT
    twv = convert._sampler_state(tadapt.WindowedVariance, wv, "cpu")
    tda = convert._sampler_state(tadapt.DualAveraging, da, "cpu")
    tx, tind = torch.from_numpy(x), torch.from_numpy(DRAW_IND)
    if kind == "diag":
        want = jax.vmap(lambda *a: jadapt.windowed_precond_step(
            *a, jcfg, reset_da), axis_name=AX)(wv, da, x, DRAW_IND)
        got = tadapt.windowed_precond_step(twv, tda, tx, tind, tcfg,
                                           reset_da)
    else:
        a = rng.standard_normal((c, d, 30))
        m2 = np.einsum("cik,cjk->cij", a, a).astype(np.float32)
        cov = np.broadcast_to(np.eye(d, dtype=np.float32), (c, d, d)).copy()
        want = jax.vmap(lambda w, dd, m, xx, i: jadapt.windowed_dense_step(
            w, dd, m[1], m[1], m[0], xx, i, jcfg, reset_da), axis_name=AX)(
                wv, da, (m2, cov), x, DRAW_IND)
        got = tadapt.windowed_dense_step(
            twv, tda, torch.from_numpy(cov), torch.from_numpy(cov.copy()),
            torch.from_numpy(m2), tx, tind, tcfg, reset_da)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, what=f"output {i}")
    # the restart happened exactly at the window ends
    moved = (got[1].t != tda.t).numpy()
    np.testing.assert_array_equal(moved, reset_da & np.isin(DRAW_IND,
                                                            [39, 89]))


# ---------------------------------------------------------------------------
# the transition, fed JAX's draws
# ---------------------------------------------------------------------------

D, C = 4, 32
N_ADAPT, N_TRANS = 66, 62     # window ends at draws 33 and 59 (n_adapt 66)
_SCALES = np.array([0.5, 1.0, 2.0, 3.0], np.float32)
_CORR = np.eye(D, dtype=np.float32)
_CORR[0, 1] = _CORR[1, 0] = 0.6
_COV = (_CORR * _SCALES[:, None] * _SCALES[None, :]).astype(np.float32)
_PREC = np.linalg.inv(_COV).astype(np.float32)


def gaussian_pair(prec=_PREC):
    """The same Gaussian log-density for both packages: JAX's single-chain,
    the port's batched."""
    jp, tp = jnp.asarray(prec), torch.from_numpy(prec)
    return (lambda x: -0.5 * x @ (jp @ x),
            lambda x: -0.5 * (x * (x @ tp)).sum(-1))


def start(seed, c=C, d=D, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal((c, d))
            ).astype(np.float32)


def _chees_draws(key):
    k_mom, k_acc = jax.random.split(key)
    return (jax.random.normal(k_mom, (D,), jnp.float32),
            jax.random.uniform(k_acc, dtype=jnp.float32))


_CHEES_RUNS = {}


def _chees_case(mass, target):
    """JAX's 62 transitions of ChEES with ``mass`` adaptation and accept
    target ``target`` from a fixed start (cached per case), and the port's
    kernel on the same target."""
    jlk, tlk = gaussian_pair()
    kw = dict(step_size=0.3, init_leap_steps=4, target_accept_rate=target)
    if (mass, target) not in _CHEES_RUNS:
        cfg = (jadapt.make_precond_cfg(N_ADAPT, pooled=True, axis_name=AX)
               if mass else None)
        jinit, jstep = jchees.build_chees_kernel(
            jlk, jax.grad(jlk), mcmc_tpu.ChEESSettings(**kw), N_ADAPT, mass,
            cfg)
        st0 = jax.vmap(jinit, axis_name=AX)(jnp.asarray(start(0)))
        _CHEES_RUNS[mass, target] = jax_run(jstep, _chees_draws, st0,
                                            N_TRANS, 1)
    cfg = (tadapt.make_precond_cfg(N_ADAPT, pooled=True, device="cpu")
           if mass else None)
    tinit, tstep = tchees.build_chees_kernel(
        tlk, tint.grad_of(tlk), mcmc_tpu_torch.ChEESSettings(**kw), N_ADAPT,
        mass, cfg)
    return tinit, tstep, _CHEES_RUNS[mass, target]


MASS = [False, "diag", "dense"]


@pytest.mark.parametrize("mass", MASS)
def test_chees_transition_matches_jax(mass):
    """Each of JAX's 62 transitions at the default accept target (both
    window ends, the end of warmup), from JAX's state before it and fed its
    draws: every state field and info at rtol 1e-5, the accept decisions
    and leap counts exactly. The port's ``init`` gives JAX's first
    state."""
    tinit, tstep, (states, infos, draws) = _chees_case(mass, 0.651)
    with torch.no_grad():
        assert_close(tinit(torch.from_numpy(start(0))), states[0],
                     what="init")
        check_transitions(convert.chees_state, tstep.transition, states,
                          infos, draws)
    leaps = np.array([i["n_leap"][0] for i in infos])
    assert leaps.min() >= 1 and len(set(leaps.tolist())) > 3
    acc = np.mean([i["accepted"].mean() for i in infos])
    assert 0.3 < acc < 0.95, acc


# The port's own run drifts from JAX's by the f32 rounding of two
# summation orders, and early in warmup the pooled dual averaging feeds the
# drift back: at the default accept target 0.651 it grew about 1.5x per
# transition (measured: 4e-7 in the positions at the start, 3e-2 after 16
# transitions, an accept decision apart after 20). At a target of 0.95 the
# acceptance is flat in the step size and the loop contracts: after all 62
# transitions every field is within 6.3e-4 of its scale without mass
# adaptation and 1.1e-5 with it (measured), so the run is held to 2e-3.
RUN_TARGET, RUN_RTOL = 0.95, 2e-3


@pytest.mark.parametrize("mass", MASS)
def test_chees_run_fed_jax_draws(mass):
    """The port's 62 transitions from JAX's start at accept target 0.95,
    fed JAX's draws, across both window ends and the end of warmup: the
    same accept decisions at every transition, and every field of the
    final state within ``RUN_RTOL`` of JAX's; one host synchronisation per
    transition."""
    _, tstep, (states, infos, draws) = _chees_case(mass, RUN_TARGET)
    syncs = tstep.counts["syncs"]
    with torch.no_grad():
        final = run_fed(convert.chees_state, tstep.transition, states,
                        infos, draws)
    assert_close(final, states[-1], RUN_RTOL, "final state")
    assert tstep.counts["syncs"] - syncs == N_TRANS


# ---------------------------------------------------------------------------
# distributional, on the cases of tests/test_chees.py
# ---------------------------------------------------------------------------

def _jax_chees_over_seeds(x0, log_kernel, s, n_chains, **kw):
    """``mcmc_tpu.chees`` under ``jax.vmap`` over ``JAX_SEEDS`` keys: each
    seed's adapted step size and trajectory length (chain 0: pooled)."""
    def run(key):
        r = mcmc_tpu.chees(x0, log_kernel, s, n_chains=n_chains, key=key,
                           **kw)
        return (r.diagnostics["adapted_step_size"][0],
                r.diagnostics["adapted_trajectory_length"][0])

    eps, T = jax.jit(jax.vmap(run))(
        jax.random.split(jax.random.PRNGKey(0), JAX_SEEDS))
    return np.asarray(eps), np.asarray(T)


def _assert_adapted_in_spread(out, j_eps, j_T):
    eps = out.diagnostics["adapted_step_size"]
    T = out.diagnostics["adapted_trajectory_length"]
    assert bool((eps == eps[0]).all() and (T == T[0]).all())   # pooled
    _assert_in_seed_spread("step size", j_eps, eps[0])
    _assert_in_seed_spread("trajectory length", j_T, T[0])


def test_standard_normal_matches_jax():
    """3-d standard normal (tests/test_chees.py:15-31) at 128 chains, 150
    warmup and 100 kept draws: mean 0 and variance 1 within 4 MC standard
    errors, acceptance near the 0.651 target, split R-hat < 1.05; the
    adapted step size and T within the spread of 8 JAX seeds."""
    s = dict(n_burnin_draws=150, n_keep_draws=100)
    j_eps, j_T = _jax_chees_over_seeds(
        jnp.zeros(3), lambda v: -0.5 * jnp.sum(v ** 2),
        mcmc_tpu.ChEESSettings(**s), 128)
    out = mcmc_tpu_torch.chees(torch.zeros(3),
                               lambda v: -0.5 * (v ** 2).sum(-1),
                               mcmc_tpu_torch.ChEESSettings(**s),
                               n_chains=128, key=0)
    d = out.draws
    assert d.shape == (100, 128, 3)
    for k in range(3):
        _assert_moment(d[..., k], 0.0, f"mean {k}")
        _assert_moment(d[..., k] ** 2, 1.0, f"variance {k}")
    assert 0.5 < float(out.accept_rate.mean()) < 0.85
    assert bool((td.split_rhat(d) < 1.05).all())
    _assert_adapted_in_spread(out, j_eps, j_T)


def test_logistic_regression_with_mass_matches_jax():
    """d = 5, 200 rows, the same numpy data, diagonal mass adaptation over
    150 warmup draws (tests/test_chees.py:46-69): the port's posterior means
    and variances within 4 combined MC standard errors of JAX's (8 seeds x
    64 chains x 20 kept draws against the port's 128 chains x 100), and the
    adapted step size and T within JAX's seed spread."""
    X, y, _ = make_logistic_regression_data(2, 200, 5, device="cpu")
    X, y = X.numpy(), y.numpy()
    jlk = jlogreg(X, y)

    def run(key):
        r = mcmc_tpu.chees(jnp.zeros(5), jlk, mcmc_tpu.ChEESSettings(
            n_burnin_draws=150, n_keep_draws=20), n_chains=64, key=key,
            adapt_mass_matrix=True)
        return (r.draws, r.diagnostics["adapted_step_size"][0],
                r.diagnostics["adapted_trajectory_length"][0])

    jd, j_eps, j_T = jax.jit(jax.vmap(run))(
        jax.random.split(jax.random.PRNGKey(0), JAX_SEEDS))
    jd = torch.tensor(np.asarray(jd)).transpose(0, 1).reshape(20, -1, 5)
    out = mcmc_tpu_torch.chees(
        torch.zeros(5), tlogreg(*convert.glm_data(X, y, "cpu")),
        mcmc_tpu_torch.ChEESSettings(n_burnin_draws=150, n_keep_draws=100),
        n_chains=128, key=1, adapt_mass_matrix=True)
    _assert_same_moments(jd, out.draws)
    _assert_adapted_in_spread(out, np.asarray(j_eps), np.asarray(j_T))


def test_dense_mass_correlated_gaussian():
    """rho = 0.9, 4-d (tests/test_chees.py:110-128 at a smaller size):
    dense mass adaptation recovers every covariance entry within 4 MC
    standard errors, and beats the diagonal metric on min ESS."""
    rho, dim = 0.9, 4
    cov = ((1 - rho) * np.eye(dim) + rho * np.ones((dim, dim))
           ).astype(np.float32)
    _, tlk = gaussian_pair(np.linalg.inv(cov).astype(np.float32))
    s = mcmc_tpu_torch.ChEESSettings(n_burnin_draws=200, n_keep_draws=100)
    ess = {}
    for mode in ("diag", "dense"):
        out = mcmc_tpu_torch.chees(torch.zeros(dim), tlk, s, n_chains=128,
                                   key=2, adapt_mass_matrix=mode)
        ess[mode] = float(td.ess(out.draws).min())
    d = out.draws
    for i in range(dim):
        for j in range(i, dim):
            _assert_moment(d[..., i] * d[..., j], float(cov[i, j]),
                           f"cov {i}{j}")
    assert ess["dense"] > 1.5 * ess["diag"], ess


def test_divergent_start_keeps_T_finite():
    """A barrier of -1e30 past x0 = 2 (tests/test_chees.py:92-107): the
    divergent chains' contributions must not poison the pooled gradient;
    T stays finite, draws finite and inside."""
    out = mcmc_tpu_torch.chees(
        torch.zeros(2), lambda v: torch.where(
            v[:, 0] < 2.0, -0.5 * (v ** 2).sum(-1),
            torch.full_like(v[:, 0], -1e30)),
        mcmc_tpu_torch.ChEESSettings(n_burnin_draws=100, n_keep_draws=50,
                                     step_size=1.0),
        n_chains=32, key=0)
    assert bool(torch.isfinite(out.diagnostics["adapted_trajectory_length"])
                .all())
    assert bool(torch.isfinite(out.draws).all())
    assert bool((out.draws[..., 0] < 2.0).all())


def test_bounded_thin_resume_and_guards(tmp_path):
    """Box bounds keep draws inside (tests/test_chees.py:77-89); ``thin``
    and ``return_resume`` give JAX's keys and shapes; one chain, mesh and
    mesh raise; checkpoint_dir= runs in chunks, equal to the in-memory
    run."""
    algo = mcmc_tpu_torch.AlgoSettings(vals_bound=True,
                                       lower_bounds=np.zeros(2),
                                       upper_bounds=np.full(2, 5.0))
    algo.chees_settings.n_burnin_draws = 60
    algo.chees_settings.n_keep_draws = 20
    lk = lambda v: -0.5 * ((v - 1.0) ** 2).sum(-1)
    out = mcmc_tpu_torch.chees(torch.ones(2), lk, algo, n_chains=16, key=4,
                               thin=2, return_resume=True)
    d = out.draws
    assert d.shape == (20, 16, 2)
    assert bool((d >= 0.0).all() and (d <= 5.0).all())
    assert out.diagnostics["thin"] == 2
    assert out.n_accept_draws.max() <= 40
    assert set(out.diagnostics) == {
        "accept_stat", "n_leap", "trajectory_length", "step_size",
        "adapted_step_size", "adapted_trajectory_length", "thin", "resume"}
    more = out.diagnostics["resume"](5, 7)
    assert more.draws.shape == (7, 16, 2) and "resume" in more.diagnostics
    with pytest.raises(ValueError, match="n_chains"):
        mcmc_tpu_torch.chees(torch.zeros(2), lk)
    small = mcmc_tpu_torch.ChEESSettings(n_burnin_draws=8, n_keep_draws=6)
    assert torch.equal(
        mcmc_tpu_torch.chees(torch.zeros(2), lk, small, n_chains=4,
                             key=3).draws,
        mcmc_tpu_torch.chees(torch.zeros(2), lk, small, n_chains=4, key=3,
                             checkpoint_dir=tmp_path / "ck",
                             checkpoint_every=4).draws)
    with pytest.raises(TypeError, match="DeviceMesh"):
        mcmc_tpu_torch.chees(torch.zeros(2), lk, n_chains=4, mesh=object())


def test_same_seed_same_draws():
    """Two CPU runs with one seed are bit-equal; another seed is not."""
    lk = lambda v: -0.5 * (v ** 2).sum(-1)
    s = mcmc_tpu_torch.ChEESSettings(n_burnin_draws=30, n_keep_draws=10)
    kw = dict(n_chains=16, adapt_mass_matrix="dense")
    a = mcmc_tpu_torch.chees(torch.zeros(2), lk, s, key=9, **kw)
    b = mcmc_tpu_torch.chees(torch.zeros(2), lk, s, key=9, **kw)
    c = mcmc_tpu_torch.chees(torch.zeros(2), lk, s, key=10, **kw)
    assert torch.equal(a.draws, b.draws)
    assert torch.equal(a.diagnostics["n_leap"], b.diagnostics["n_leap"])
    assert not torch.equal(a.draws, c.draws)
