"""The PyTorch port's microcanonical samplers, unadjusted (MCLMC) and
Metropolis-adjusted (MAMS), against the JAX package's, on the CPU.

Exact parts get the same numpy inputs on both sides: the isokinetic
velocity update, both integrators, the partial refresh, the pooled variance
EWMA, the automatic L, and each kernel's transition with both integrators,
with and without the diagonal preconditioner, fed the normals and uniforms
JAX's step draws from its keys (``jax_run`` of
``tests/test_torch_chees.py``). The rest is distributional, on the cases of
``tests/test_mclmc.py`` at smaller sizes: MAMS's moments within 4
Monte-Carlo standard errors of the exact answer; MCLMC's (an unadjusted
chain, biased by design) within 4 combined MC standard errors of JAX's own
draws; the adapted step size and L within the spread of 8 JAX seeds.
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
from mcmc_tpu_torch import convert
from mcmc_tpu_torch import models as tmodels
from test_torch_chees import (AX, RTOL, assert_close, check_transitions,
                              gaussian_pair, jax_run, run_fed, start)
from test_torch_nuts import (JAX_SEEDS, _assert_in_seed_spread,
                             _assert_moment, _assert_same_moments)

jmc = importlib.import_module("mcmc_tpu.samplers.mclmc")
tmc = importlib.import_module("mcmc_tpu_torch.samplers.mclmc")

D, C, N_TRANS = 4, 32, 62


def _vg_pair():
    """``value_and_grad`` of the same Gaussian in both packages."""
    jlk, tlk = gaussian_pair()
    return jmc._finite_value_and_grad(jlk), tmc._finite_value_and_grad(tlk)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

def test_iso_momentum_update_matches_jax():
    """The closed-form isokinetic update of unit velocities under frozen
    gradients, small to large (delta up to about 50, where the stable form
    matters), and a zero gradient: new velocity and kinetic weight at rtol
    1e-5 against JAX's under ``vmap``."""
    rng = np.random.default_rng(0)
    c, d = 64, 5
    u = rng.standard_normal((c, d))
    u = (u / np.linalg.norm(u, axis=1, keepdims=True)).astype(np.float32)
    g = (rng.standard_normal((c, d))
         * np.exp(rng.uniform(-3, 5, (c, 1)))).astype(np.float32)
    g[0] = 0.0
    eps = np.exp(rng.uniform(-3, 1, c)).astype(np.float32)
    want = jax.vmap(jmc._iso_momentum_update)(u, g, eps)
    got = tmc._iso_momentum_update(_t(u), _t(g), _t(eps))
    for name, gg, w in zip(("u", "kinetic"), got, want):
        assert_close(gg, w, what=name)
    np.testing.assert_allclose(got[0].norm(dim=1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("integrator", ["velocity_verlet", "mclachlan"])
def test_integrator_step_matches_jax(integrator):
    """One step of each integrator on the correlated Gaussian, per-chain
    step sizes and a diagonal preconditioner: position, velocity, log
    density, gradient and energy change at rtol 1e-5."""
    rng = np.random.default_rng(1)
    x = start(1)
    u = rng.standard_normal((C, D))
    u = (u / np.linalg.norm(u, axis=1, keepdims=True)).astype(np.float32)
    sq = rng.uniform(0.5, 2.0, (C, D)).astype(np.float32)
    eps = rng.uniform(0.1, 0.6, C).astype(np.float32)
    jvg, tvg = _vg_pair()
    logp, g = jax.vmap(jvg)(x)
    want = jax.vmap(lambda *a: jmc._INTEGRATORS[integrator](jvg, a[0])(
        *a[1:]))(sq, eps, x, u, logp, g)
    tl, tg = tvg(_t(x))
    got = tmc._INTEGRATORS[integrator](tvg, _t(sq))(
        _t(eps), _t(x), _t(u), tl, tg)
    scale = float(np.abs(np.asarray(logp)).max())
    for name, gg, w in zip(("x", "u", "logp", "g"), got, want):
        assert_close(gg, w, what=name)
    # the energy change is a difference of log densities of this scale
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                               atol=RTOL * scale, rtol=RTOL)


def test_refresh_pooled_variance_and_auto_L_match_jax():
    """``partial_velocity_refresh`` fed the normals JAX's draws from its
    key, ``_random_unit``, ``_pooled_var_update`` (adapting and not) against
    ``lax.pmean`` and ``_auto_L``: rtol 1e-5."""
    rng = np.random.default_rng(2)
    c, d = 16, 3
    u = rng.standard_normal((c, d))
    u = (u / np.linalg.norm(u, axis=1, keepdims=True)).astype(np.float32)
    eps = rng.uniform(0.1, 1.0, c).astype(np.float32)
    L = rng.uniform(1.0, 4.0, c).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), c)
    z = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (d,)))(keys))
    want = jax.vmap(jmc.partial_velocity_refresh)(keys, u, eps, L)
    assert_close(tmc.partial_velocity_refresh(_t(z), _t(u), _t(eps), _t(L)),
                 want, what="refresh")
    want = jax.vmap(lambda k: jmc._random_unit(k, d, jnp.float32))(keys)
    assert_close(tmc._random_unit(_t(z)), want, what="random unit")

    pos = (3.0 * rng.standard_normal((c, d)) + 1.0).astype(np.float32)
    ema = rng.uniform(0.5, 2.0, (c, d)).astype(np.float32)
    adapting = np.arange(c) % 3 > 0
    want = jax.vmap(lambda e, p, a: jmc._pooled_var_update(e, p, 0.02, a),
                    axis_name=AX)(ema, pos, adapting)
    got = tmc._pooled_var_update(_t(ema), _t(pos), 0.02, _t(adapting))
    assert_close(got, want, what="pooled variance")
    sq = rng.uniform(0.5, 2.0, (c, d)).astype(np.float32)
    want = jax.vmap(lambda e, s, ep: jmc._auto_L(e, s, 1.3, ep))(
        ema, sq, eps)
    assert_close(tmc._auto_L(_t(ema), _t(sq), 1.3, _t(eps)), want,
                 what="auto L")
    # the floor at 2 eps
    big = np.full(c, 1e3, np.float32)
    np.testing.assert_array_equal(
        tmc._auto_L(_t(ema), _t(sq), 1.3, _t(big)).numpy(), 2.0 * big)


# ---------------------------------------------------------------------------
# the transitions, fed JAX's draws
# ---------------------------------------------------------------------------

CASES = [(kind, integrator, mass) for kind in ("mclmc", "mams")
         for integrator in ("velocity_verlet", "mclachlan")
         for mass in (False, True)]
_IDS = [f"{k}-{i}-{'mass' if m else 'plain'}" for k, i, m in CASES]
_RUNS = {}


def _draws_of(kind):
    if kind == "mclmc":
        return lambda key: (jax.random.normal(key, (D,), jnp.float32),)

    def draws(key):
        k_mom, k_acc = jax.random.split(key)
        return (jax.random.normal(k_mom, (D,), jnp.float32),
                jax.random.uniform(k_acc, dtype=jnp.float32))
    return draws


def _case(kind, integrator, mass, n_adapt):
    """JAX's 62 transitions of the case from JAX's ``init`` (cached), and
    the port's kernel on the same target."""
    jlk, tlk = gaussian_pair()
    Settings = "MCLMCSettings" if kind == "mclmc" else "MAMSSettings"
    build = f"build_{kind}_kernel"
    L0, eps0 = 2.0, 0.2 if kind == "mclmc" else 0.4
    key = (kind, integrator, mass, n_adapt)
    if key not in _RUNS:
        jinit, jstep = getattr(jmc, build)(
            jlk, getattr(mcmc_tpu, Settings)(integrator=integrator), n_adapt,
            mass)
        keys = jax.random.split(jax.random.PRNGKey(5), C)
        st0 = jax.vmap(lambda k, x: jinit(k, x, L0, eps0), axis_name=AX)(
            keys, jnp.asarray(start(6, scale=0.5)))
        _RUNS[key] = jax_run(jstep, _draws_of(kind), st0, N_TRANS, 7)
    tinit, tstep = getattr(tmc, build)(
        tlk, getattr(mcmc_tpu_torch, Settings)(integrator=integrator), n_adapt,
        mass)
    return tinit, tstep, _RUNS[key], (L0, eps0)


def _convert(kind):
    return convert.mclmc_state if kind == "mclmc" else convert.mams_state


@pytest.mark.parametrize("kind,integrator,mass", CASES, ids=_IDS)
def test_transition_matches_jax(kind, integrator, mass):
    """Each of JAX's 62 transitions (the end of adaptation at 40 included),
    from JAX's state before it and fed its draws: every state field and
    info at rtol 1e-5 (``assert_close``), accept decisions and leap counts
    exactly. The port's ``init`` gives JAX's first state (with JAX's
    velocities, which MCLMC draws from its keys)."""
    tinit, tstep, (states, infos, draws), (L0, eps0) = _case(
        kind, integrator, mass, 40)
    with torch.no_grad():
        st0 = tinit(torch.Generator().manual_seed(0),
                    torch.from_numpy(start(6, scale=0.5)), L0, eps0)
        if kind == "mclmc":
            np.testing.assert_allclose(st0.velocity.norm(dim=1).numpy(), 1.0,
                                       rtol=1e-6)
            st0 = st0._replace(velocity=_t(states[0].velocity))
        assert_close(st0, states[0], what="init")
        check_transitions(_convert(kind), tstep.transition, states, infos,
                          draws)
    if kind == "mams":
        leaps = [int(i["n_leap"][0]) for i in infos]
        assert len(set(leaps)) > 2, leaps
        acc = np.mean([i["accepted"].mean() for i in infos])
        assert 0.3 < acc < 0.99, acc


# The port's own run drifts from JAX's by the f32 rounding of two
# summation orders. MCLMC's pooled step-size tuning feeds it back: with 40
# adapting transitions its positions drifted from 6e-8 to 4e-4 after 16
# transitions and 0.3 after 32 with velocity Verlet (measured), as the JAX
# package's own test notes for its sharded run. With 4 adapting transitions
# every field of MCLMC's final state is within 2.3e-5 of its scale, and
# MAMS's, with all 40 (its accept statistic contracts), within 4.2e-5, with
# every accept decision JAX's (measured); the runs are held to 5e-4.
RUN_ADAPT, RUN_RTOL = {"mclmc": 4, "mams": 40}, 5e-4


@pytest.mark.parametrize("kind,integrator,mass", CASES, ids=_IDS)
def test_run_fed_jax_draws(kind, integrator, mass):
    """The port's 62 transitions from JAX's start (``RUN_ADAPT`` of them
    adapting), fed JAX's draws: the same accept decisions at every
    transition (for MCLMC, finite steps), the final state within
    ``RUN_RTOL`` of JAX's; MAMS syncs with the host once per transition,
    MCLMC never."""
    _, tstep, (states, infos, draws), _ = _case(kind, integrator, mass,
                                                RUN_ADAPT[kind])
    with torch.no_grad():
        final = run_fed(_convert(kind), tstep.transition, states, infos,
                        draws)
    assert_close(final, states[-1], RUN_RTOL, "final state")
    assert tstep.counts["syncs"] == (N_TRANS if kind == "mams" else 0)
    per_step = 2 if integrator == "mclachlan" else 1
    assert tstep.counts["gradients"] == per_step * tstep.counts["leapfrogs"]


# ---------------------------------------------------------------------------
# distributional, on the cases of tests/test_mclmc.py
# ---------------------------------------------------------------------------

def _energy_var(energy_change, dim):
    """The pooled squared energy error per dimension of a run's kept
    draws: the quantity MCLMC's step size is tuned to hold."""
    return (energy_change ** 2).mean() / dim


def _over_seeds(fn, x0, log_kernel, s, n_chains, **kw):
    """``mcmc_tpu.mclmc`` or ``mams`` under ``jax.vmap`` over ``JAX_SEEDS``
    keys: kept draws as ``(draws, seeds x chains, d)``, and each seed's
    adapted step size and L and (MCLMC) its energy error per dimension."""
    def run(key):
        r = fn(x0, log_kernel, s, n_chains=n_chains, key=key, **kw)
        de = r.diagnostics.get("energy_change", jnp.zeros(()))
        return (r.draws, r.diagnostics["adapted_step_size"],
                r.diagnostics["adapted_L"], _energy_var(de, x0.shape[0]))

    draws, eps, L, var_e = jax.jit(jax.vmap(run))(
        jax.random.split(jax.random.PRNGKey(0), JAX_SEEDS))
    draws = torch.tensor(np.asarray(draws)).transpose(0, 1)
    return (draws.reshape(draws.shape[0], -1, draws.shape[-1]),
            np.asarray(eps), np.asarray(L), np.asarray(var_e))


def _assert_adapted(out, j_eps, j_L):
    _assert_in_seed_spread("step size", j_eps,
                           out.diagnostics["adapted_step_size"])
    _assert_in_seed_spread("L", j_L, out.diagnostics["adapted_L"])


_SCALES4 = np.array([0.5, 1.0, 2.0, 4.0], np.float32)


def _aniso(scales):
    js, ts = jnp.asarray(scales), torch.from_numpy(scales)
    return (lambda v: -0.5 * jnp.sum((v / js) ** 2),
            lambda v: -0.5 * ((v / ts) ** 2).sum(-1))


def test_mclmc_anisotropic_gaussian_matches_jax():
    """MCLMC on the 4-d anisotropic Gaussian (tests/test_mclmc.py:20-45) at
    128 chains, 200 warmup and 150 kept draws: means and variances within 4
    combined MC standard errors of JAX's (8 seeds x 128 chains x 30 draws:
    the same biased chain), the adapted step size and L within JAX's seed
    spread, L near the sqrt-trace heuristic, every step finite, and the
    pooled energy error per dimension (tuned toward 5e-4) within JAX's seed
    spread."""
    jlk, tlk = _aniso(_SCALES4)
    s = dict(n_burnin_draws=200)
    jd, j_eps, j_L, j_var_e = _over_seeds(
        mcmc_tpu.mclmc, jnp.zeros(4), jlk,
        mcmc_tpu.MCLMCSettings(n_keep_draws=30, **s), 128)
    out = mcmc_tpu_torch.mclmc(torch.zeros(4), tlk,
                               mcmc_tpu_torch.MCLMCSettings(n_keep_draws=150,
                                                            **s),
                               n_chains=128, key=0)
    assert out.draws.shape == (150, 128, 4)
    _assert_same_moments(jd, out.draws)
    _assert_adapted(out, j_eps, j_L)
    assert 3.0 < float(out.diagnostics["adapted_L"]) < 7.0
    _assert_in_seed_spread("energy error per dimension", j_var_e,
                           _energy_var(out.diagnostics["energy_change"], 4))
    assert bool((out.n_accept_draws == 150).all())


def test_mams_acceptance_and_exactness_matches_jax():
    """MAMS on the 3-d anisotropic Gaussian (tests/test_mclmc.py:48-65) at
    256 chains, 150 warmup and 100 kept draws: acceptance near the 0.9
    target, variances within 4 MC standard errors of the exact ones, the
    adapted step size and L within the spread of 8 JAX seeds."""
    scales = np.array([0.5, 1.0, 2.0], np.float32)
    jlk, tlk = _aniso(scales)
    s = dict(n_burnin_draws=150, n_keep_draws=100)
    _, j_eps, j_L, _ = _over_seeds(mcmc_tpu.mams, jnp.zeros(3), jlk,
                                mcmc_tpu.MAMSSettings(**s), 128)
    out = mcmc_tpu_torch.mams(torch.zeros(3), tlk,
                              mcmc_tpu_torch.MAMSSettings(**s), n_chains=256,
                              key=1)
    assert 0.82 < float(out.accept_rate.mean()) < 0.97
    for k, sc in enumerate(scales):
        _assert_moment(out.draws[..., k] / sc, 0.0, f"mean {k}")
        _assert_moment((out.draws[..., k] / sc) ** 2, 1.0, f"variance {k}")
    _assert_adapted(out, j_eps, j_L)


def test_mclmc_bias_is_controlled_by_energy_target():
    """The unadjusted chain's variance bias on an 8-d standard Gaussian
    (tests/test_mclmc.py:66-85 at a smaller size): under 5% at the default
    target, and smaller at a target of 1e-5."""
    lk = lambda v: -0.5 * (v ** 2).sum(-1)
    bias = {}
    for target in (5e-4, 1e-5):
        out = mcmc_tpu_torch.mclmc(
            torch.zeros(8), lk, mcmc_tpu_torch.MCLMCSettings(
                n_burnin_draws=300, n_keep_draws=300,
                desired_energy_var=target), n_chains=256, key=2)
        bias[target] = float(out.draws.reshape(-1, 8).var(dim=0).mean()) - 1
    assert abs(bias[5e-4]) < 0.05, bias
    assert abs(bias[1e-5]) < 0.02 and abs(bias[1e-5]) < abs(bias[5e-4]), bias


def test_mclmc_adapt_mass_ill_conditioned_matches_jax():
    """MCLMC with the diagonal preconditioner on the 8-d ill-conditioned
    Gaussian (condition 1e3; tests/test_mclmc.py:88-96 at a smaller size):
    each variance within 4 combined MC standard errors of JAX's, the
    adapted step size and L within JAX's seed spread."""
    jlk = jmodels.ill_conditioned_gaussian(8, condition_number=1e3)
    tlk = tmodels.ill_conditioned_gaussian(8, condition_number=1e3,
                                           device="cpu")
    s = dict(n_burnin_draws=300)
    jd, j_eps, j_L, _ = _over_seeds(
        mcmc_tpu.mclmc, jnp.zeros(8), jlk,
        mcmc_tpu.MCLMCSettings(n_keep_draws=30, **s), 128, adapt_mass=True)
    out = mcmc_tpu_torch.mclmc(torch.zeros(8), tlk,
                               mcmc_tpu_torch.MCLMCSettings(n_keep_draws=150,
                                                            **s),
                               n_chains=128, key=3, adapt_mass=True)
    _assert_same_moments(jd / tlk.variances.sqrt(),
                         out.draws / tlk.variances.sqrt())
    _assert_adapted(out, j_eps, j_L)


def test_mams_logistic_regression_matches_jax():
    """MAMS with the preconditioner on a d = 5 logistic regression (the
    posterior of tests/test_mclmc.py:99-118), the same numpy data: means
    and variances within 4 combined MC standard errors of JAX's, adapted
    step size and L within JAX's seed spread."""
    X, y, _ = tmodels.make_logistic_regression_data(2, 200, 5, device="cpu")
    X, y = X.numpy(), y.numpy()
    s = dict(n_burnin_draws=150)
    jd, j_eps, j_L, _ = _over_seeds(
        mcmc_tpu.mams, jnp.zeros(5), jmodels.logistic_regression_model(X, y),
        mcmc_tpu.MAMSSettings(n_keep_draws=20, **s), 64, adapt_mass=True)
    out = mcmc_tpu_torch.mams(
        torch.zeros(5),
        tmodels.logistic_regression_model(*convert.glm_data(X, y, "cpu")),
        mcmc_tpu_torch.MAMSSettings(n_keep_draws=100, **s), n_chains=128,
        key=4, adapt_mass=True)
    _assert_same_moments(jd, out.draws)
    _assert_adapted(out, j_eps, j_L)


@pytest.mark.parametrize("kind", ["mclmc", "mams"])
def test_bounded_target(kind):
    """Box bounds [0, 5]^2 on N(1, I) (tests/test_mclmc.py:121-146): draws
    stay inside and the truncated mean lies above 1."""
    algo = mcmc_tpu_torch.AlgoSettings(vals_bound=True,
                                       lower_bounds=np.zeros(2),
                                       upper_bounds=np.full(2, 5.0))
    s = getattr(algo, f"{kind}_settings")
    s.n_burnin_draws, s.n_keep_draws = 150, 150
    out = getattr(mcmc_tpu_torch, kind)(
        torch.ones(2), lambda v: -0.5 * ((v - 1.0) ** 2).sum(-1), algo,
        n_chains=64, key=6)
    d = out.draws
    assert bool((d >= 0.0).all() and (d <= 5.0).all())
    assert 1.0 < float(d.mean()) < 1.6


def test_mclmc_nonfinite_step_bounces():
    """A -inf barrier past x0 = 2 (tests/test_mclmc.py:174-186): non-finite
    steps bounce, draws stay finite and inside, the bounces are counted as
    not accepted."""
    lk = lambda v: torch.where(v[:, 0] < 2.0, -0.5 * (v ** 2).sum(-1),
                               torch.full_like(v[:, 0], -torch.inf))
    out = mcmc_tpu_torch.mclmc(
        torch.zeros(2), lk,
        mcmc_tpu_torch.MCLMCSettings(n_burnin_draws=150, n_keep_draws=200),
        n_chains=32, key=10)
    assert bool(torch.isfinite(out.draws).all())
    assert bool((out.draws[..., 0] < 2.0).all())
    assert int(out.n_accept_draws.sum()) < 200 * 32
    _assert_moment(out.draws[..., 1], 0.0, "mean of the free coordinate")


def test_guards_options_and_determinism(tmp_path):
    """JAX's ``ValueError`` messages for dim 1 and one chain; ``thin``,
    ``return_resume`` and JAX's diagnostics keys; one seed repeats bit for
    bit; mesh raises; checkpoint_dir= gives the in-memory run's draws."""
    lk = lambda v: -0.5 * (v ** 2).sum(-1)
    jlk = lambda v: -0.5 * jnp.sum(v ** 2)
    for fn, x0, kw, match in (("mclmc", 1, dict(n_chains=8), "dim >= 2"),
                              ("mclmc", 2, {}, "n_chains"),
                              ("mams", 2, {}, "n_chains")):
        msgs = []
        for pkg, z, k in ((mcmc_tpu, jnp.zeros(x0), jlk),
                          (mcmc_tpu_torch, torch.zeros(x0), lk)):
            with pytest.raises(ValueError, match=match) as e:
                getattr(pkg, fn)(z, k, **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    s = mcmc_tpu_torch.MCLMCSettings(n_burnin_draws=30, n_keep_draws=20)
    out = mcmc_tpu_torch.mclmc(torch.zeros(2), lk, s, n_chains=16, key=12,
                               thin=3, return_resume=True)
    assert out.draws.shape == (20, 16, 2) and out.diagnostics["thin"] == 3
    assert set(out.diagnostics) == {"energy_change", "step_size", "L",
                                    "adapted_step_size", "adapted_L", "thin",
                                    "resume"}
    more = out.diagnostics["resume"](13, 10)
    assert more.draws.shape == (10, 16, 2)
    sm = mcmc_tpu_torch.MAMSSettings(n_burnin_draws=30, n_keep_draws=20)
    a = mcmc_tpu_torch.mams(torch.zeros(3), lk, sm, n_chains=8, key=9)
    b = mcmc_tpu_torch.mams(torch.zeros(3), lk, sm, n_chains=8, key=9)
    c = mcmc_tpu_torch.mams(torch.zeros(3), lk, sm, n_chains=8, key=10)
    assert set(a.diagnostics) == {"accept_stat", "n_leap", "step_size",
                                  "trajectory_length", "adapted_step_size",
                                  "adapted_L"}
    assert torch.equal(a.draws, b.draws) and not torch.equal(a.draws, c.draws)
    for fn in (mcmc_tpu_torch.mclmc, mcmc_tpu_torch.mams):
        small = dict(n_chains=4, key=2,
                     settings=mcmc_tpu_torch.AlgoSettings(
                         mclmc_settings=mcmc_tpu_torch.MCLMCSettings(
                             n_burnin_draws=6, n_keep_draws=5),
                         mams_settings=mcmc_tpu_torch.MAMSSettings(
                             n_burnin_draws=6, n_keep_draws=5)))
        assert torch.equal(
            fn(torch.zeros(2), lk, **small).draws,
            fn(torch.zeros(2), lk, **small, checkpoint_every=4,
               checkpoint_dir=tmp_path / fn.__name__).draws)
        with pytest.raises(NotImplementedError, match="A12"):
            fn(torch.zeros(2), lk, n_chains=4, mesh=object())
