"""The PyTorch port's NUTS against the JAX package's, on the CPU.

Deterministic pieces get the same numpy inputs on both sides: the subtree
(JAX's single-chain builder under ``vmap`` against the port's batched one),
the initial step size, the pooled mass estimate and the depth-cap rule.
The samplers draw from different generators, so the rest is distributional,
on the cases of ``tests/test_nuts.py``: each tolerance is a multiple of the
run's own Monte-Carlo standard error, from the port's ESS. What adaptation
ends with (step size, inverse mass) is held against the spread of several
JAX seeds, run as one ``jax.vmap`` of ``mcmc_tpu.nuts``. The port pays per
leaf, not per chain, so the runs use many chains and few draws.
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
from mcmc_tpu import integrators as jint
from mcmc_tpu.models import logistic_regression_model as jlogreg
from mcmc_tpu.samplers import common as jcommon
from mcmc_tpu_torch import adaptation as tadapt
from mcmc_tpu_torch import convert
from mcmc_tpu_torch import diagnostics as td
from mcmc_tpu_torch import integrators as tint
from mcmc_tpu_torch.samplers import common as tcommon
from mcmc_tpu_torch import models as tmodels
from mcmc_tpu_torch.models import (logistic_regression_model as tlogreg,
                                   make_logistic_regression_data)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for every test here: the tests run in several
    worker processes at once, and torch's default of a thread per core
    oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the packages' samplers/__init__ re-export the nuts *function* under the
# module's name
jnuts = importlib.import_module("mcmc_tpu.samplers.nuts")
tnuts = importlib.import_module("mcmc_tpu_torch.samplers.nuts")

N_SIGMA = 4.0    # tolerances: this many Monte-Carlo standard errors


def _mcse(x):
    """Monte-Carlo standard error of the mean of ``x`` (n_draws, n_chains),
    from the port's multi-chain ESS."""
    x = torch.as_tensor(x, dtype=torch.float64)
    n_eff = float(td.ess(x[..., None].float())[0])
    return float(x.std()) / np.sqrt(n_eff)


def _assert_moment(x, want, what, slack=0.0):
    """The mean of ``x`` (n_draws, n_chains) within N_SIGMA MC standard
    errors (plus ``slack``, the reference value's own rounding) of
    ``want``."""
    got = float(torch.as_tensor(x, dtype=torch.float64).mean())
    tol = N_SIGMA * _mcse(x) + slack
    assert abs(got - want) <= tol, (what, got, want, tol)


def _settings(n_warm, n_keep, **kw):
    return mcmc_tpu_torch.NUTSSettings(n_burnin_draws=n_warm,
                                       n_keep_draws=n_keep,
                                       n_adapt_draws=n_warm, **kw)


# ---------------------------------------------------------------------------
# the subtree, deterministic
# ---------------------------------------------------------------------------

MAX_DEPTH, CHAINS = 4, 32
_JAX_SUBTREE = {}


def _jax_subtree(multinomial):
    """JAX's builder on a diagonal Gaussian, vmapped over chains; scales,
    depth and inputs are arguments, so one compile serves each width."""
    if multinomial not in _JAX_SUBTREE:
        def run(scales, keys, depth, v, z0, r0, eps, log_u, alpha_base):
            logk = lambda z: -0.5 * jnp.sum((z / scales) ** 2)
            grad = jax.grad(logk)

            def potential(z):
                u = -logk(z)
                return jnp.where(jnp.isfinite(u), u, jnp.inf)

            build = jnuts.make_subtree_builder(
                potential, lambda r, im=None: 0.5 * jnp.dot(r, r),
                lambda z, r, e, im=None: jint.leapfrog(grad, lambda p: p, e,
                                                       1, z, r),
                MAX_DEPTH, multinomial)
            return jax.vmap(lambda *a: build(a[0], depth, *a[1:],
                                             z0.shape[1], jnp.float32))(
                keys, v, z0, r0, eps, log_u, alpha_base)
        _JAX_SUBTREE[multinomial] = jax.jit(run)
    return _JAX_SUBTREE[multinomial]


def _torch_pieces(log_kernel):
    """The identity-mass Hamiltonian pieces of the port's kernel."""
    grad = tint.grad_of(log_kernel)

    def potential(z):
        u = -log_kernel(z)
        return torch.where(torch.isfinite(u), u, torch.inf)

    def kinetic(r, inv_mass=None):
        return tint.kinetic_energy(r, lambda p: p)

    def leapfrog1(z, r, eps, inv_mass=None):
        return tint.leapfrog(grad, lambda p: p, eps, 1, z, r)

    return potential, kinetic, leapfrog1


@pytest.mark.parametrize("method", ["slice", "multinomial"])
def test_subtree_matches_jax(method):
    """The batched subtree against JAX's vmapped ``make_subtree_builder``:
    diagonal Gaussians of dimension 1-4, depths 0-4, 32 chains a case with
    random directions, step sizes, slices and starts. ``s``, ``n_alpha``,
    ``div`` and the slice count ``n`` agree exactly; ``alpha`` (and the
    multinomial ``n``, a sum of exponentials whose last bits differ between
    the two ``exp``) at rtol 1e-4, atol 1e-5; the endpoint at rtol 1e-5,
    atol 1e-6 (the tolerances of tests/test_nuts.py:275-286). The reservoir
    draws its own uniforms: a taken proposal's ``prop_U`` is the potential
    at ``prop_z``; with none taken it is (z0, inf)."""
    multinomial = method == "multinomial"
    rng = np.random.default_rng(0 if multinomial else 1)
    n_stopped = n_chains = 0
    for dim in range(1, 5):
        scales = np.exp(rng.normal(0.0, 1.0, dim)).astype(np.float32)
        ts = torch.from_numpy(scales)
        potential, kinetic, leapfrog1 = _torch_pieces(
            lambda z: -0.5 * ((z / ts) ** 2).sum(dim=-1))
        build = tnuts.make_subtree_builder(potential, kinetic, leapfrog1,
                                           MAX_DEPTH, multinomial)
        for depth in range(MAX_DEPTH + 1):
            f32 = lambda a: np.asarray(a, np.float32)
            z0 = f32(rng.normal(0.0, 1.0, (CHAINS, dim)))
            r0 = f32(rng.normal(0.0, 1.0, (CHAINS, dim)))
            # step sizes large enough that U-turns and divergences happen
            eps = f32(np.exp(rng.uniform(np.log(0.05), np.log(2.0), CHAINS)))
            H0 = f32(0.5 * ((z0 / scales) ** 2).sum(1) + 0.5 * (r0 ** 2).sum(1))
            log_u = H0 if multinomial else \
                f32(np.log(rng.uniform(size=CHAINS)) - H0)
            v = f32(rng.choice([-1.0, 1.0], CHAINS))
            args = (v, z0, r0, eps, log_u, H0)
            want = _jax_subtree(multinomial)(
                jnp.asarray(scales),
                jax.random.split(jax.random.PRNGKey(depth), CHAINS),
                jnp.asarray(depth, jnp.int32), *map(jnp.asarray, args))
            gen = torch.Generator().manual_seed(depth)
            with torch.no_grad():
                got = build(gen, depth, *map(torch.from_numpy, args))
            case = f"dim {dim} depth {depth}"
            exact = ["s", "n_alpha", "div"] + ([] if multinomial else ["n"])
            for k in exact:
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]),
                                              err_msg=f"{k}, {case}")
            close = ["alpha"] + (["n"] if multinomial else [])
            for k in close:
                np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                           rtol=1e-4, atol=1e-5,
                                           err_msg=f"{k}, {case}")
            for k in ("z", "r"):
                np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=f"{k}, {case}")
            assert got["n"].dtype == (torch.float32 if multinomial
                                      else torch.int32)
            took = torch.isfinite(got["prop_U"])
            with torch.no_grad():
                assert torch.equal(potential(got["prop_z"])[took],
                                   got["prop_U"][took]), case
            assert torch.equal(got["prop_z"][~took],
                               torch.from_numpy(z0)[~took]), case
            n_stopped += int((got["s"] == 0).sum())
            n_chains += CHAINS
    # the case mix must exercise U-turn and divergence stopping
    assert 0.10 * n_chains < n_stopped < 0.95 * n_chains, n_stopped


def test_subtree_freezes_inactive_chains():
    """A chain outside ``active`` leaves every output as it came in: the
    endpoint, weight, stop flag, accept statistic and checkpoints."""
    potential, kinetic, leapfrog1 = _torch_pieces(
        lambda z: -0.5 * (z * z).sum(dim=-1))
    build = tnuts.make_subtree_builder(potential, kinetic, leapfrog1, 3)
    rng = np.random.default_rng(2)
    z0, r0 = (torch.tensor(rng.standard_normal((6, 2)), dtype=torch.float32)
              for _ in range(2))
    active = torch.tensor([True, False, True, False, True, True])
    ones = torch.ones(6)
    with torch.no_grad():
        out = build(torch.Generator().manual_seed(0), 3, ones, z0, r0,
                    0.3 * ones, -10.0 * ones, ones, active)
    off = ~active
    assert torch.equal(out["z"][off], z0[off])
    assert torch.equal(out["r"][off], r0[off])
    assert torch.equal(out["prop_z"][off], z0[off])
    assert bool(torch.isinf(out["prop_U"][off]).all())
    assert bool((out["n"][off] == 0).all() and (out["s"][off] == 1).all())
    assert bool((out["n_alpha"][off] == 0).all() and
                (out["alpha"][off] == 0).all() and ~out["div"][off].any())
    assert bool((out["ckpt_z"][off] == 0).all())
    assert bool((out["n_alpha"][active] > 0).all())


# ---------------------------------------------------------------------------
# adaptation pieces, deterministic
# ---------------------------------------------------------------------------

def _flagship(n=200, d=5, seed=2):
    X, y, _ = make_logistic_regression_data(seed, n, d, device="cpu")
    return X.numpy(), y.numpy()


@pytest.mark.parametrize("pooled", [False, True])
def test_initial_step_size_matches_jax(pooled):
    """From the same start and momentum, the doubling-only heuristic gives
    JAX's step sizes exactly (powers of two, different by chain, on a wide
    Gaussian where the first step of 1 is too short); pooled, their
    geometric mean (rtol 1e-6: the f32 means sum in another order)."""
    d, c = 5, 16
    scales = np.logspace(0.5, 2.0, d).astype(np.float32)
    z0 = (scales * np.random.default_rng(3).standard_normal((c, d))
          ).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(4), c)
    jlk = lambda z: -0.5 * jnp.sum((z / scales) ** 2)
    jinit, _ = jnuts.build_nuts_kernel(
        jlk, jax.grad(jlk), jcommon.make_spd(None, d, jnp.float32),
        mcmc_tpu.NUTSSettings(), 100, pooled_adaptation=pooled)
    want = jax.jit(jax.vmap(jinit, axis_name=jcommon.CHAIN_AXIS_NAME))(
        keys, jnp.asarray(z0)).step_size
    # JAX's init draws its momentum as the key's standard normal
    r0 = np.array(jax.vmap(lambda k: jax.random.normal(k, (d,)))(keys))

    ts = torch.from_numpy(scales)
    with torch.no_grad():
        got = tnuts.find_initial_step_size(
            *_torch_pieces(lambda z: -0.5 * ((z / ts) ** 2).sum(-1)),
            torch.from_numpy(z0), torch.from_numpy(r0))
    if pooled:
        got = torch.exp(torch.log(got).mean()).expand(c)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert len(set(got.tolist())) > 1 and float(got.min()) > 1.0


@pytest.mark.parametrize("mode", ["diag", "dense"])
def test_pooled_mass_update_matches_jax(mode):
    """``windowed_mass_update(pooled=True)`` at a window end against JAX's
    under ``vmap`` with ``axis_name``: every chain adopts the chains' mean
    estimate (rtol 1e-5); the unpooled estimates differ by chain."""
    rng = np.random.default_rng(5)
    c, d = 8, 4
    x = rng.standard_normal((c, d)).astype(np.float32)
    mean = rng.standard_normal((c, d)).astype(np.float32)
    count = np.full((c,), 30, np.int32)
    if mode == "dense":
        a = rng.standard_normal((c, d, 40)).astype(np.float32)
        m2 = np.einsum("cik,cjk->cij", a, a).astype(np.float32)
        inv_mass = np.broadcast_to(np.eye(d, dtype=np.float32), (c, d, d))
        chol = inv_mass.copy()
    else:
        m2 = (30.0 * rng.uniform(0.5, 2.0, (c, d))).astype(np.float32)
        inv_mass = np.ones((c, d), np.float32)
        chol = np.ones((c, 1), np.float32)
    yes = np.ones((c,), bool)
    args = (count, mean, m2, np.array(inv_mass), chol, x, yes, yes)
    want = jax.vmap(lambda *a: jadapt.windowed_mass_update(
        *a, mode, axis_name="chains"), axis_name="chains")(
            *map(jnp.asarray, args))
    for pooled in (True, False):
        got = tadapt.windowed_mass_update(*map(torch.from_numpy, args), mode,
                                          pooled=pooled)
        if pooled:
            for name, g, w in zip(("count", "mean", "m2", "inv_mass", "chol"),
                                  got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=name)
            assert torch.equal(got[3][0], got[3][-1])
        else:
            assert not torch.allclose(got[3][0], got[3][-1])


@pytest.mark.parametrize("pooled", [False, True])
def test_depth_cap_rule_matches_jax(pooled):
    """At the last warmup draw the learned budget is the ``depth_quantile``
    depth + 1 of the warmup histogram (this draw's depth counted), clamped
    to ``max_tree_depth``: JAX's step sets it from a given histogram, the
    port's rule from the same histogram plus JAX's draw depth."""
    c, d, max_depth, n_adapt = 12, 2, 4, 10
    rng = np.random.default_rng(6)
    hist = rng.integers(0, 6, (c, max_depth + 1)).astype(np.int32)
    hist[:, 0] = 0
    hist[0] = 0              # a chain with no settled draw yet
    hist[1, -1] = 40         # one whose budget clamps to max_tree_depth
    s = mcmc_tpu.NUTSSettings(max_tree_depth=max_depth)
    lk = lambda z: -0.5 * jnp.sum(z ** 2)
    jinit, jstep = jnuts.build_nuts_kernel(
        lk, jax.grad(lk), jcommon.make_spd(None, d, jnp.float32), s, n_adapt,
        pooled_adaptation=pooled, adapt_depth=True)
    ax = jcommon.CHAIN_AXIS_NAME
    keys = jax.random.split(jax.random.PRNGKey(7), c)
    st = jax.jit(jax.vmap(jinit, axis_name=ax))(keys, jnp.zeros((c, d)))
    st = st._replace(depth_hist=jnp.asarray(hist),
                     draw_ind=jnp.full((c,), n_adapt - 1, jnp.int32))
    new, info = jax.jit(jax.vmap(jstep, axis_name=ax))(keys, st)
    depth = np.minimum(np.asarray(info["tree_depth"]), max_depth)
    full = hist.copy()
    full[np.arange(c), depth] += 1
    got = tnuts.depth_cap_rule(torch.from_numpy(full), 0.98, max_depth,
                               pooled)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(new.depth_cap))
    np.testing.assert_array_equal(np.asarray(new.depth_hist), full)
    assert pooled == (len(set(got.tolist())) == 1)


# ---------------------------------------------------------------------------
# distributional parity on the cases of tests/test_nuts.py
# ---------------------------------------------------------------------------

def test_standard_normal():
    """3-d standard normal at the default target: mean 0 and variance 1
    within 4 MC standard errors, accept statistic in (0.4, 0.95), split
    R-hat < 1.05 (tests/test_nuts.py:14-28)."""
    out = mcmc_tpu_torch.nuts(torch.zeros(3), lambda v: -0.5 * (v ** 2).sum(-1),
                              _settings(100, 100), n_chains=128, key=0)
    d = out.draws
    assert d.shape == (100, 128, 3)
    for k in range(3):
        _assert_moment(d[..., k], 0.0, f"mean {k}")
        _assert_moment(d[..., k] ** 2, 1.0, f"variance {k}")
    assert 0.4 < float(out.diagnostics["accept_stat"].mean()) < 0.95
    assert bool((td.split_rhat(d) < 1.05).all())


def test_eight_schools_exact_posterior():
    """Eight schools with the half-Cauchy tau, endpoint tree: E[mu] and
    E[tau] within 4 MC standard errors (+ 0.0005, the quadrature values'
    rounding) of 4.397 and 3.589 from 2-d quadrature; rank R-hat < 1.02
    through the port's ``summary`` (tests/test_nuts.py:339-360)."""
    lk = tmodels.eight_schools_model(non_centered=True,
                                     tau_prior="half_cauchy", device="cpu")
    out = mcmc_tpu_torch.nuts(torch.zeros(10), lk,
                              _settings(150, 100, target_accept_rate=0.8),
                              n_chains=256, key=1, adapt_mass_matrix=True,
                              pooled_adaptation=True)
    d = out.draws
    _assert_moment(d[..., 0], 4.397, "E[mu]", slack=5e-4)
    _assert_moment(torch.exp(d[..., 1]), 3.589, "E[tau]", slack=5e-4)
    summ = td.summary(d)
    assert float(summ["rhat_rank"].max()) < 1.02


def test_multinomial_correlated_gaussian():
    """``sample_method="multinomial"`` on the rho = 0.8 Gaussian: each
    covariance entry within 4 MC standard errors; with
    ``tree_variant="reference"`` it raises (tests/test_nuts.py:363-393)."""
    rho = 0.8
    prec = torch.linalg.inv(torch.tensor([[1.0, rho], [rho, 1.0]]))
    lk = lambda v: -0.5 * (v * (v @ prec)).sum(-1)
    out = mcmc_tpu_torch.nuts(torch.zeros(2), lk, _settings(100, 100),
                              n_chains=128, key=5,
                              sample_method="multinomial")
    d = out.draws
    for (i, j), want in {(0, 0): 1.0, (1, 1): 1.0, (0, 1): rho}.items():
        _assert_moment(d[..., i] * d[..., j], want, f"cov {i}{j}")
    with pytest.raises(ValueError, match="multinomial"):
        mcmc_tpu_torch.nuts(torch.zeros(2), lk, _settings(2, 2), n_chains=4,
                            key=0, sample_method="multinomial",
                            tree_variant="reference")


_DEPTH_KW = dict(n_chains=128, key=0, adapt_mass_matrix=True,
                 pooled_adaptation=True, adapt_depth=True)


@pytest.fixture(scope="module")
def depth_budget_run():
    lk = tmodels.ill_conditioned_gaussian(8, condition_number=1e3,
                                          device="cpu")
    return lk, mcmc_tpu_torch.nuts(torch.zeros(8), lk, _settings(150, 100),
                                   **_DEPTH_KW)


def _assert_variances(draws, variances):
    for k in range(draws.shape[-1]):
        _assert_moment(draws[..., k] ** 2 / variances[k], 1.0, f"var {k}")


def test_depth_budget_pooled(depth_budget_run):
    """``adapt_depth`` with pooling: one budget shared by every chain, in
    [1, 10], never exceeded while sampling; variances of the 8-d
    ill-conditioned Gaussian within 4 MC standard errors
    (tests/test_nuts.py:296-312)."""
    lk, out = depth_budget_run
    cap = out.diagnostics["depth_cap"]
    assert bool((cap == cap[0]).all()) and 1 <= int(cap[0]) <= 10
    assert int(out.diagnostics["tree_depth"].max()) <= int(cap[0])
    _assert_variances(out.draws, lk.variances)


def test_warmup_tree_depth(depth_budget_run):
    """``warmup_tree_depth=3`` caps the first half of warmup only: the
    adapted step size stays within a factor e^0.7 of the uncapped run's,
    the variances within 4 MC standard errors; 0 raises
    (tests/test_nuts.py:315-336)."""
    lk, base = depth_budget_run
    s = _settings(150, 100)
    capped = mcmc_tpu_torch.nuts(torch.zeros(8), lk, s, warmup_tree_depth=3,
                                 **_DEPTH_KW)
    eps_b = float(base.diagnostics["step_size"][-1].mean())
    eps_c = float(capped.diagnostics["step_size"][-1].mean())
    assert abs(np.log(eps_c / eps_b)) < 0.7
    _assert_variances(capped.draws, lk.variances)
    with pytest.raises(ValueError, match="warmup_tree_depth"):
        mcmc_tpu_torch.nuts(torch.zeros(8), lk, s, warmup_tree_depth=0,
                            **_DEPTH_KW)


def test_static_sampling_depth_and_guard_rails():
    """``static_sampling_depth``: the sampling kernel rebuilt at the learned
    budget; shapes, budget in [1, 10], sampling depths within it, mean and
    covariance of a rho = 0.5 Gaussian within 4 MC standard errors; the
    guard rails raise JAX's ``ValueError`` messages
    (tests/test_nuts.py:396-432)."""
    cov = torch.tensor([[1.0, 0.5], [0.5, 1.0]])
    prec = torch.linalg.inv(cov)
    lk = lambda x: -0.5 * (x * (x @ prec)).sum(-1)
    s = _settings(150, 150, target_accept_rate=0.65)
    out = mcmc_tpu_torch.nuts(torch.zeros(2), lk, s, n_chains=128, key=4,
                              pooled_adaptation=True, adapt_mass_matrix=True,
                              adapt_depth=True, static_sampling_depth=True)
    d = out.draws
    assert d.shape == (150, 128, 2)
    cap = int(out.diagnostics["depth_cap"].max())
    assert 1 <= cap <= 10
    assert int(out.diagnostics["tree_depth"].max()) <= cap
    for i in range(2):
        _assert_moment(d[..., i], 0.0, f"mean {i}")
        for j in range(i, 2):
            _assert_moment(d[..., i] * d[..., j], float(cov[i, j]),
                           f"cov {i}{j}")

    jlk = lambda x: -0.5 * x @ jnp.asarray(prec.numpy()) @ x
    ok = dict(n_burnin_draws=100, n_keep_draws=100, n_adapt_draws=100)
    bad = dict(n_burnin_draws=100, n_keep_draws=100, n_adapt_draws=200)
    for match, sk, kw in (
            ("requires adapt_depth", ok, dict(static_sampling_depth=True)),
            ("checkpoint_dir", ok, dict(adapt_depth=True,
                                        static_sampling_depth=True,
                                        checkpoint_dir="ckpt")),
            ("n_adapt_draws", bad, dict(adapt_depth=True,
                                        static_sampling_depth=True))):
        msgs = []
        for pkg, x0, k in ((mcmc_tpu, jnp.zeros(2), jlk),
                           (mcmc_tpu_torch, torch.zeros(2), lk)):
            with pytest.raises(ValueError, match=match) as e:
                pkg.nuts(x0, k, pkg.NUTSSettings(**sk), n_chains=4, **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


JAX_SEEDS = 8     # JAX runs of a case, for the seed spread


def _jax_over_seeds(x0, log_kernel, n_warm, n_keep, **kw):
    """``mcmc_tpu.nuts`` under ``jax.vmap`` over ``JAX_SEEDS`` keys (one
    compile): the kept draws as ``(draws, seeds x chains, d)``, and each
    seed's final step size and inverse mass (of chain 0: pooled, every
    chain holds the same)."""
    s = mcmc_tpu.NUTSSettings(n_burnin_draws=n_warm, n_keep_draws=n_keep,
                              n_adapt_draws=n_warm,
                              target_accept_rate=0.8)

    def run(key):
        r = mcmc_tpu.nuts(x0, log_kernel, s, key=key, **kw)
        return (r.draws, r.diagnostics["step_size"][-1, 0],
                r.diagnostics["inv_mass_diag"][0])

    draws, eps, inv_mass = jax.jit(jax.vmap(run))(
        jax.random.split(jax.random.PRNGKey(0), JAX_SEEDS))
    draws = torch.tensor(np.asarray(draws)).transpose(0, 1)
    return (draws.reshape(n_keep, -1, draws.shape[-1]), np.asarray(eps),
            np.asarray(inv_mass))


def _assert_same_moments(jd, pd, pairs=False):
    """Means and variances (with ``pairs``, every second moment) of the two
    packages' draws within 4 combined MC standard errors."""
    d = jd.shape[-1]
    fs = []
    for i in range(d):
        fs.append((f"mean {i}", lambda a, i=i: a[..., i]))
        for j in range(i, d if pairs else i + 1):
            fs.append((f"moment {i}{j}",
                       lambda a, i=i, j=j: (a[..., i] - a[..., i].mean())
                       * (a[..., j] - a[..., j].mean())))
    for name, f in fs:
        a, b = f(jd), f(pd)
        tol = N_SIGMA * np.hypot(_mcse(a), _mcse(b))
        diff = abs(float(a.mean()) - float(b.mean()))
        assert diff <= tol, (name, diff, tol)


def _assert_in_seed_spread(what, want, got):
    """The port's one seed against JAX's ``JAX_SEEDS``: within 4 standard
    deviations of their spread, widened by sqrt(1 + 1/JAX_SEEDS) (a
    prediction interval for one more seed), entry by entry."""
    want = want.reshape(JAX_SEEDS, -1)
    got = np.asarray(got).reshape(-1)
    spread = want.std(axis=0, ddof=1) * np.sqrt(1.0 + 1.0 / JAX_SEEDS)
    z = np.abs(got - want.mean(axis=0)) / spread
    assert (z <= N_SIGMA).all(), (what, got, want.mean(axis=0), spread)


def test_logistic_regression_matches_jax():
    """d = 5, 200 rows, the same numpy data through ``mcmc_tpu.nuts`` (8
    seeds under ``jax.vmap``, 10 kept draws each) and the port's ``nuts``
    (one seed, 100 kept draws), pooled adaptation and diagonal mass over 100
    warmup draws. Posterior means and variances agree within 4 combined MC
    standard errors (JAX's 8 x 128 chains counted as one batch). What the
    adaptation ends with, the pooled step size (dual averaging with its
    clock restarted at each mass window's end) and each entry of the pooled
    inverse mass, lies within JAX's seed spread (``_assert_in_seed_spread``);
    pooled, every chain of the port holds the same values."""
    X, y = _flagship()
    d = X.shape[1]
    kw = dict(n_chains=128, pooled_adaptation=True, adapt_mass_matrix=True)
    jd, j_eps, j_inv_mass = _jax_over_seeds(jnp.zeros(d), jlogreg(X, y), 100,
                                            10, **kw)
    out = mcmc_tpu_torch.nuts(torch.zeros(d),
                              tlogreg(*convert.glm_data(X, y, "cpu")),
                              _settings(100, 100, target_accept_rate=0.8),
                              key=0, **kw)
    assert out.draws.shape == (100, 128, d)
    _assert_same_moments(jd, out.draws)
    eps, inv_mass = (out.diagnostics["step_size"][-1],
                     out.diagnostics["inv_mass_diag"])
    _assert_in_seed_spread("step size", j_eps, eps[0])
    _assert_in_seed_spread("inverse mass", j_inv_mass, inv_mass[0])
    assert bool((eps == eps[0]).all() and (inv_mass == inv_mass[0]).all())


_COV = np.array([[1.0, 1.6], [1.6, 4.0]], np.float32)   # rho 0.8, sd 1 and 2


def test_reference_tree_with_dense_mass_matches_jax():
    """The reference tree (each doubling restarts from the current draw,
    the alpha baseline follows it) with the dense mass (momentum by a
    triangular solve, dense kinetic energy) on a correlated 2-d Gaussian,
    pooled, 60 warmup draws: every first and second moment within 4 combined
    MC standard errors of ``mcmc_tpu.nuts``'s (8 seeds x 10 kept draws
    against the port's 100), and the final step size (the accept statistic
    on the reference's baseline drives it) and each entry of the dense
    inverse mass within JAX's seed spread."""
    prec = np.linalg.inv(_COV).astype(np.float32)
    kw = dict(n_chains=128, pooled_adaptation=True, tree_variant="reference",
              adapt_mass_matrix="dense")
    jd, j_eps, j_inv_mass = _jax_over_seeds(
        jnp.zeros(2), lambda x: -0.5 * x @ jnp.asarray(prec) @ x, 60, 10, **kw)
    tprec = torch.from_numpy(prec)
    out = mcmc_tpu_torch.nuts(torch.zeros(2),
                              lambda x: -0.5 * (x * (x @ tprec)).sum(-1),
                              _settings(60, 100, target_accept_rate=0.8),
                              key=1, **kw)
    _assert_same_moments(jd, out.draws, pairs=True)
    _assert_in_seed_spread("step size", j_eps,
                           out.diagnostics["step_size"][-1, 0])
    inv_mass = out.diagnostics["inv_mass_diag"]
    assert inv_mass.shape == (128, 2, 2)
    _assert_in_seed_spread("inverse mass", j_inv_mass, inv_mass[0])


def _closure(fn, name):
    """The function called ``name`` that ``fn`` closes over."""
    cells = dict(zip(fn.__code__.co_freevars, fn.__closure__ or ()))
    return cells[name].cell_contents


def test_dense_momentum_and_kinetic_match_jax():
    """Dense mass: the momentum ``L^{-T} xi`` from the same noise and
    Cholesky factor of each chain's inverse mass, and the kinetic energy
    ``0.5 r . (Sigma r)``, against the JAX kernel's own functions (rtol
    1e-5); the momentum's covariance is the mass ``Sigma^{-1}``."""
    rng = np.random.default_rng(12)
    c, d = 6, 4
    a = rng.standard_normal((c, d, 2 * d))
    sigma = (np.einsum("cik,cjk->cij", a, a) / (2 * d)
             + 0.1 * np.eye(d)).astype(np.float32)
    chol = np.linalg.cholesky(sigma).astype(np.float32)
    noise = rng.standard_normal((c, d)).astype(np.float32)
    lk = lambda z: -0.5 * jnp.sum(z ** 2)
    _, jstep = jnuts.build_nuts_kernel(
        lk, jax.grad(lk), jcommon.make_spd(None, d, jnp.float32),
        mcmc_tpu.NUTSSettings(), 10, adapt_mass_matrix="dense")
    tlk = lambda z: -0.5 * (z ** 2).sum(-1)
    _, tstep = tnuts.build_nuts_kernel(
        tlk, tint.grad_of(tlk), tcommon.make_spd(None, d, torch.float32),
        mcmc_tpu_torch.NUTSSettings(), 10, adapt_mass_matrix="dense")
    want_r = jax.vmap(_closure(jstep, "sample_momentum"))(
        jnp.asarray(noise), jnp.asarray(sigma), jnp.asarray(chol))
    got_r = _closure(tstep, "sample_momentum")(
        *map(torch.from_numpy, (noise, sigma, chol)))
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), rtol=1e-5,
                               atol=1e-6)
    want_k = jax.vmap(_closure(jstep, "kinetic"))(want_r, jnp.asarray(sigma))
    got_k = _closure(tstep, "kinetic")(got_r, torch.from_numpy(sigma))
    np.testing.assert_allclose(got_k.numpy(), np.asarray(want_k), rtol=1e-5)
    # r = L^{-T} xi: L^T r = xi, so Cov(r) = (L L^T)^{-1} = Sigma^{-1}
    np.testing.assert_allclose(
        np.einsum("cji,cj->ci", chol, got_r.numpy()), noise, rtol=1e-4,
        atol=1e-5)


def test_dual_averaging_reports_before_update_and_restarts():
    """The step size a draw reports is the one it ran with (the state's,
    before the update); at a mass window's end the averaging restarts:
    ``mu = log(10 eps)``, ``h = 0``, the clock at the next draw and
    ``epsilon_bar = eps``, as JAX's step does."""
    lk = lambda z: -0.5 * (z * z).sum(-1)
    s = mcmc_tpu_torch.NUTSSettings()
    n_adapt = 100
    init, step = tnuts.build_nuts_kernel(
        lk, tint.grad_of(lk), tcommon.make_spd(None, 3, torch.float32), s,
        n_adapt, pooled_adaptation=True, adapt_mass_matrix="diag")
    _, window_end = tadapt.window_schedule(n_adapt)
    ends = torch.nonzero(window_end).flatten().tolist()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        st = init(gen, torch.zeros((16, 3)))
        for i in range(ends[0] + 2):
            new, info = step(gen, st)
            assert torch.equal(info["step_size"], st.step_size), i
            if i == ends[0]:
                assert new.adapt_t0 == i + 1
                assert bool((new.h_val == 0).all())
                assert torch.equal(new.epsilon_bar, new.step_size)
                assert torch.allclose(new.mu_val,
                                      torch.log(10.0 * new.step_size))
                assert not torch.equal(new.inv_mass, st.inv_mass)
            else:
                assert new.adapt_t0 == st.adapt_t0
                assert not torch.equal(new.step_size, st.step_size)
            st = new


@pytest.mark.parametrize("outside", [-1e8, float("nan")])
def test_divergences_stay_in_their_chains(outside):
    """A wall of ``-1e8`` (tests/test_nuts.py:77-85) or a NaN region past
    ``x0 = 1``: divergences register, no draw leaves the region or goes
    non-finite, and under pooled adaptation no NaN reaches the shared
    accept statistic or step size."""
    lk = lambda v: torch.where(v[:, 0] < 1.0, -0.5 * (v ** 2).sum(-1),
                               torch.full_like(v[:, 0], outside))
    out = mcmc_tpu_torch.nuts(torch.zeros(2), lk, _settings(30, 60),
                              n_chains=32, key=2, pooled_adaptation=True,
                              adapt_mass_matrix=True)
    assert bool(torch.isfinite(out.draws).all())
    assert bool((out.draws[..., 0] < 1.0).all())
    assert int(out.diagnostics["n_divergent"].sum()) > 0
    for k in ("accept_stat", "step_size"):
        assert bool(torch.isfinite(out.diagnostics[k]).all()), k


def test_same_seed_same_draws():
    """Two CPU runs with one seed are bit-equal, draws and traces."""
    lk = tmodels.banana_model(sigma=3.0)
    kw = dict(n_chains=16, key=9, adapt_mass_matrix=True, adapt_depth=True)
    a = mcmc_tpu_torch.nuts(torch.zeros(2), lk, _settings(20, 10), **kw)
    b = mcmc_tpu_torch.nuts(torch.zeros(2), lk, _settings(20, 10), **kw)
    assert torch.equal(a.draws, b.draws)
    for k in ("tree_depth", "accept_stat", "step_size", "depth_cap"):
        assert torch.equal(a.diagnostics[k], b.diagnostics[k]), k
    c = mcmc_tpu_torch.nuts(torch.zeros(2), lk, _settings(20, 10),
                            **{**kw, "key": 10})
    assert not torch.equal(a.draws, c.draws)


OPTION_CASES = {
    "reference_tree": dict(tree_variant="reference"),
    "dense_mass": dict(adapt_mass_matrix="dense", pooled_adaptation=True),
    "diag_mass_unpooled_depth": dict(adapt_mass_matrix="diag",
                                     adapt_depth=True),
    "thin_and_resume": dict(thin=2, return_resume=True),
}


@pytest.mark.parametrize("name", list(OPTION_CASES))
def test_options_run(name):
    """The options not covered above run, with JAX's diagnostics keys and
    shapes; ``return_resume`` continues from the final state."""
    kw = OPTION_CASES[name]
    lk = tmodels.gaussian_mean_scale_model(
        2.0 + 2.0 * np.random.default_rng(11).standard_normal(200),
        device="cpu")
    out = mcmc_tpu_torch.nuts(torch.tensor([2.0, 2.0]), lk,
                              _settings(40, 20), n_chains=8, key=3, **kw)
    assert out.draws.shape == (20, 8, 2)
    assert bool(torch.isfinite(out.draws).all())
    assert out.diagnostics["tree_depth"].shape == (20, 8)
    assert out.diagnostics["n_divergent"].shape == (8,)
    if kw.get("adapt_mass_matrix") == "dense":
        assert out.diagnostics["inv_mass_diag"].shape == (8, 2, 2)
    if kw.get("adapt_depth"):
        assert out.diagnostics["depth_cap"].shape == (8,)
    if kw.get("thin"):
        assert out.diagnostics["thin"] == 2
        more = out.diagnostics["resume"](4, 5)
        assert more.draws.shape == (5, 8, 2) and "resume" in more.diagnostics
    # the (mu, sigma) example: sigma stays positive, mu near the data's
    assert bool((out.draws[..., 1] > 0).all())


def test_single_chain_squeezes():
    """A 1-d start with no ``n_chains`` gives single-chain shapes."""
    out = mcmc_tpu_torch.nuts(torch.zeros(2),
                              lambda v: -0.5 * (v ** 2).sum(-1),
                              _settings(20, 10), key=1,
                              adapt_mass_matrix=True, adapt_depth=True)
    assert out.draws.shape == (10, 2)
    assert out.diagnostics["tree_depth"].shape == (10,)
    assert out.diagnostics["inv_mass_diag"].shape == (2,)
    assert out.diagnostics["depth_cap"].shape == ()


def test_unported_options_raise(tmp_path):
    """A ``mesh=`` that is not a mesh raises; ``checkpoint_dir=`` gives
    the in-memory run's draws."""
    lk = lambda v: -0.5 * (v ** 2).sum(-1)
    assert torch.equal(
        mcmc_tpu_torch.nuts(torch.zeros(2), lk, _settings(2, 2),
                            n_chains=2, key=1).draws,
        mcmc_tpu_torch.nuts(torch.zeros(2), lk, _settings(2, 2),
                            n_chains=2, key=1,
                            checkpoint_dir=tmp_path / "ck").draws)
    with pytest.raises(TypeError, match="DeviceMesh"):
        mcmc_tpu_torch.nuts(torch.zeros(2), lk, _settings(2, 2),
                            mesh=object())
    with pytest.raises(ValueError, match="return_resume"):
        mcmc_tpu_torch.nuts(torch.zeros(2), lk, _settings(2, 2),
                            checkpoint_dir="ckpt", return_resume=True)
