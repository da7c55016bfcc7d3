"""The PyTorch port's HMC stack against the JAX package's: settings surface,
bounded gradients, leapfrog, state carried across, and the sampler's
posterior. Inputs are made with numpy from a seed and handed to both."""

import dataclasses
import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmc_tpu
import mcmc_tpu_torch
from mcmc_tpu import adaptation as jadapt
from mcmc_tpu import integrators as jint
from mcmc_tpu import settings as jset
from mcmc_tpu.models import logistic_regression_model as jlogreg
from mcmc_tpu.samplers import common as jcommon
from mcmc_tpu_torch import adaptation as tadapt
from mcmc_tpu_torch import convert
from mcmc_tpu_torch import integrators as tint
from mcmc_tpu_torch import settings as tset
from mcmc_tpu_torch.models import (logistic_regression_model as tlogreg,
                                   make_logistic_regression_data)
from mcmc_tpu_torch.samplers import common as tcommon

# the packages' samplers/__init__ re-export the hmc *function* under the
# module's name
jhmc = importlib.import_module("mcmc_tpu.samplers.hmc")
thmc = importlib.import_module("mcmc_tpu_torch.samplers.hmc")
jnuts = importlib.import_module("mcmc_tpu.samplers.nuts")
tnuts = importlib.import_module("mcmc_tpu_torch.samplers.nuts")

D, N = 10, 64


def _data(seed=2):
    X, y, _ = make_logistic_regression_data(seed, N, D, device="cpu")
    return X.numpy(), y.numpy()


def _surface(module):
    out = {}
    for name, cls in vars(module).items():
        if isinstance(cls, type) and dataclasses.is_dataclass(cls):
            fields = []
            for f in dataclasses.fields(cls):
                default = f.default
                if f.default_factory is not dataclasses.MISSING:
                    default = f.default_factory.__name__
                fields.append((f.name, default))
            out[name] = fields
    return out


def test_settings_surface_matches():
    """Every settings dataclass: same names, fields, order and defaults."""
    jsurf, tsurf = _surface(jset), _surface(tset)
    assert len(jsurf) == 24
    assert tsurf == jsurf
    assert tset.__all__ == jset.__all__


def test_nuts_surface_matches():
    """``nuts()``: the JAX package's parameters, kinds and defaults, in
    order, plus the ``device`` keyword every entry point of the port adds;
    the module's public names are the same, and both packages export
    ``nuts`` at the top."""
    jsig = inspect.signature(jnuts.nuts).parameters
    tsig = dict(inspect.signature(tnuts.nuts).parameters)
    assert tsig.pop("device").default is None
    assert [(p.name, p.kind, p.default) for p in tsig.values()] == \
        [(p.name, p.kind, p.default) for p in jsig.values()]
    assert tnuts.__all__ == jnuts.__all__
    assert mcmc_tpu_torch.nuts is tnuts.nuts and "nuts" in mcmc_tpu.__all__
    assert "nuts" in mcmc_tpu_torch.__all__


@pytest.mark.parametrize("name,module", [("chees", "chees"),
                                         ("ghmc", "ghmc"),
                                         ("mclmc", "mclmc"),
                                         ("mams", "mclmc")])
def test_sampler_surface_matches(name, module):
    """``chees``, ``ghmc``, ``mclmc`` and ``mams``: the JAX package's
    parameters, kinds and defaults, in order, plus ``device``; each module's
    public names are JAX's; both packages have the entry point at the top,
    and the port lists it in ``__all__`` there and in ``samplers``."""
    jmod = importlib.import_module(f"mcmc_tpu.samplers.{module}")
    tmod = importlib.import_module(f"mcmc_tpu_torch.samplers.{module}")
    jsig = inspect.signature(getattr(jmod, name)).parameters
    tsig = dict(inspect.signature(getattr(tmod, name)).parameters)
    assert tsig.pop("device").default is None
    assert [(p.name, p.kind, p.default) for p in tsig.values()] == \
        [(p.name, p.kind, p.default) for p in jsig.values()]
    assert tmod.__all__ == jmod.__all__
    assert getattr(mcmc_tpu_torch, name) is getattr(tmod, name)
    assert name in mcmc_tpu_torch.__all__ and callable(getattr(mcmc_tpu, name))
    assert getattr(mcmc_tpu_torch.samplers, name) is getattr(tmod, name)


def test_adaptation_names_match():
    """The port's ``adaptation.__all__`` holds every public name of the JAX
    package's, in its order, and the windowed steps it does not list."""
    jnames = list(jadapt.__all__)
    assert [n for n in tadapt.__all__ if n in jnames] == jnames
    for n in ("make_precond_cfg", "windowed_precond_step",
              "windowed_dense_step", "windowed_mass_update"):
        assert callable(getattr(tadapt, n)) and callable(getattr(jadapt, n))


@pytest.mark.parametrize("kind", ["identity", "diag"])
def test_leapfrog_matches_jax(kind):
    """One trajectory from identical (z, p): f32 on both sides, so only the
    summation order of the gradient differs (atol 1e-5)."""
    X, y = _data()
    rng = np.random.default_rng(4)
    z0 = (0.3 * rng.standard_normal((8, D))).astype(np.float32)
    p0 = rng.standard_normal((8, D)).astype(np.float32)
    m = None if kind == "identity" else np.linspace(0.5, 2.0, D)
    jspd = jcommon.make_spd(m, D, jnp.float32)
    tspd = tcommon.make_spd(m, D, torch.float32)

    jgrad = jax.grad(jlogreg(X, y))
    zj, pj = jax.vmap(lambda z, p: jint.leapfrog(
        jgrad, jspd.inv_mv, 0.05, 6, z, p))(z0, p0)
    zt, pt = tint.leapfrog(tint.grad_of(tlogreg(*convert.glm_data(X, y, "cpu"))),
                           tspd.inv_mv, 0.05, 6, torch.from_numpy(z0),
                           torch.from_numpy(p0))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["reference", "exact"])
def test_bounded_kick_gradient_matches_jax(mode):
    """``make_kick_grad`` on a box-constrained problem (codes 1-4), both
    modes: the transforms, Jacobians and their AD-safe branches agree with
    the JAX package in f32 (rtol 1e-5), including lanes far out in z where
    an unselected branch overflows: no NaN. (The reference convention's
    own Jacobian overflows to inf there, on both sides.)"""
    lb = np.array([-np.inf, 0.0, -np.inf, -1.0], np.float32)
    ub = np.array([np.inf, np.inf, 2.0, 3.0], np.float32)
    z = np.array([[0.3, -0.5, 0.2, 0.1], [1.5, -100.0, 100.0, -3.0],
                  [-2.0, 4.0, -1.0, 60.0]], np.float32)

    def jk(x):
        return -0.5 * jnp.sum((x - 0.5) ** 2 * jnp.arange(1.0, 5.0))

    def tk(x):
        return -0.5 * ((x - 0.5) ** 2 * torch.arange(1.0, 5.0)).sum(dim=-1)

    jalgo = jset.AlgoSettings(vals_bound=True, lower_bounds=lb, upper_bounds=ub)
    talgo = tset.AlgoSettings(vals_bound=True, lower_bounds=lb, upper_bounds=ub)
    jprob = jcommon.setup_problem(np.zeros(4, np.float32), jk, jalgo, 3)
    tprob = tcommon.setup_problem(np.zeros(4, np.float32), tk, talgo, 3,
                                  device="cpu")
    gj = jax.vmap(jint.make_kick_grad(jprob, mode))(z)
    gt = tint.make_kick_grad(tprob, mode)(torch.from_numpy(z))
    assert not torch.isnan(gt).any()
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tprob.box_log_kernel(torch.from_numpy(z)).numpy(),
                               np.asarray(jax.vmap(jprob.box_log_kernel)(z)),
                               rtol=1e-5)


@pytest.mark.parametrize("mass", ["diag", "dense"])
def test_hmc_state_carries_over(mass):
    """A JAX ``HMCState`` batch carried over by ``convert.hmc_state`` equals
    the port's own ``init`` of the same positions (potential: f32 sums,
    rtol 1e-5), and the port's kernel steps from it."""
    X, y = _data()
    pos = (0.1 * np.random.default_rng(5).standard_normal((4, D))
           ).astype(np.float32)
    collect, wend = jadapt.window_schedule(100)
    jinit, _ = jhmc.build_hmc_kernel(
        jlogreg(X, y), None, jcommon.make_spd(None, D, jnp.float32), 0.05, 3,
        {"n_burnin": 100, "target": 0.8},
        {"n_burnin": 100, "collect": collect, "window_end": wend,
         "mode": mass})
    carried = convert.hmc_state(jax.vmap(jinit)(jnp.asarray(pos)), "cpu")

    tk = tlogreg(*convert.glm_data(X, y, "cpu"))
    tcollect, twend = tadapt.window_schedule(100)
    tinit, tstep = thmc.build_hmc_kernel(
        tk, tint.grad_of(tk), tcommon.make_spd(None, D, torch.float32), 0.05,
        3, {"n_burnin": 100, "target": 0.8},
        {"n_burnin": 100, "collect": tcollect, "window_end": twend,
         "mode": mass})
    own = tinit(torch.from_numpy(pos))
    for name, a, b in zip(own._fields, own, carried):
        if name == "da":
            for u, v in zip(a, b):
                torch.testing.assert_close(u, v)
        elif name == "potential":
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
        else:
            assert torch.equal(a, b), name
    gen = torch.Generator().manual_seed(0)
    st, info = tstep(gen, carried)
    assert st.position.shape == (4, D) and info["accepted"].shape == (4,)
    assert bool((st.draw_ind == 1).all())


def test_hmc_posterior_mean_matches_jax():
    """The posterior mean of the port's ``hmc`` on the logistic model
    agrees with the JAX package's within atol 0.3, with the settings of
    tests/test_fused_logreg.py:73-79. The generators differ, so the check
    is distributional: 0.3 bounds the Monte-Carlo error of two 16-chain
    runs on this posterior."""
    X, y = _data()
    s = dict(n_burnin_draws=500, n_keep_draws=600, step_size=0.08,
             n_leap_steps=5)
    ref = mcmc_tpu.hmc(jnp.zeros(D), jlogreg(X, y), mcmc_tpu.HMCSettings(**s),
                       n_chains=16, key=jax.random.PRNGKey(5))
    out = mcmc_tpu_torch.hmc(torch.zeros(D), tlogreg(*convert.glm_data(X, y, "cpu")),
                             mcmc_tpu_torch.HMCSettings(**s), n_chains=16,
                             key=5)
    assert out.draws.shape == (600, 16, D)
    assert 0.5 < float(out.accept_rate.mean()) <= 1.0
    np.testing.assert_allclose(out.draws.mean(dim=(0, 1)).numpy(),
                               np.asarray(ref.draws).mean(axis=(0, 1)),
                               atol=0.3)


def test_unported_options_raise(tmp_path):
    """``mesh=`` is not ignored silently; ``checkpoint_dir=`` gives the
    in-memory run's draws."""
    X, y = _data()
    k = tlogreg(*convert.glm_data(X, y, "cpu"))
    s = mcmc_tpu_torch.HMCSettings(n_burnin_draws=1, n_keep_draws=1)
    with pytest.raises(NotImplementedError, match="A12"):
        mcmc_tpu_torch.hmc(torch.zeros(D), k, s, mesh=object())
    assert torch.equal(
        mcmc_tpu_torch.hmc(torch.zeros(D), k, s, key=1).draws,
        mcmc_tpu_torch.hmc(torch.zeros(D), k, s, key=1,
                           checkpoint_dir=tmp_path / "ck").draws)
    with pytest.raises(ValueError, match="positive definite"):
        tcommon.make_spd(-np.eye(D), D, torch.float32)
