"""The PyTorch port's MAP + Laplace approximation against the JAX
package's, on the CPU.

Fed JAX's restart jitter (the normals ``map_laplace`` draws from its key),
the port's batched Adam search and Hessian give, on the cases of
``tests/test_laplace.py:18``, ``:35``, ``:53`` and ``:68``, the mode at rtol
1e-4, the covariance at rtol 1e-3 (of its largest entry) and the same
ordering of the restarts' best log-posteriors. Where the optimum is flat
the mode is known only to the objective's float32 resolution, and the mode
is then also allowed that: the distance over which the log-posterior
changes by a few of its roundings, ``4 sqrt(eps |log_post| max var)``
(1.1e-3 in z on the bounded Gamma, whose best iterates of the two packages
sit 1.3e-4 apart; 0 on the Gaussian, where they agree bit for bit). The
written-out Adam is held against ``optax.adam`` over 50 steps fed the same
gradients (rtol 1e-5);
``convert.laplace_result`` hands JAX's mode and factor to the port's
``draw_init``, ``init_box`` and ``log_evidence``; ``optimizer=`` takes a
PyTorch optimizer factory.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mcmc_tpu
import mcmc_tpu_torch
from mcmc_tpu_torch import convert
from mcmc_tpu_torch import laplace as tlaplace
from mcmc_tpu_torch.samplers import common as tcommon

MU = np.array([1.5, -2.0, 0.5], np.float32)
COV = np.array([[2.0, 0.6, 0.0], [0.6, 1.0, -0.2], [0.0, -0.2, 0.5]],
               np.float32)
PREC = np.linalg.inv(COV).astype(np.float32)


def _mvn():
    jlk = lambda x: -0.5 * (x - MU) @ PREC @ (x - MU)
    P, M = torch.tensor(PREC), torch.tensor(MU)
    tlk = lambda x: -0.5 * (((x - M) @ P) * (x - M)).sum(-1)
    return jlk, tlk


def _gamma():
    return (lambda x: 2.0 * jnp.log(x[0]) - 2.0 * x[0],
            lambda x: 2.0 * torch.log(x[:, 0]) - 2.0 * x[:, 0])


def _mixture():
    comp = lambda x, m: jnp.exp(-0.5 * jnp.sum((x - m) ** 2) / 0.25)
    tcomp = lambda x, m: torch.exp(-0.5 * ((x - m) ** 2).sum(-1) / 0.25)
    return (lambda x: jnp.log(0.1 * comp(x, -3.0) + 0.9 * comp(x, 3.0)
                              + 1e-300),
            lambda x: torch.log(0.1 * tcomp(x, -3.0) + 0.9 * tcomp(x, 3.0)
                                + 1e-300))


def _disk():
    return (lambda x: jnp.where(jnp.sum(x ** 2) < 4.0,
                                -jnp.sum((x - 0.5) ** 2), -jnp.inf),
            lambda x: torch.where((x ** 2).sum(-1) < 4.0,
                                  -((x - 0.5) ** 2).sum(-1),
                                  torch.full_like(x[:, 0], -torch.inf)))


# name: (kernels, x0, bounds, map_laplace keywords), test_laplace.py's
CASES = {
    "gaussian": (_mvn, np.zeros(3, np.float32), None,
                 dict(n_steps=800, learning_rate=0.1), 0),
    "bounded_gamma": (_gamma, np.full(1, 0.3, np.float32), 0.0,
                      dict(n_steps=800, learning_rate=0.05), 1),
    "restarts": (_mixture, np.full(2, -3.0, np.float32), None,
                 dict(n_restarts=8, restart_scale=4.0, n_steps=600,
                      learning_rate=0.1), 3),
    "nonfinite_overshoot": (_disk, np.zeros(2, np.float32), None,
                            dict(n_steps=400, learning_rate=0.3), 4),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_laplace_matches_jax_fed_its_jitter(name):
    kernels, x0, lb, kw, seed = CASES[name]
    jlk, tlk = kernels()
    jset = tset = None
    if lb is not None:
        jset = mcmc_tpu.AlgoSettings(vals_bound=True,
                                     lower_bounds=jnp.full(1, lb))
        tset = mcmc_tpu_torch.AlgoSettings(vals_bound=True,
                                           lower_bounds=np.full(1, lb))
    key = jax.random.PRNGKey(seed)
    want = mcmc_tpu.map_laplace(jnp.asarray(x0), jlk, jset, key=key, **kw)
    n_restarts = kw.get("n_restarts", 4)
    # JAX's jitter: normals from the key, restart 0 unjittered
    jit = np.array(jax.random.normal(key, (n_restarts, x0.shape[0])))
    jit = jit * kw.get("restart_scale", 1.0)
    jit[0] = 0.0
    prob = tcommon.setup_problem(torch.tensor(x0), tlk,
                                 tset or mcmc_tpu_torch.AlgoSettings(),
                                 n_chains=n_restarts, device="cpu")
    got = tlaplace._solve(prob, prob.first_draw + torch.tensor(jit),
                          kw["n_steps"], kw["learning_rate"], None)
    cov_j = np.asarray(want.cov)
    resolution = 4.0 * np.sqrt(np.finfo(np.float32).eps
                               * abs(float(want.log_post))
                               * np.diag(cov_j).max())
    np.testing.assert_allclose(got.mode_z.numpy(), np.asarray(want.mode_z),
                               rtol=1e-4, atol=max(resolution, 1e-6))
    np.testing.assert_allclose(
        got.mode.numpy(), np.asarray(want.mode), rtol=1e-4,
        atol=max(resolution * np.abs(np.asarray(want.mode)).max(), 1e-6))
    np.testing.assert_allclose(got.cov.numpy(), cov_j, rtol=1e-3,
                               atol=1e-3 * np.abs(cov_j).max())
    lp_j = np.asarray(want.restart_log_posts)
    lp_t = got.restart_log_posts.numpy()
    np.testing.assert_allclose(lp_t, lp_j, rtol=1e-4, atol=1e-5)
    if np.ptp(lp_j) > 1e-3:   # distinct modes: the same ordering
        np.testing.assert_array_equal(np.argsort(lp_t), np.argsort(lp_j))
    assert float(got.grad_norm) < 1e-2


def test_adam_matches_optax_fed_the_same_gradients():
    """Fifty steps of the written-out Adam against ``optax.adam`` over one
    sequence of gradients (a linear objective whose gradient is the
    sequence, handed out in turn)."""
    rng = np.random.default_rng(0)
    grads = (rng.normal(size=(50, 3, 4)) * np.logspace(-3, 1, 4)).astype(
        np.float32)
    z0 = rng.normal(size=(3, 4)).astype(np.float32)
    opt = optax.adam(0.05)

    def step(carry, g):
        z, st = carry
        upd, st = opt.update(g, st, z)
        return (optax.apply_updates(z, upd), st), None

    z0j = jnp.asarray(z0)
    (z, _), _ = jax.jit(lambda g: jax.lax.scan(step, (z0j, opt.init(z0j)),
                                               g))(jnp.asarray(grads))
    calls = iter(torch.tensor(grads))
    neg = lambda v: (v * next(calls)).sum(-1)
    last, _bz, _bf = tlaplace._adam_search(neg, torch.tensor(z0), 50, 0.05)
    np.testing.assert_allclose(last.numpy(), np.asarray(z), rtol=1e-5,
                               atol=1e-7)


def test_port_pieces_on_jax_result():
    """``convert.laplace_result`` hands JAX's bounded Gamma fit to the
    port: ``init_box`` and ``log_evidence`` as JAX's, ``draw_init`` inside
    the bound with the widened Laplace spread."""
    jlk, _ = _gamma()
    s = mcmc_tpu.AlgoSettings(vals_bound=True, lower_bounds=jnp.zeros(1))
    lap = mcmc_tpu.map_laplace(jnp.full(1, 0.3), jlk, s, n_steps=800,
                               learning_rate=0.05, key=jax.random.PRNGKey(1))
    port = convert.laplace_result(lap, device="cpu")
    for got, want in zip(port.init_box(2.0), lap.init_box(2.0)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(float(port.log_evidence),
                               float(lap.log_evidence), rtol=1e-6)
    inits = port.draw_init(2, 4000)
    assert inits.shape == (4000, 1) and bool((inits > 0).all())
    z = torch.log(inits[:, 0])
    sd = 2.0 * float(np.sqrt(np.asarray(lap.cov)[0, 0]))
    assert float(z.std()) == pytest.approx(sd, rel=0.05)


def test_torch_optimizer_factory_and_validation():
    """``optimizer=`` takes a PyTorch optimizer factory (deviation: JAX
    takes an optax transformation); the checks keep JAX's types."""
    _, tlk = _mvn()
    lap = mcmc_tpu_torch.map_laplace(
        torch.zeros(3), tlk, n_steps=600, key=0,
        optimizer=lambda p: torch.optim.Adam(p, lr=0.1))
    np.testing.assert_allclose(lap.mode.numpy(), MU, atol=5e-3)
    np.testing.assert_allclose(lap.cov.numpy(), COV, atol=5e-3)
    with pytest.raises(TypeError, match="settings"):
        mcmc_tpu_torch.map_laplace(torch.zeros(3), tlk, settings=1.0)
    with pytest.raises(ValueError, match="n_restarts"):
        mcmc_tpu_torch.map_laplace(torch.zeros(3), tlk, n_restarts=0)
