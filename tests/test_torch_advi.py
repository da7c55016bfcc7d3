"""The PyTorch port's ADVI against the JAX package's, on the CPU.

The written-out Adam under the decayed rate against ``optax.adam(optax.
exponential_decay(lr, T, 0.01))`` over 20 steps of the same gradients
(rtol 1e-5, and the schedule itself at every count); the negative ELBO and
its gradient at a given ``phi`` and normals against ``jax.value_and_grad``
of the JAX package's ELBO formula (``mcmc_tpu/advi.py``), mean-field and
full-rank, with a masked out-of-support sample (rtol 1e-5); and whole
runs of 20 steps fed the normals JAX's ``advi`` draws from its keys against
its ELBO trace, mean and Cholesky factor. The rest is distributional, on
the cases of ``tests/test_advi.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mcmc_tpu_torch
from mcmc_tpu.advi import advi as jadvi
from mcmc_tpu_torch import convert
from mcmc_tpu_torch._optim import adam_init, adam_step, exponential_decay

# the package re-exports the advi *function* under the module's name
tadvi_mod = importlib.import_module("mcmc_tpu_torch.advi")
T = 20


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for every test here: the tests run in several
    worker processes at once, and torch's default of a thread per core
    oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_decayed_adam_matches_optax():
    """20 steps on a dict of parameters, the gradients numpy-drawn: every
    iterate and both moments at rtol 1e-5; the schedule equal to optax's
    at every count."""
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal(3).astype(np.float32),
          "b": rng.standard_normal((2, 2)).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * 10.0 ** rng.uniform(-3, 1))
              .astype(np.float32) for k, v in p0.items()} for _ in range(T)]
    sched_j = optax.exponential_decay(0.05, T, 0.01)
    opt = optax.adam(sched_j)
    pj, sj = {k: jnp.asarray(v) for k, v in p0.items()}, None
    sj = opt.init(pj)
    pt = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    st = adam_init(pt)
    sched_t = exponential_decay(0.05, T, 0.01)
    for t, g in enumerate(grads):
        assert abs(sched_t(t) - float(sched_j(t))) <= 1e-7 * 0.05, t
        upd, sj = opt.update({k: jnp.asarray(v) for k, v in g.items()}, sj,
                             pj)
        pj = optax.apply_updates(pj, upd)
        pt, st = adam_step(pt, {k: torch.from_numpy(v) for k, v in g.items()},
                           st, sched_t)
        for k in p0:
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    conv = convert.adam_state(sj, "cpu")
    assert conv.count == st.count == T
    for k in p0:
        np.testing.assert_allclose(st.mu[k].numpy(), conv.mu[k].numpy(),
                                   rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(st.nu[k].numpy(), conv.nu[k].numpy(),
                                   rtol=1e-5, atol=1e-10)


def _jax_neg_elbo(box, d, full_rank):
    """The JAX package's ELBO (``mcmc_tpu/advi.py``'s ``unpack`` and
    ``neg_elbo``), for ``jax.value_and_grad``."""
    tril = jnp.tril_indices(d, k=-1)

    def neg_elbo(phi, zs):
        diag = jnp.exp(phi["log_diag"])
        L = jnp.diag(diag)
        if full_rank:
            L = jnp.zeros((d, d)).at[tril].set(phi["off"]) + L
        xs = phi["mu"] + zs @ L.T
        ok = jnp.isfinite(jax.vmap(box)(jax.lax.stop_gradient(xs)))
        xs_safe = jnp.where(ok[:, None], xs,
                            jax.lax.stop_gradient(phi["mu"])[None, :])
        lps = jnp.where(ok, jax.vmap(box)(xs_safe), 0.0)
        mean_lp = lps.sum() / jnp.maximum(ok.sum(), 1)
        ent = jnp.sum(jnp.log(diag)) + 0.5 * d * (1.0 + jnp.log(2 * jnp.pi))
        return -(mean_lp + ent)
    return neg_elbo


def _targets():
    """A correlated Gaussian and a density that is -inf (with a NaN
    gradient) for x_0 <= 0: (JAX single-point, port batched)."""
    prec = np.linalg.inv(np.array([[2.0, 0.9], [0.9, 1.0]])).astype(
        np.float32)
    mu = np.array([1.0, -2.0], np.float32)
    pj, mj, pt, mt = jnp.asarray(prec), jnp.asarray(mu), \
        torch.from_numpy(prec), torch.from_numpy(mu)
    gauss = (lambda x: -4.0 - 0.5 * (x - mj) @ pj @ (x - mj),
             lambda x: -4.0 - 0.5 * (((x - mt) @ pt) * (x - mt)).sum(-1))
    gamma = (lambda x: 2.0 * jnp.log(x[0]) - 2.0 * x[0] - 0.1 * x[1] ** 2,
             lambda x: 2.0 * torch.log(x[:, 0]) - 2.0 * x[:, 0]
             - 0.1 * x[:, 1] ** 2)
    return {"gauss": gauss, "gamma": gamma}


@pytest.mark.parametrize("full_rank", [False, True])
@pytest.mark.parametrize("target", ["gauss", "gamma"])
def test_elbo_and_gradient_match_jax(full_rank, target):
    """The negative ELBO and its gradient in every entry of ``phi`` at a
    numpy-drawn ``phi`` and normals, rtol 1e-5; on the Gamma-like target
    some samples fall outside the support and are masked on both sides."""
    d, n_mc = 2, 16
    rng = np.random.default_rng(4)
    phi = {"mu": np.array([0.8, 0.3], np.float32),
           "log_diag": rng.uniform(-1.0, 0.0, d).astype(np.float32)}
    if full_rank:
        phi["off"] = np.array([0.4], np.float32)
    zs = rng.standard_normal((n_mc, d)).astype(np.float32)
    jbox, tbox = _targets()[target]
    lj, gj = jax.value_and_grad(_jax_neg_elbo(jbox, d, full_rank))(
        {k: jnp.asarray(v) for k, v in phi.items()}, jnp.asarray(zs))
    _unpack, neg = tadvi_mod._objective(tbox, d, full_rank, torch.float32,
                                        "cpu")
    lt, gt = tadvi_mod._value_and_grad(neg, convert.advi_phi(phi, "cpu"),
                                       torch.from_numpy(zs))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    for k in phi:
        np.testing.assert_allclose(gt[k].numpy(), np.asarray(gj[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    if target == "gamma":
        xs = phi["mu"] + zs @ np.asarray(_unpack(convert.advi_phi(
            phi, "cpu"))[1]).T
        assert (xs[:, 0] <= 0).any() and (xs[:, 0] > 0).any()


@pytest.mark.parametrize("full_rank", [False, True])
def test_run_fed_jax_normals_matches_jax(full_rank):
    """20 steps of JAX's ``advi`` and of the port's loop fed the normals
    JAX draws from its keys: the ELBO trace, the averaged mean and the
    Cholesky factor at rtol 1e-5."""
    jbox, tbox = _targets()["gauss"]
    d, n_mc = 2, 8
    key = jax.random.PRNGKey(3)
    want = jadvi(jnp.zeros(d), jbox, full_rank=full_rank, n_steps=T,
                 n_mc=n_mc, key=key)
    zs = [torch.from_numpy(np.array(jax.random.normal(k, (n_mc, d),
                                                      jnp.float32)))
          for k in jax.random.split(key, T)]
    unpack, neg = tadvi_mod._objective(tbox, d, full_rank, torch.float32,
                                       "cpu")
    phi0 = {"mu": torch.zeros(d), "log_diag": torch.full((d,), -1.0)}
    if full_rank:
        phi0["off"] = torch.zeros(1)
    phi, trace = tadvi_mod._optimize(neg, phi0, T, 0.05, lambda t: zs[t])
    mu, L, _ = unpack(phi)
    np.testing.assert_allclose(trace.numpy(), np.asarray(want.elbo_trace),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mu.numpy(), np.asarray(want.mean_z),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(L.numpy(), np.asarray(want.chol), rtol=1e-5,
                               atol=1e-6)


def test_full_rank_recovers_correlated_gaussian():
    """``tests/test_advi.py``'s case: the mean within 0.1, L L^T within
    0.2 of the covariance, the ELBO within 0.1 of log Z (q is exact for a
    Gaussian), the draws' covariance within 0.25."""
    cov = np.array([[2.0, 0.9], [0.9, 1.0]], np.float32)
    _jb, tbox = _targets()["gauss"]
    logZ = -4.0 + np.log(2 * np.pi) + 0.5 * np.linalg.slogdet(cov)[1]
    r = mcmc_tpu_torch.advi(torch.zeros(2), tbox, full_rank=True,
                            n_steps=3000, key=0)
    np.testing.assert_allclose(r.mean.numpy(), [1.0, -2.0], atol=0.1)
    L = r.chol.numpy()
    np.testing.assert_allclose(L @ L.T, cov, atol=0.2)
    assert abs(float(r.elbo) - logZ) < 0.1
    d = r.draw(1, 40000).numpy()
    np.testing.assert_allclose(np.cov(d.T), cov, atol=0.25)
    assert r.elbo_trace.shape == (3000,)


def test_mean_field_and_bounded_gamma():
    """Mean-field on a correlated Gaussian learns the precision-matched
    scales sqrt(1 - rho^2); on a Gamma(3, 2) with a lower bound at 0 every
    draw is positive and their mean within 0.2 of 1.5; a bad settings type
    raises."""
    rho = 0.8
    prec = torch.linalg.inv(torch.tensor([[1.0, rho], [rho, 1.0]]))
    r = mcmc_tpu_torch.advi(torch.zeros(2),
                            lambda x: -0.5 * ((x @ prec) * x).sum(-1),
                            n_steps=3000, key=2)
    np.testing.assert_allclose(r.mean_z.numpy(), 0.0, atol=0.08)
    np.testing.assert_allclose(r.sd_z.numpy(), np.sqrt(1 - rho ** 2),
                               rtol=0.15)
    s = mcmc_tpu_torch.AlgoSettings(vals_bound=True,
                                    lower_bounds=np.zeros(1))
    g = mcmc_tpu_torch.advi(torch.ones(1),
                            lambda x: 2.0 * torch.log(x[:, 0]) - 2.0 * x[:, 0],
                            s, n_steps=2000, key=3)
    d = g.draw(4, 20000).numpy()
    assert d.min() > 0.0 and abs(d.mean() - 1.5) < 0.2
    assert float(g.mean[0]) > 0.0
    with pytest.raises(TypeError, match="settings"):
        mcmc_tpu_torch.advi(torch.zeros(2), lambda x: -(x * x).sum(-1),
                            settings=5)
