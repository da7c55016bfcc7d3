"""The PyTorch port's SVGD against the JAX package's, on the CPU.

The pieces on the same numpy clouds: ``_pairwise_sq``, the median-heuristic
bandwidth (element ``N*N // 2`` of the sorted distances, the upper middle
of an even N^2, which neither ``torch.median`` nor ``jnp.median`` gives)
and ``_svgd_direction``, rtol 1e-5. Then 20 Adam steps from the initial
cloud JAX's ``svgd`` draws from its key against its final cloud and
update-norm trace (rtol 1e-4), and the Adam state after them against
optax's. The rest is distributional, on the cases of ``tests/test_svgd.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mcmc_tpu_torch
from mcmc_tpu.svgd import _pairwise_sq as jpair
from mcmc_tpu.svgd import _svgd_direction as jdir
from mcmc_tpu.svgd import svgd as jsvgd
from mcmc_tpu_torch import convert
from mcmc_tpu_torch._optim import adam_init, adam_step
from mcmc_tpu_torch.integrators import grad_of

# the package re-exports the svgd *function* under the module's name
tsvgd = importlib.import_module("mcmc_tpu_torch.svgd")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for every test here: the tests run in several
    worker processes at once, and torch's default of a thread per core
    oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_bandwidth(d2, N):
    med2 = jnp.sort(d2.reshape(-1))[(N * N) // 2]
    logN = jnp.log(jnp.asarray(N, jnp.float32))
    return jnp.maximum(med2 / jnp.maximum(logN, 1.0), 1e-6)


@pytest.mark.parametrize("N", [4, 7, 64])
def test_pieces_match_jax(N):
    """Distances, bandwidth and direction on a numpy cloud and gradient,
    rtol 1e-5; at an even N^2 the bandwidth is the upper middle."""
    rng = np.random.default_rng(N)
    X = rng.standard_normal((N, 3)).astype(np.float32)
    g = rng.standard_normal((N, 3)).astype(np.float32)
    d2j = jpair(jnp.asarray(X))
    d2t = tsvgd._pairwise_sq(torch.from_numpy(X))
    np.testing.assert_allclose(d2t.numpy(), np.asarray(d2j), rtol=1e-5,
                               atol=1e-5)
    hj = _jax_bandwidth(d2j, N)
    ht = tsvgd._bandwidth(d2t, N)
    np.testing.assert_allclose(float(ht), float(hj), rtol=1e-5)
    if N % 2 == 0:
        flat = np.sort(d2t.numpy().reshape(-1))
        lower = torch.median(d2t.reshape(-1))
        assert flat[N * N // 2] != flat[N * N // 2 - 1]
        assert float(ht) != float(tsvgd._bandwidth(
            torch.full_like(d2t, float(lower)), N))
    phij = jdir(jnp.asarray(X), jnp.asarray(g), hj, d2=d2j)
    phit = tsvgd._svgd_direction(torch.from_numpy(X), torch.from_numpy(g),
                                 ht, d2=d2t)
    np.testing.assert_allclose(phit.numpy(), np.asarray(phij), rtol=1e-5,
                               atol=1e-6)


def _gauss():
    cov = np.array([[2.0, 0.8], [0.8, 1.0]], np.float32)
    prec = np.linalg.inv(cov).astype(np.float32)
    mu = np.array([1.0, -2.0], np.float32)
    pj, mj = jnp.asarray(prec), jnp.asarray(mu)
    pt, mt = torch.from_numpy(prec), torch.from_numpy(mu)
    return (cov, mu, lambda x: -0.5 * (x - mj) @ pj @ (x - mj),
            lambda x: -0.5 * (((x - mt) @ pt) * (x - mt)).sum(-1))


def test_steps_from_jax_cloud_match_jax():
    """20 steps of 32 particles from JAX's initial cloud: the final cloud
    and the trace at rtol 1e-4; the port's Adam state after them against
    optax's, run on the same directions."""
    _cov, _mu, jlk, tlk = _gauss()
    N, key = 32, jax.random.PRNGKey(2)
    want = jsvgd(jnp.zeros(2), jlk, n_particles=N, n_steps=20, key=key)
    X0 = np.asarray(jax.random.normal(key, (N, 2), jnp.float32))
    Xf, trace = tsvgd._transport(torch.from_numpy(X0.copy()), grad_of(tlk),
                                 20, 0.05)
    np.testing.assert_allclose(Xf.numpy(), np.asarray(want.particles),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(trace.numpy(),
                               np.asarray(want.grad_norm_trace), rtol=1e-4)
    # the Adam state: optax's on the port's directions, step by step
    opt = optax.adam(0.05)
    X, st = torch.from_numpy(X0.copy()), adam_init(torch.from_numpy(X0))
    Xj = jnp.asarray(X0)
    sj = opt.init(Xj)
    for _ in range(5):
        d2 = tsvgd._pairwise_sq(X)
        phi = tsvgd._svgd_direction(X, grad_of(tlk)(X),
                                    tsvgd._bandwidth(d2, N), d2=d2)
        X, st = adam_step(X, -phi, st, 0.05)
        upd, sj = opt.update(jnp.asarray(-phi.numpy()), sj, Xj)
        Xj = optax.apply_updates(Xj, upd)
        Xj = jnp.asarray(X.numpy())   # follow the port's cloud
    conv = convert.adam_state(sj, "cpu")
    np.testing.assert_allclose(st.mu.numpy(), conv.mu.numpy(), rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(st.nu.numpy(), conv.nu.numpy(), rtol=1e-5,
                               atol=1e-10)
    assert st.count == conv.count == 5


def test_gaussian_moments_and_repulsion():
    """``tests/test_svgd.py``'s Gaussian at its bounds, with fewer
    particles and steps (256 x 800 and 128 x 800, where the JAX test runs
    512 x 1500 and 256 x 1500: the CPU's (N, N) sort sets the time): the
    mean within 0.02 and the covariance within 0.15 of the target's, the
    update norm decayed; on N(0, I) the cloud keeps the target's spread
    (no collapse)."""
    cov, mu, _jlk, tlk = _gauss()
    r = mcmc_tpu_torch.svgd(torch.zeros(2), tlk, n_particles=256,
                            n_steps=800, key=0)
    P = r.particles.numpy()
    np.testing.assert_allclose(P.mean(0), mu, atol=0.02)
    np.testing.assert_allclose(np.cov(P.T), cov, atol=0.15)
    tr = r.grad_norm_trace.numpy()
    assert tr[-50:].mean() < 0.1 * tr[:50].mean()
    r = mcmc_tpu_torch.svgd(torch.zeros(2), lambda x: -0.5 * (x ** 2).sum(-1),
                            n_particles=128, n_steps=800, key=1)
    np.testing.assert_allclose(r.particles.numpy().std(axis=0), 1.0,
                               rtol=0.2)


def test_bimodal_bounded_and_validation():
    """Both modes of a separated mixture keep particles; a Gamma(3, 2) with
    a lower bound at 0 keeps every particle positive, mean within 0.15 of
    1.5 (128 particles and 800 steps each, where the JAX test runs 256 x
    1500); one particle raises."""
    lk = lambda x: torch.logaddexp(-0.5 * ((x - 2.0) ** 2).sum(-1) / 0.25,
                                   -0.5 * ((x + 2.0) ** 2).sum(-1) / 0.25)
    r = mcmc_tpu_torch.svgd(torch.zeros(1), lk, n_particles=128,
                            n_steps=800, init_scale=3.0, key=2)
    P = r.particles.numpy()[:, 0]
    assert 0.3 < (P > 0).mean() < 0.7
    s = mcmc_tpu_torch.AlgoSettings(vals_bound=True,
                                    lower_bounds=np.zeros(1))
    g = mcmc_tpu_torch.svgd(torch.ones(1),
                            lambda x: 2.0 * torch.log(x[:, 0]) - 2.0 * x[:, 0],
                            s, n_particles=128, n_steps=800, key=3)
    P = g.particles.numpy()
    assert P.min() > 0.0 and abs(P.mean() - 1.5) < 0.15
    with pytest.raises(ValueError, match="n_particles"):
        mcmc_tpu_torch.svgd(torch.zeros(2), lk, n_particles=1)
