"""The PyTorch port's fused Gaussian HMC against the JAX package's.

On the CPU the port runs the plain PyTorch version of its CUDA kernel; the
JAX side runs its Pallas kernel in interpret mode, as
tests/test_fused_logreg.py does. Inputs are made with numpy from a seed and
handed to both packages (``convert.gaussian_target`` carries P and m over).

Tolerances: both sides are f32 and compute the same operations, ``(z - m) @
P`` included, so only the summation order of the products differs: z, p and
U to rtol 2e-4, atol 2e-4, the reference's own tolerance against its XLA
leapfrog (tests/test_fused_logreg.py:156-161). The sampler checks are
distributional (the generators differ): mean atol 0.25 and variance rtol
0.35, the JAX package's own (tests/test_fused_logreg.py:185-186, :338).

The CUDA kernel itself is held against this plain version on the card in
tests/test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmc_tpu.ops
import mcmc_tpu_torch
import mcmc_tpu_torch.ops
from mcmc_tpu.models import ill_conditioned_gaussian as j_ill_conditioned
from mcmc_tpu.ops import fused_logreg as jfl
from mcmc_tpu_torch import convert
from mcmc_tpu_torch.models import ill_conditioned_gaussian
from mcmc_tpu_torch.ops import fused_logreg as tfl

N_CHAINS = 16


def _target(kind, dim, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "dense":
        A = rng.standard_normal((dim, dim))
        return (A @ A.T / dim + np.eye(dim)).astype(np.float32)
    if kind == "diagonal":
        return (1.0 / np.linspace(0.5, 4.0, dim)).astype(np.float32)
    # log-spaced variances, condition number 1e3
    return (1.0 / np.logspace(0.0, 3.0, dim)).astype(np.float32)


def _state(dim, dp, seed=1, scale=0.1):
    rng = np.random.default_rng(seed)
    z = np.zeros((N_CHAINS, dp), np.float32)
    p = np.zeros((N_CHAINS, dp), np.float32)
    z[:, :dim] = scale * rng.standard_normal((N_CHAINS, dim))
    p[:, :dim] = rng.standard_normal((N_CHAINS, dim))
    return z, p


# name: (precision kind, dim, with a mean, step size, n_leap, eps override)
CASES = {
    "dense_with_mean": ("dense", 8, True, 0.05, 3, None),
    "diagonal_precision": ("diagonal", 6, True, 0.05, 3, None),
    "mean_none": ("dense", 8, False, 0.05, 3, None),
    "runtime_eps": ("dense", 8, True, 0.05, 3, 0.11),
    "long_ill_conditioned_16d": ("logspaced", 16, False, 0.9, 32, None),
}


@pytest.mark.parametrize("name", list(CASES))
def test_trajectory_matches_pallas(name):
    kind, dim, with_mean, eps0, n_leap, eps = CASES[name]
    P = _target(kind, dim)
    mean = np.random.default_rng(3).standard_normal(dim).astype(np.float32) \
        if with_mean else None
    jtraj = jfl.make_fused_gaussian_trajectory(
        jnp.asarray(P), None if mean is None else jnp.asarray(mean),
        step_size=eps0, n_leap=n_leap, block_chains=8, interpret=True)
    Pt, mt = convert.gaussian_target(P, mean, "cpu")
    ttraj = tfl.make_fused_gaussian_trajectory(
        Pt, mt, step_size=eps0, n_leap=n_leap, block_chains=8)
    assert (ttraj.dim, ttraj.dim_padded) == (dim, jtraj.dim_padded)
    z0, p0 = _state(dim, ttraj.dim_padded,
                    scale=1.0 if kind == "logspaced" else 0.1)

    jeps = None if eps is None else jnp.asarray(eps, jnp.float32)
    teps = None if eps is None else torch.tensor(eps)
    zj, pj, uj = jtraj(jnp.asarray(z0), jnp.asarray(p0), jeps)
    zt, pt, ut = ttraj(torch.from_numpy(z0), torch.from_numpy(p0), teps)

    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), **tol)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **tol)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), **tol)
    assert torch.all(zt[:, dim:] == 0) and torch.all(pt[:, dim:] == 0)
    if eps is not None:   # the override is used, as a tensor and as a float
        assert not torch.equal(zt, ttraj(torch.from_numpy(z0),
                                         torch.from_numpy(p0))[0])
        assert torch.equal(zt, ttraj(torch.from_numpy(z0),
                                     torch.from_numpy(p0), eps)[0])


def test_padded_operands():
    """The padding rules of the JAX factory: a 1-d precision is a diagonal,
    the padded diagonal is the identity, a missing mean is zero."""
    prec = _target("diagonal", 6)
    traj = tfl.make_fused_gaussian_trajectory(prec, device="cpu")
    want = np.eye(128, dtype=np.float32)
    want[:6, :6] = np.diag(prec)
    assert np.array_equal(traj.P.numpy(), want)
    assert traj.mean.shape == (128,) and not traj.mean.any()
    P, m = convert.gaussian_target(prec, None, "cpu")
    assert P.dtype == torch.float32 and P.shape == (6,) and m is None
    with pytest.raises(ValueError, match="precision must be"):
        convert.gaussian_target(np.ones((2, 3)), None, "cpu")
    with pytest.raises(ValueError, match="mean must be"):
        convert.gaussian_target(np.eye(3), np.zeros(4), "cpu")


@pytest.mark.parametrize("kind", ["dense", "diagonal"])
def test_init_matches_jax(kind):
    """``step.init`` pads the positions and computes the f32 potential as
    the JAX ``step.init`` does (rtol 1e-5 covers the summation order)."""
    dim = 8
    P = _target(kind, dim)
    mean = np.random.default_rng(3).standard_normal(dim).astype(np.float32)
    pos = np.random.default_rng(2).standard_normal((N_CHAINS, dim))
    pos = pos.astype(np.float32)
    jstep = jfl.make_fused_gaussian_hmc_step(
        jnp.asarray(P), jnp.asarray(mean), block_chains=8, interpret=True)
    tstep = tfl.make_fused_gaussian_hmc_step(
        *convert.gaussian_target(P, mean, "cpu"), block_chains=8)
    js = jstep.init(jnp.asarray(pos))
    ts = tstep.init(torch.from_numpy(pos))
    assert (tstep.dim, tstep.dim_padded) == (dim, jstep.dim_padded)
    np.testing.assert_allclose(ts.potential.numpy(), np.asarray(js.potential),
                               rtol=1e-5)
    carried = convert.fused_state(js.position, js.potential,
                                  tstep.dim_padded, "cpu")
    assert torch.equal(ts.position, carried.position)


def test_hmc_step_samples_target():
    """The fused Gaussian HMC step samples N(mean, P^-1): the 4-d case of
    tests/test_fused_logreg.py:166-186, same sizes and tolerances."""
    var = np.array([0.5, 2.0, 1.0, 4.0], np.float32)
    mean = np.array([1.0, -1.0, 0.5, 2.0], np.float32)
    step = tfl.make_fused_gaussian_hmc_step(
        np.diag(1.0 / var), mean, step_size=0.4, n_leap=5, block_chains=8,
        device="cpu")
    st = step.init(torch.zeros((32, 4)))
    gen = torch.Generator().manual_seed(0)
    draws = []
    for i in range(400):
        st, info = step(gen, st)
        if i >= 100:
            draws.append(st.position[:, :4])
    assert info["accepted"].shape == (32,)
    assert torch.all(st.position[:, 4:] == 0)
    d = torch.cat(draws).numpy()
    np.testing.assert_allclose(d.mean(axis=0), mean, atol=0.25)
    np.testing.assert_allclose(d.var(axis=0), var, rtol=0.35)


GAUSS_SETTINGS = dict(step_size=0.8, n_leap=20, n_chains=16,
                      n_burnin_draws=200, n_keep_draws=600, block_chains=8)


def test_fused_gaussian_hmc_matches_jax():
    """The entry point on the diagonal case of
    tests/test_fused_logreg.py:331-338: both packages recover the marginal
    variances within rtol 0.35 and a zero mean within 0.25 sd."""
    variances = np.array([1.0, 4.0, 25.0, 100.0], np.float32)
    ref = mcmc_tpu.ops.fused_gaussian_hmc(
        jnp.asarray(1.0 / variances), key=jax.random.PRNGKey(6),
        interpret=True, **GAUSS_SETTINGS)
    out = mcmc_tpu_torch.fused_gaussian_hmc(1.0 / variances, key=6,
                                            device="cpu", **GAUSS_SETTINGS)
    assert out.draws.shape == ref.draws.shape == (600, 16, 4)
    assert torch.isfinite(out.draws).all()
    rate = float(out.diagnostics["accept_rate_per_chain"].mean())
    assert 0.5 < rate <= 1.0
    for draws in (out.draws.numpy(), np.asarray(ref.draws)):
        flat = draws.reshape(-1, 4)
        np.testing.assert_allclose(flat.var(axis=0), variances, rtol=0.35)
        np.testing.assert_allclose(flat.mean(axis=0) / np.sqrt(variances), 0.0,
                                   atol=0.25)


def test_fused_gaussian_hmc_same_seed_same_draws():
    """The same seed on the same device gives bit-identical draws; another
    seed does not; a CPU tensor precision needs no ``device=``."""
    prec = torch.tensor([1.0, 0.25, 0.04, 0.01])
    kw = dict(GAUSS_SETTINGS, n_burnin_draws=10, n_keep_draws=20)
    a = mcmc_tpu_torch.fused_gaussian_hmc(prec, key=7, **kw)
    b = mcmc_tpu_torch.fused_gaussian_hmc(
        prec, key=torch.Generator().manual_seed(7), **kw)
    c = mcmc_tpu_torch.fused_gaussian_hmc(prec, key=8, **kw)
    assert a.draws.device.type == "cpu"
    assert torch.equal(a.draws, b.draws)
    assert torch.equal(a.n_accept_draws, b.n_accept_draws)
    assert not torch.equal(a.draws, c.draws)


def test_step_jitter_draws_the_step_on_the_device():
    """With jitter 0 two transitions from the same state and momenta use
    the same step; with jitter they do not. The jitter is drawn from the
    run's generator between the momenta and the accept uniforms."""
    prec = _target("diagonal", 6)
    pos = torch.ones((8, 6))

    def positions(jitter, seed):
        step = tfl.make_fused_gaussian_hmc_step(
            prec, step_size=0.3, n_leap=4, block_chains=8,
            step_jitter=jitter, device="cpu")
        gen = torch.Generator().manual_seed(seed)
        return step(gen, step.init(pos))[0].position

    assert torch.equal(positions(0.0, 1), positions(0.0, 1))
    assert not torch.equal(positions(0.0, 1), positions(0.5, 1))
    # the documented order of draws: momenta, jitter, accept uniforms
    gen = torch.Generator().manual_seed(1)
    p0 = torch.randn((8, 128), generator=gen)
    p0[:, 6:] = 0
    eps = 0.3 * (1.0 + 0.5 * (2.0 * torch.rand((), generator=gen) - 1.0))
    traj = tfl.make_fused_gaussian_trajectory(prec, step_size=0.3, n_leap=4,
                                              block_chains=8, device="cpu")
    z0 = torch.zeros((8, 128))
    z0[:, :6] = pos
    z_new = traj(z0, p0, eps)[0]
    got = positions(0.5, 1)
    moved = (got != z0).any(dim=1)
    assert moved.any() and torch.equal(got[moved], z_new[moved])


def test_factories_check_block_chains_and_wrapper_refuses_cpu():
    traj = tfl.make_fused_gaussian_trajectory(_target("dense", 8),
                                              block_chains=8, device="cpu")
    z, p = (torch.from_numpy(a) for a in _state(8, 128))
    with pytest.raises(ValueError, match="multiple of"):
        traj(z[:12], p[:12])
    with pytest.raises(ValueError, match="n_leap"):
        tfl.make_fused_gaussian_trajectory(_target("dense", 8), n_leap=0,
                                           device="cpu")
    args = (z, p, traj.P, traj.mean, 0.1, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfl.fused_gaussian_trajectory_cuda(*args)
    for a, b in zip(tfl.fused_gaussian_trajectory(*args),
                    tfl._fused_gaussian_trajectory_plain(*args)):
        assert torch.equal(a, b)


def test_ops_exports_cover_the_jax_package():
    assert set(mcmc_tpu.ops.__all__) <= set(mcmc_tpu_torch.ops.__all__)
    for name in mcmc_tpu_torch.ops.__all__:
        assert hasattr(mcmc_tpu_torch.ops, name), name
    assert mcmc_tpu_torch.fused_gaussian_hmc is \
        mcmc_tpu_torch.ops.fused_gaussian_hmc
    assert "fused_gaussian_hmc" in mcmc_tpu_torch.__all__


def test_ill_conditioned_gaussian_matches_jax():
    jk = j_ill_conditioned(100, 1e4)
    tk = ill_conditioned_gaussian(100, 1e4, device="cpu")
    np.testing.assert_allclose(tk.variances.numpy(), np.asarray(jk.variances),
                               rtol=1e-6)
    x = np.random.default_rng(0).standard_normal((5, 100)).astype(np.float32)
    np.testing.assert_allclose(tk(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.vmap(jk)(jnp.asarray(x))),
                               rtol=1e-5)
    assert tk(torch.from_numpy(x[0])).shape == ()
