"""The PyTorch port's fused GLM trajectory against the JAX package's.

On the CPU the port runs the plain PyTorch version of its CUDA kernel; the
JAX side runs its Pallas kernel in interpret mode, as
tests/test_fused_logreg.py does, at that file's sizes. Inputs are made with
numpy from a seed and handed to both packages.

Tolerances: both sides round z and r to bf16 the same way (round to nearest
even) and accumulate the products in f32, so only the summation order
differs. Measured differences are about 2e-7 in z, p and in U relative;
the tests hold z and p to atol 1e-5 and U to rtol 1e-5. A trajectory that
skips either bf16 rounding point misses by 3e-5 or more in z and 5e-4 or
more in p, so these tolerances catch it where 1e-3 would not.

The CUDA kernel itself is held against this plain version on the card in
tests/test_torch_kernels_cuda.py.

The run-time-parameter trajectory (``make_fused_trajectory_rt``: step size
and diagonal inverse mass at call time) is held to the same tolerances
against the JAX package's, and at inverse mass 1 to the bits of the
fixed-step trajectory.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_tpu.ops import fused_logreg as jfl
from mcmc_tpu_torch import convert
from mcmc_tpu_torch.ops import fused_logreg as tfl

D, N, L, EPS = 10, 64, 3, 0.05
N_CHAINS = 16
LINKS = ["logistic", "poisson", "linear", "probit", "studentt"]


def _links(name):
    if name == "studentt":
        return jfl.studentt_link(4.0), tfl.studentt_link(4.0)
    return name, name


def _data(name, seed=0):
    rng = np.random.default_rng(seed)
    X = (0.4 * rng.standard_normal((N, D))).astype(np.float32)
    eta = X @ (0.5 * np.ones(D))
    if name in ("logistic", "probit"):
        y = rng.uniform(size=N) < 1.0 / (1.0 + np.exp(-eta))
    elif name == "poisson":
        y = rng.poisson(np.exp(eta))
    elif name == "studentt":
        y = eta + 0.3 * rng.standard_t(4.0, size=N)
    else:
        y = eta + 0.1 * rng.standard_normal(N)
    return X, np.asarray(y, np.float32)


def _state(dp, seed=1):
    rng = np.random.default_rng(seed)
    z = np.zeros((N_CHAINS, dp), np.float32)
    p = np.zeros((N_CHAINS, dp), np.float32)
    z[:, :D] = 0.1 * rng.standard_normal((N_CHAINS, D))
    p[:, :D] = rng.standard_normal((N_CHAINS, D))
    return z, p


@pytest.mark.parametrize("name", LINKS)
def test_trajectory_matches_pallas(name):
    X, y = _data(name)
    jlink, tlink = _links(name)
    jtraj = jfl.make_fused_trajectory(X, y, 10.0, EPS, L, block_chains=8,
                                      interpret=True, link=jlink)
    Xt, yt = convert.glm_data(X, y, "cpu")
    ttraj = tfl.make_fused_trajectory(Xt, yt, 10.0, EPS, L, block_chains=8,
                                      link=tlink)
    assert ttraj.dim_padded == jtraj.dim_padded
    z0, p0 = _state(ttraj.dim_padded)

    zj, pj, uj = jtraj(jnp.asarray(z0), jnp.asarray(p0))
    zt, pt, ut = ttraj(torch.from_numpy(z0), torch.from_numpy(p0))

    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=1e-5)
    assert torch.all(zt[:, D:] == 0) and torch.all(pt[:, D:] == 0)


@pytest.mark.parametrize("name", LINKS)
def test_init_matches_reference_potential(name):
    """``step.init`` computes the f32 potential as JAX's
    ``reference_potential`` does (f32 on both sides; rtol 1e-5 covers the
    summation order); the JAX state carried over by ``convert`` equals the
    port's."""
    X, y = _data(name)
    jlink, tlink = _links(name)
    pos = 0.1 * np.random.default_rng(2).standard_normal((N_CHAINS, D))
    pos = pos.astype(np.float32)
    jstep = jfl.make_fused_hmc_step(X, y, step_size=EPS, n_leap=L,
                                    block_chains=8, interpret=True, link=jlink)
    Xt, yt = convert.glm_data(X, y, "cpu")
    tstep = tfl.make_fused_hmc_step(Xt, yt, step_size=EPS, n_leap=L,
                                    block_chains=8, link=tlink)
    js = jstep.init(jnp.asarray(pos))
    carried = convert.fused_state(js.position, js.potential,
                                  tstep.dim_padded, "cpu")
    ts = tstep.init(torch.from_numpy(pos))
    np.testing.assert_allclose(ts.potential.numpy(), np.asarray(js.potential),
                               rtol=1e-5)
    assert torch.equal(ts.position, carried.position)


def test_callable_link_has_no_kernel():
    """A callable link the kernel does not know raises on the kernel path
    instead of falling back; ``studentt_link`` is known by its code."""
    X, y = convert.glm_data(*_data("linear"), "cpu")
    z, p = (torch.from_numpy(a) for a in _state(128))
    with pytest.raises(NotImplementedError, match="callable link"):
        tfl.fused_trajectory_cuda(z, p, X, y, y, 0.01, EPS, L,
                                  lambda eta, yv: (eta, -0.5 * (yv - eta) ** 2))
    assert tfl._link_code(tfl.studentt_link(4.0)) == (4, 4.0)
    assert tfl._link_code("probit") == (3, 0.0)
    with pytest.raises(ValueError, match="nu must be positive"):
        tfl.studentt_link(0.0)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper takes CUDA tensors only; on the CPU the dispatcher
    runs the plain version."""
    X, y = convert.glm_data(*_data("logistic"), "cpu")
    traj = tfl.make_fused_trajectory(X, y, 10.0, EPS, L, block_chains=8)
    z, p = (torch.from_numpy(a) for a in _state(128))
    args = (traj.Xb, traj.y, traj.mask, traj.inv_pv, EPS, L, "logistic")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfl.fused_trajectory_cuda(z, p, *args)
    for a, b in zip(tfl.fused_trajectory(z, p, *args),
                    tfl._fused_trajectory_plain(z, p, *args)):
        assert torch.equal(a, b)


def test_block_chains_must_divide_chains():
    X, y = convert.glm_data(*_data("logistic"), "cpu")
    traj = tfl.make_fused_trajectory(X, y, 10.0, EPS, L, block_chains=8)
    z, p = (torch.from_numpy(a[:12]) for a in _state(128))
    with pytest.raises(ValueError, match="multiple of"):
        traj(z, p)


def _inv_mass(dp):
    im = np.ones(dp, np.float32)
    im[:D] = np.linspace(0.5, 2.0, D)
    return im


@pytest.mark.parametrize("name", ["logistic", "poisson", "studentt"])
def test_trajectory_rt_matches_pallas(name):
    X, y = _data(name)
    jlink, tlink = _links(name)
    jtraj = jfl.make_fused_trajectory_rt(X, y, 10.0, L, block_chains=8,
                                         interpret=True, link=jlink)
    ttraj = tfl.make_fused_trajectory_rt(X, y, 10.0, L, block_chains=8,
                                         link=tlink, device="cpu")
    assert ttraj.dim_padded == jtraj.dim_padded and ttraj.dim == D
    z0, p0 = _state(ttraj.dim_padded)
    im = _inv_mass(ttraj.dim_padded)

    zj, pj, uj = jtraj(jnp.asarray(z0), jnp.asarray(p0), jnp.asarray(EPS),
                       jnp.asarray(im))
    zt, pt, ut = ttraj(torch.from_numpy(z0), torch.from_numpy(p0), EPS,
                       torch.from_numpy(im))

    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=1e-5)
    assert torch.all(zt[:, D:] == 0) and torch.all(pt[:, D:] == 0)


def test_trajectory_rt_with_unit_mass_equals_fixed_step():
    """Inverse mass 1 and the fixed trajectory's step: the same bits; and
    the step as a float, a 0-d tensor and a numpy inverse mass agree."""
    X, y = _data("logistic")
    fixed = tfl.make_fused_trajectory(X, y, 10.0, EPS, L, block_chains=8,
                                      device="cpu")
    rt = tfl.make_fused_trajectory_rt(X, y, 10.0, L, block_chains=8,
                                      device="cpu")
    z, p = (torch.from_numpy(a) for a in _state(rt.dim_padded))
    ones = torch.ones(rt.dim_padded)
    want = fixed(z, p)
    for eps in (EPS, torch.tensor(EPS)):
        for a, b in zip(rt(z, p, eps, ones), want):
            assert torch.equal(a, b)
    im = _inv_mass(rt.dim_padded)
    for a, b in zip(rt(z, p, EPS, im), rt(z, p, torch.tensor(EPS),
                                          torch.from_numpy(im))):
        assert torch.equal(a, b)
    assert not torch.equal(rt(z, p, EPS, im)[0], want[0])


def test_trajectory_rt_wrapper_and_block_chains():
    """The run-time entry's wrapper refuses CPU tensors, its dispatcher
    runs the plain version there, and the factory keeps the
    ``block_chains`` check."""
    X, y = _data("logistic")
    rt = tfl.make_fused_trajectory_rt(X, y, 10.0, L, block_chains=8,
                                      device="cpu")
    z, p = (torch.from_numpy(a) for a in _state(rt.dim_padded))
    im = torch.from_numpy(_inv_mass(rt.dim_padded))
    args = (rt.Xb, rt.y, rt.mask, rt.inv_pv, EPS, L, "logistic", im)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfl.fused_trajectory_rt_cuda(z, p, *args)
    for a, b in zip(tfl.fused_trajectory_rt(z, p, *args),
                    tfl._fused_trajectory_plain(z, p, *args[:-1], im)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="multiple of"):
        rt(z[:12], p[:12], EPS, im)
    with pytest.raises(ValueError, match="n_leap"):
        tfl.make_fused_trajectory_rt(X, y, 10.0, 0, device="cpu")
