"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU. The file
imports no JAX, so that it runs on a machine without it:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: kernel and plain version round z and r to bf16 at the same
points and accumulate in f32, so only the summation order differs; at these
shapes the two f32 sums can round z to different bf16 neighbours at a few
of the rounding points, so z and p agree to atol 1e-4 and U to rtol 1e-4.
The Gaussian kernel and its plain version are f32 throughout and round the
update alike; the summation order of their products differs, over n_leap + 1
dependent products: z, p and U to rtol 1e-4, atol 1e-4 of values of order 1
at 32 leapfrogs (measured about 1e-5 of scale at 157).
"""

import numpy as np
import pytest
import torch

from mcmc_tpu_torch.ops import fused_logreg as tfl


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    # the plain version's f32 matmuls in full f32
    torch.backends.cuda.matmul.allow_tf32 = False


def _problem(name, dim, n=1000, chains=100, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, dim)) / np.sqrt(dim)
    eta = X @ rng.standard_normal(dim)
    if name == "poisson":
        y = rng.poisson(np.exp(0.5 * eta))
    elif name in ("linear", "studentt"):
        y = eta + 0.1 * rng.standard_normal(n)
    else:
        y = rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-eta))
    link = tfl.studentt_link(4.0) if name == "studentt" else name
    traj = tfl.make_fused_trajectory(
        torch.tensor(X, dtype=torch.float32),
        torch.tensor(np.asarray(y, np.float64), dtype=torch.float32),
        10.0, 0.01, 4, block_chains=1, link=link, device="cuda")
    dp = traj.dim_padded
    z = torch.zeros((chains, dp), device="cuda")
    p = torch.zeros((chains, dp), device="cuda")
    z[:, :dim] = torch.tensor(0.5 * rng.standard_normal((chains, dim)),
                              dtype=torch.float32)
    p[:, :dim] = torch.tensor(rng.standard_normal((chains, dim)),
                              dtype=torch.float32)
    return z, p, (traj.Xb, traj.y, traj.mask, traj.inv_pv, 0.01, 4, link)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [10, 200])
@pytest.mark.parametrize("name", ["logistic", "poisson", "linear", "probit",
                                  "studentt"])
def test_kernel_matches_plain(name, dim):
    """Both padded widths (128, 256), a ragged last chain tile (100 chains)
    and 1000 rows (padded to 1024)."""
    _require_card()
    z, p, args = _problem(name, dim)
    before = tfl.fused_trajectory_cuda.launches
    zk, pk, uk = tfl.fused_trajectory_cuda(z, p, *args)
    zp, pp, up = tfl._fused_trajectory_plain(z, p, *args)
    torch.cuda.synchronize()
    assert tfl.fused_trajectory_cuda.launches == before + 1
    torch.testing.assert_close(zk, zp, rtol=0, atol=1e-4)
    torch.testing.assert_close(pk, pp, rtol=0, atol=1e-4)
    torch.testing.assert_close(uk, up, rtol=1e-4, atol=0)
    assert torch.all(zk[:, dim:] == 0) and torch.all(pk[:, dim:] == 0)


@pytest.mark.cuda
def test_kernel_is_deterministic():
    """Two launches on the same inputs give bit-identical outputs (fixed
    reduction order), which the port's RNG contract relies on."""
    _require_card()
    z, p, args = _problem("logistic", 100, chains=1000)
    a = tfl.fused_trajectory_cuda(z, p, *args)
    b = tfl.fused_trajectory_cuda(z, p, *args)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.cuda
def test_callable_link_raises_on_card():
    """A callable link the kernel has no code for: on CUDA tensors the
    trajectory raises instead of falling back to the plain version."""
    _require_card()
    z, p, args = _problem("linear", 10)
    link = lambda eta, yv: (eta, -0.5 * (yv - eta) ** 2)  # noqa: E731
    with pytest.raises(NotImplementedError, match="callable link"):
        tfl.fused_trajectory(z, p, *args[:-1], link)


def _inv_mass(dp, dim):
    im = torch.ones((dp,), device="cuda")
    im[:dim] = torch.linspace(0.5, 2.0, dim, device="cuda")
    return im


@pytest.mark.cuda
@pytest.mark.parametrize("chains", [1, 33, 2048])
@pytest.mark.parametrize("dim", [100, 200])
def test_rt_kernel_matches_plain(dim, chains):
    """The run-time entry: step size on the card, diagonal inverse mass,
    both padded widths, ragged chain counts."""
    _require_card()
    z, p, args = _problem("logistic", dim, chains=chains)
    Xb, y, mask, inv_pv, _eps, n_leap, link = args
    eps = torch.tensor(0.013, device="cuda")
    im = _inv_mass(z.shape[1], dim)
    before = (tfl.fused_trajectory_rt_cuda.launches,
              tfl.fused_trajectory_cuda.launches)
    zk, pk, uk = tfl.fused_trajectory_rt_cuda(z, p, Xb, y, mask, inv_pv, eps,
                                              n_leap, link, im)
    zp, pp, up = tfl._fused_trajectory_plain(z, p, Xb, y, mask, inv_pv, eps,
                                             n_leap, link, im)
    torch.cuda.synchronize()
    assert (tfl.fused_trajectory_rt_cuda.launches,
            tfl.fused_trajectory_cuda.launches) == (before[0] + 1, before[1])
    torch.testing.assert_close(zk, zp, rtol=0, atol=1e-4)
    torch.testing.assert_close(pk, pp, rtol=0, atol=1e-4)
    torch.testing.assert_close(uk, up, rtol=1e-4, atol=0)
    assert torch.all(zk[:, dim:] == 0) and torch.all(pk[:, dim:] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["logistic", "studentt"])
def test_rt_kernel_with_unit_mass_equals_fixed_step(name):
    """Inverse mass 1 and the same step: the bits of the fixed-step entry,
    with the step as a float and as a 0-d tensor on the card."""
    _require_card()
    z, p, args = _problem(name, 100, chains=1000)
    Xb, y, mask, inv_pv, eps, n_leap, link = args
    want = tfl.fused_trajectory_cuda(z, p, *args)
    ones = torch.ones((z.shape[1],), device="cuda")
    for e in (eps, torch.tensor(eps, device="cuda")):
        got = tfl.fused_trajectory_rt_cuda(z, p, Xb, y, mask, inv_pv, e,
                                           n_leap, link, ones)
        for u, v in zip(got, want):
            assert torch.equal(u, v)


def _gaussian_problem(kind, dim, chains, n_leap=32, seed=5):
    rng = np.random.default_rng(seed)
    prec = 1.0 / np.logspace(0.0, 3.0, dim)
    mean = None
    if kind == "dense":
        Q, _ = np.linalg.qr(rng.standard_normal((dim, dim)))
        prec = (Q * prec) @ Q.T
        prec = 0.5 * (prec + prec.T)
        mean = rng.standard_normal(dim)
    traj = tfl.make_fused_gaussian_trajectory(prec, mean, 0.9, n_leap,
                                              block_chains=1, device="cuda")
    dp = traj.dim_padded
    z = torch.zeros((chains, dp), device="cuda")
    p = torch.zeros((chains, dp), device="cuda")
    z[:, :dim] = torch.tensor(rng.standard_normal((chains, dim)),
                              dtype=torch.float32)
    p[:, :dim] = torch.tensor(rng.standard_normal((chains, dim)),
                              dtype=torch.float32)
    eps = torch.tensor(0.9, device="cuda")
    return traj, (z, p, traj.P, traj.mean, eps, n_leap)


@pytest.mark.cuda
@pytest.mark.parametrize("chains", [1, 33, 2048])
@pytest.mark.parametrize("kind", ["diagonal", "dense"])
def test_gaussian_kernel_matches_plain(kind, chains):
    """Dp 128 from 100 dims, ragged chain counts."""
    _require_card()
    dim = 100
    _traj, args = _gaussian_problem(kind, dim, chains)
    zp, pp, up = tfl._fused_gaussian_trajectory_plain(*args)
    before = tfl.fused_gaussian_trajectory_cuda.launches
    zk, pk, uk = tfl.fused_gaussian_trajectory_cuda(*args)
    torch.cuda.synchronize()
    assert tfl.fused_gaussian_trajectory_cuda.launches == before + 1
    torch.testing.assert_close(zk, zp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(pk, pp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(uk, up, rtol=1e-4, atol=1e-4)
    assert torch.all(zk[:, dim:] == 0) and torch.all(pk[:, dim:] == 0)
    if kind == "diagonal":   # one non-zero term per product: exact
        assert torch.equal(zk, zp) and torch.equal(pk, pp)


@pytest.mark.cuda
def test_gaussian_kernel_is_deterministic_and_reads_eps_on_the_card():
    """Two launches give the same bits; the step is read from device
    memory at run time, as a float or a tensor; the trajectory built by
    ``make_fused_gaussian_trajectory`` launches the kernel."""
    _require_card()
    traj, args = _gaussian_problem("dense", 100, 1000)
    a = tfl.fused_gaussian_trajectory_cuda(*args)
    b = tfl.fused_gaussian_trajectory_cuda(*args)
    c = tfl.fused_gaussian_trajectory_cuda(*args[:4], 0.9, args[5])
    before = tfl.fused_gaussian_trajectory_cuda.launches
    d = traj(args[0], args[1])
    assert tfl.fused_gaussian_trajectory_cuda.launches == before + 1
    for u, v, w, x in zip(a, b, c, d):
        assert torch.equal(u, v) and torch.equal(u, w) and torch.equal(u, x)
    e = tfl.fused_gaussian_trajectory_cuda(*args[:4], args[4] * 0.5, args[5])
    assert not torch.equal(a[0], e[0])


@pytest.mark.cuda
def test_widths_not_instantiated_raise():
    """Beyond the instantiated widths the wrappers raise: the Gaussian
    kernel takes dim <= 128, the GLM kernel dim <= 256."""
    _require_card()
    traj = tfl.make_fused_gaussian_trajectory(np.ones(200), block_chains=1,
                                              device="cuda")
    z = torch.zeros((8, traj.dim_padded), device="cuda")
    with pytest.raises(ValueError, match="dim_padded"):
        traj(z, z.clone())
    rng = np.random.default_rng(0)
    glm = tfl.make_fused_trajectory(
        torch.tensor(rng.standard_normal((64, 300)), dtype=torch.float32),
        torch.zeros(64), 10.0, 0.01, 2, block_chains=1, device="cuda")
    z = torch.zeros((8, glm.dim_padded), device="cuda")
    with pytest.raises(ValueError, match="dim_padded"):
        glm(z, z.clone())
