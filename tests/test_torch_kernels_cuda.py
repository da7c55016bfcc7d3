"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU. The file
imports no JAX, so that it runs on a machine without it:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: kernel and plain version round z and r to bf16 at the same
points and accumulate in f32, so only the summation order differs; at these
shapes the two f32 sums can round z to different bf16 neighbours at a few
of the rounding points, so z and p agree to atol 1e-4 and U to rtol 1e-4.
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
    elif name == "linear":
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
@pytest.mark.parametrize("name", ["logistic", "poisson", "linear", "probit"])
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
    """A callable link has no kernel yet: on CUDA tensors the trajectory
    raises instead of falling back to the plain version."""
    _require_card()
    z, p, args = _problem("studentt", 10)
    with pytest.raises(NotImplementedError, match="callable link"):
        tfl.fused_trajectory(z, p, *args)
