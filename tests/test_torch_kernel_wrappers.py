"""What the kernels' wrappers and their build take and refuse, on the CPU.

The CUDA kernels run only on a card (``tests/test_torch_kernels_cuda.py``);
here are the parts around them that plain Python reaches: the Gaussian
trajectory's ``dim`` argument (the plain version honours it by the kernel's
rule: the live block evolves, the other columns pass through), the alignment
test of the operands, the live widths the Gaussian kernel is built for, the
build's hash, which covers the headers too, and the package data, which
ships every file the build reads.
"""

import tomllib
from fnmatch import fnmatch
from pathlib import Path

import numpy as np
import pytest
import torch

from mcmc_tpu_torch.ops import _cuda
from mcmc_tpu_torch.ops import fused_logreg as tfl


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for every test here: the tests run in several
    worker processes at once, and torch's default of a thread per core
    oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gaussian_args(dim, dp=128, chains=6, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((dim, dim))
    P = np.eye(dp)
    P[:dim, :dim] = A @ A.T / dim + np.eye(dim)
    z = np.zeros((chains, dp))
    p = np.zeros((chains, dp))
    z[:, :dim] = rng.standard_normal((chains, dim))
    p[:, :dim] = rng.standard_normal((chains, dim))
    mean = np.zeros(dp)
    mean[:dim] = rng.standard_normal(dim)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    return f32(z), f32(p), f32(P), f32(mean)


@pytest.mark.parametrize("dim", [1, 25, 100, 104, 128])
def test_plain_gaussian_trajectory_honours_dim(dim):
    """With the padding contract kept (P the identity, z, p, mean zero past
    dim) the plain version with ``dim`` agrees with the product over all
    columns to rounding (1e-5: only the products' width differs), and the
    padded columns come out exactly zero, as the kernel's copy gives."""
    z, p, P, mean = _gaussian_args(dim)
    want = tfl._fused_gaussian_trajectory_plain(z, p, P, mean, 0.3, 5)
    got = tfl._fused_gaussian_trajectory_plain(z, p, P, mean, 0.3, 5, dim)
    via = tfl.fused_gaussian_trajectory(z, p, P, mean, 0.3, 5, dim)
    for a, b, c in zip(want, got, via):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)
        assert torch.equal(b, c)
    assert torch.all(got[0][:, dim:] == 0) and torch.all(got[1][:, dim:] == 0)


@pytest.mark.parametrize("dim", [1, 25, 60, 100])
def test_plain_gaussian_trajectory_past_the_live_width(dim):
    """With the contract broken (state, mean and P non-zero past the live
    width) the plain version computes what the kernel computes: the live
    block as from clean padding, bit for bit, and the other columns as they
    went in."""
    z, p, P, mean = _gaussian_args(dim)
    clean = tfl._fused_gaussian_trajectory_plain(z, p, P, mean, 0.3, 5, dim)
    live = tfl._live_width(dim, 128)
    z[:, live:], p[:, live:], mean[live:] = 1.5, -2.5, 2.0
    P[live:, :] = 0.5
    P[:, live:] = 0.5
    zn, pn, u = tfl._fused_gaussian_trajectory_plain(z, p, P, mean, 0.3, 5,
                                                     dim)
    assert torch.equal(zn[:, :live], clean[0][:, :live])
    assert torch.equal(pn[:, :live], clean[1][:, :live])
    assert torch.equal(u, clean[2])
    assert torch.all(zn[:, live:] == 1.5) and torch.all(pn[:, live:] == -2.5)


@pytest.mark.parametrize("dim, dp, want", [
    (None, 128, 128), (1, 128, 32), (32, 128, 32), (33, 128, 64),
    (100, 128, 104), (105, 128, 128), (200, 256, 208), (4, 8, 8),
    (None, 512, 512), (129, 256, 144), (250, 256, 256), (784, 896, 784),
    (1000, 1024, 1008)])
def test_live_width(dim, dp, want):
    """At 128 padded columns the smallest instantiated live width; past
    128, the dimension rounded up to a multiple of 16 (the wide kernel's
    rule)."""
    assert tfl._live_width(dim, dp) == want


@pytest.mark.parametrize("dim", [0, -1, 129, 2.5, "8"])
def test_gaussian_trajectory_refuses_a_wrong_dim(dim):
    z, p, P, mean = _gaussian_args(8)
    with pytest.raises((ValueError, TypeError)):
        tfl.fused_gaussian_trajectory(z, p, P, mean, 0.3, 2, dim)


def test_factory_hands_its_dimension_to_the_trajectory(monkeypatch):
    """``make_fused_gaussian_trajectory`` passes the model's dimension, by
    which the kernel picks its live width."""
    seen = {}

    def spy(z, p, P, mean, eps, n_leap, dim=None):
        seen["dim"] = dim
        return tfl._fused_gaussian_trajectory_plain(z, p, P, mean, eps,
                                                    n_leap, dim)

    monkeypatch.setattr(tfl, "fused_gaussian_trajectory", spy)
    traj = tfl.make_fused_gaussian_trajectory(np.ones(100), block_chains=1,
                                              device="cpu")
    z = torch.zeros((2, traj.dim_padded))
    traj(z, z.clone())
    assert seen["dim"] == 100 and traj.dim_padded == 128


def test_cuda_wrappers_refuse_cpu_tensors():
    """The launching wrappers take CUDA tensors only: no way from them to
    the plain version."""
    z, p, P, mean = _gaussian_args(8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfl.fused_gaussian_trajectory_cuda(z, p, P, mean, 0.3, 2, 8)


def test_operands_must_start_on_16_bytes():
    base = torch.zeros(64)
    assert not tfl._misaligned(base)
    assert tfl._misaligned(base[1:])          # 4 bytes in
    assert not tfl._misaligned(base[4:])
    assert not tfl._misaligned(torch.tensor(0.5))   # a 0-d step size


def test_gaussian_live_widths():
    """Multiples of 8 up to the padded width, the suite's 100 dimensions
    served by 104, every dimension by some width; the kernels take every
    multiple of 128 padded columns, however large (past
    ``CLUSTER_MAX_DIM_PADDED``, 1,024, on their bodies for wider models),
    and no other width."""
    widths = _cuda.GAUSSIAN_LIVE_WIDTHS
    assert list(widths) == sorted(widths) and widths[-1] == 128
    assert all(w % 8 == 0 for w in widths)
    assert min(w for w in widths if w >= 100) == 104
    assert _cuda.CLUSTER_MAX_DIM_PADDED == 1024
    assert [dp for dp in range(1, 8193) if _cuda.takes_dim_padded(dp)] == \
        list(range(128, 8193, 128))
    assert _cuda.takes_dim_padded(128 * 10 ** 6)


def test_build_hash_covers_headers(tmp_path, monkeypatch):
    """An edited header gives the library another name, as an edited source
    does, so a stale build is never loaded."""
    (tmp_path / "a.cu").write_text("// a\n#include \"b.cuh\"\n")
    (tmp_path / "b.cuh").write_text("// b\n")
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    first = _cuda.library_path()
    assert first == _cuda.library_path()
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    second = _cuda.library_path()
    (tmp_path / "a.cu").write_text("// a, edited\n#include \"b.cuh\"\n")
    assert len({first, second, _cuda.library_path()}) == 3


def test_the_package_ships_every_file_the_build_reads():
    """Each source and header is matched by a package-data pattern of
    ``pyproject.toml``, so a wheel builds what the tree builds."""
    names = {f.name for f in _cuda.headers()}
    assert names == {"fused_glm_common.cuh", "hopper_ptx.cuh",
                     "fused_glm_body.cuh", "fused_glm_wide_body.cuh",
                     "fused_glm_xwide_body.cuh"}
    assert {f.name for f in _cuda.sources()} == {
        "fused_glm_trajectory.cu", "fused_glm_trajectory_wide.cu",
        "fused_glm_trajectory_xwide.cu", "fused_gaussian_trajectory.cu",
        "fused_gaussian_trajectory_wide.cu",
        "fused_gaussian_trajectory_xwide.cu"}
    root = Path(_cuda.__file__).resolve().parents[2]
    with open(root / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    patterns = data["mcmc_tpu_torch"]
    pkg = root / "mcmc_tpu_torch"
    for f in _cuda.sources() + _cuda.headers():
        rel = f.relative_to(pkg).as_posix()
        assert any(fnmatch(rel, pat) for pat in patterns), rel
