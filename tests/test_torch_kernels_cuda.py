"""The port's CUDA kernels against their plain PyTorch versions, on the card,
and the port's NUTS, ChEES, GHMC, MCLMC, MAMS, RWMH, MALA, RM-HMC, DE, PT,
AEES, SMC, the stretch ensemble, DE-MC(Z), slice, elliptical slice, Barker,
mMALA, SGLD, pSGLD, SGHMC, block Gibbs and ``entry()`` (plain PyTorch) run
on it, and the workflow: ``fit`` (NUTS, and ChEES from a Laplace start),
``pathfinder`` and ``psis_loo`` against the CPU; a checkpointed ``hmc`` run,
the checkpoint runner's pinned double-buffered copy, and the evidence
estimators against the CPU.

Past 1,024 padded columns the GLM kernel runs its two-pass body and the
Gaussian kernel its 3xTF32 tensor-core body (``test_xwide_*``: every link,
the traced cloglog link, K3, the workspace's error, at 1,152 to 8,192
columns; K2's grid in one wave, and past it).

The GLM kernel also runs links traced from torch (``ops/link_codegen.py``):
a complementary log-log Bernoulli link and the JAX package's logistic hook
against their plain versions at every padded width and chain counts 1 to
16,384, K3 on them, five launches' bits, the hook within the same bounds of
the built-in logistic, and a link outside the tracer's table refused before
any launch; the built-in logistic keeps the bits it had before the bodies
were templated on their link (digests of that build).

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
at 32 leapfrogs (measured about 1e-5 of scale at 157). Past 1,024 padded
columns the Gaussian kernel's products are 3xTF32 on the tensor cores (each
f32 operand split into a TF32 high and low part, as the TPU kernel's f32
product is a 3-pass bf16 decomposition, mcmc_tpu/ops/fused_logreg.py:344-
350), so a diagonal precision no longer gives the plain version's bits:
there both are held to the plain version in float64, the kernel's largest
per-chain scaled error within 4 times the f32 plain version's.
"""

import hashlib

import numpy as np
import pytest
import torch

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


def _cloglog(eta, y):
    """A complementary log-log Bernoulli link, P(y = 1) = 1 - exp(-e^eta),
    written in torch: the kernel traces it."""
    m = torch.exp(eta)
    p = -torch.expm1(-m)
    score = y * m * torch.exp(-m) / p - (1 - y) * m
    return y - score, y * torch.log(p) - (1 - y) * m


def _logistic_hook(eta, yv):
    """The JAX package's logistic hook (tests/test_fused_logreg.py
    ``test_fused_trajectory_custom_link_hook``) in torch."""
    return torch.sigmoid(eta), yv * eta - torch.nn.functional.softplus(eta)


TRACED = {"cloglog": _cloglog, "logistic_hook": _logistic_hook}


def _traced_problem(name, dim, n, chains, seed=5):
    """A model of ``dim`` columns and ``n`` rows with responses of the link's
    family, its trajectory built on the card (tracing the link and building
    its library), and a start ``(z, p)``."""
    rng = np.random.default_rng(seed + dim)
    X = rng.standard_normal((n, dim)) / np.sqrt(dim)
    eta = X @ rng.standard_normal(dim)
    prob = -np.expm1(-np.exp(eta)) if name == "cloglog" \
        else 1.0 / (1.0 + np.exp(-eta))
    y = (rng.uniform(size=n) < prob).astype(np.float32)
    link = TRACED[name]
    traj = tfl.make_fused_trajectory(
        torch.tensor(X, dtype=torch.float32), torch.tensor(y), 10.0, 0.01, 4,
        block_chains=1, link=link, device="cuda")
    dp = traj.dim_padded
    z = torch.zeros((chains, dp), device="cuda")
    p = torch.zeros((chains, dp), device="cuda")
    z[:, :dim] = torch.tensor(0.5 * rng.standard_normal((chains, dim)),
                              dtype=torch.float32)
    p[:, :dim] = torch.tensor(rng.standard_normal((chains, dim)),
                              dtype=torch.float32)
    return z, p, (traj.Xb, traj.y, traj.mask, traj.inv_pv, 0.01, 4, link)


@pytest.mark.cuda
def test_callable_link_raises_on_card():
    """A callable link outside the tracer's table (here a reduction over the
    rows): on the card the factory raises ``NotImplementedError`` naming
    the op before any launch, and so does the kernel path; nothing falls
    back to the plain version."""
    _require_card()
    z, p, args = _problem("linear", 10)
    link = lambda eta, yv: (eta - eta.mean(dim=-1, keepdim=True),  # noqa: E731
                            -0.5 * (yv - eta) ** 2)
    before = tfl.fused_trajectory_cuda.launches
    with pytest.raises(NotImplementedError, match="aten.mean"):
        tfl.make_fused_trajectory(torch.zeros((64, 10), device="cuda"),
                                  torch.zeros(64, device="cuda"), 10.0, 0.01,
                                  4, link=link)
    with pytest.raises(NotImplementedError, match="aten.mean"):
        tfl.fused_trajectory(z, p, *args[:-1], link)
    assert tfl.fused_trajectory_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("chains", [1, 65, 16384])
@pytest.mark.parametrize("dim,n", [(100, 1000), (200, 1000), (300, 1000),
                                   (784, 2000), (1000, 200)])
@pytest.mark.parametrize("name", list(TRACED))
def test_traced_link_matches_plain(name, dim, n, chains):
    """K1 on a link traced from torch against its plain version (the same
    callable run by torch) at 128, 256, 384, 896 and 1,024 padded columns
    and chain counts 1, 65 and 16,384 (``_close_but_rare``'s tolerances),
    padded columns zero, one launch counted."""
    _require_card()
    z, p, args = _traced_problem(name, dim, n, chains)
    before = tfl.fused_trajectory_cuda.launches
    got = tfl.fused_trajectory_cuda(z, p, *args)
    want = tfl._fused_trajectory_plain(z, p, *args)
    torch.cuda.synchronize()
    assert tfl.fused_trajectory_cuda.launches == before + 1
    _close_but_rare(got, want, chains)
    assert torch.all(got[0][:, dim:] == 0) and torch.all(got[1][:, dim:] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TRACED))
def test_traced_link_rt_at_384(name):
    """K3 on a traced link at 384 padded columns: against its plain version
    with a diagonal inverse mass, at inverse mass 1 K1's bits, and through
    its factory (which traces and builds on the card)."""
    _require_card()
    z, p, args = _traced_problem(name, 300, 1000, 2048)
    Xb, y, mask, inv_pv, _eps, n_leap, link = args
    eps = torch.tensor(0.01, device="cuda")
    im = _inv_mass(384, 300)
    got = tfl.fused_trajectory_rt_cuda(z, p, Xb, y, mask, inv_pv, eps, n_leap,
                                       link, im)
    want = tfl._fused_trajectory_plain(z, p, Xb, y, mask, inv_pv, eps,
                                       n_leap, link, im)
    one = tfl.fused_trajectory_rt_cuda(z, p, Xb, y, mask, inv_pv, eps, n_leap,
                                       link, torch.ones_like(im))
    k1 = tfl.fused_trajectory_cuda(z, p, *args)
    torch.cuda.synchronize()
    _close_but_rare(got, want, 2048)
    assert all(torch.equal(a, b) for a, b in zip(one, k1))
    rng = np.random.default_rng(305)
    X = rng.standard_normal((1000, 300)) / np.sqrt(300)
    traj = tfl.make_fused_trajectory_rt(
        X, (rng.uniform(size=1000) < 0.5).astype(np.float32), 10.0, 4,
        link=link)
    zn, pn, un = traj(z, p, eps, im)
    assert zn.is_cuda and bool(torch.isfinite(un).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [100, 300])
def test_traced_link_is_deterministic(dim):
    """Five launches of K1 on the traced cloglog link give the same bits
    (fixed reduction order), at 128 and 384 padded columns."""
    _require_card()
    z, p, args = _traced_problem("cloglog", dim, 1000, 4096)
    first = tfl.fused_trajectory_cuda(z, p, *args)
    for _ in range(4):
        again = tfl.fused_trajectory_cuda(z, p, *args)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_traced_hook_near_builtin_logistic():
    """The traced logistic hook against the built-in logistic link (whose
    exponential and quotient are the fast intrinsics, the hook's the
    accurate ones) within ``_close_but_rare``'s bounds, at 128 and 384."""
    _require_card()
    for dim in (100, 300):
        z, p, args = _traced_problem("logistic_hook", dim, 1000, 16384)
        hook = tfl.fused_trajectory_cuda(z, p, *args)
        builtin = tfl.fused_trajectory_cuda(z, p, *args[:-1], "logistic")
        torch.cuda.synchronize()
        _close_but_rare(hook, builtin, 16384)


# inputs whose built-in logistic K1 outputs are held to the digests of the
# package's build before its bodies were templated on the link
# (scripts/torch_kernels_parent_check.py printed them from that build, on an
# NVIDIA H100 80GB HBM3 at 700 W with CUDA 12.8; a toolkit that compiles
# the kernel otherwise may change them)
DIGEST_DIMS = (100, 300)
DIGESTS = {100: "abdd8aae87979500a3a999b0e4c7b86d",
           300: "1d7eab972b6c58909f231ca7bad87f51"}


def _digest_problem(dim):
    return _problem("logistic", dim, chains=1000)


def _digest(outs):
    h = hashlib.sha256()
    for t in outs:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:32]


@pytest.mark.cuda
@pytest.mark.parametrize("dim", DIGEST_DIMS)
def test_builtin_logistic_bits_unchanged(dim):
    """The built-in logistic link gives the bits it gave before the GLM
    bodies were templated on their link (at 128 and 384 padded columns)."""
    _require_card()
    z, p, args = _digest_problem(dim)
    assert _digest(tfl.fused_trajectory_cuda(z, p, *args)) == DIGESTS[dim]


def _close_but_rare(got, want, chains):
    """A GLM kernel's ``(z, p, U)`` against its plain version's: strict up
    to 65 chains; past it all elements of z and p to 1e-3 and all but one
    in 100,000 to 1e-4, U to rtol 1e-3 and all but one chain in 1,000 to
    1e-4 (a rare element lands on the other bf16 neighbour of z or r)."""
    (zk, pk, uk), (zp, pp, up) = got, want
    for a, b in ((zk, zp), (pk, pp)):
        if chains <= 65:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
        else:
            diff = (a - b).abs()
            assert float(diff.max()) <= 1e-3
            assert float((diff > 1e-4).float().mean()) <= 1e-5
    if chains <= 65:
        torch.testing.assert_close(uk, up, rtol=1e-4, atol=0)
    else:
        rel = (uk - up).abs() / up.abs()
        assert float(rel.max()) <= 1e-3, float(rel.max())
        assert float((rel > 1e-4).float().mean()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("chains", [1, 63, 65, 16385])
@pytest.mark.parametrize("dim,n", [(25, 1000), (100, 130), (200, 1000)])
def test_kernel_tilings(dim, n, chains):
    """What the tilings make risky, for the fixed-step and the run-time
    entry alike: a chain count of one, one under and one over a warpgroup's
    64, and one over the flagship's 16384 (a last block with one chain and
    an empty second warpgroup); 25 of 128 columns; a row count (130) that
    is no multiple of the 64-row tile; the 256-column body. At 16385
    chains a rare element (measured: one of 4.2 million) lands on the other
    bf16 neighbour of z or r and differs by up to 3e-4 (and that chain's
    U with it), so there all elements agree to 1e-3 and all but one in
    100,000 to 1e-4, and U to rtol 1e-3, all but one chain in 1,000 to
    1e-4."""
    _require_card()
    z, p, args = _problem("logistic", dim, n=n, chains=chains)
    Xb, y, mask, inv_pv, eps, n_leap, link = args
    assert Xb.shape[0] == -(-n // 64) * 64
    got = tfl.fused_trajectory_cuda(z, p, *args)
    want = tfl._fused_trajectory_plain(z, p, *args)
    im = _inv_mass(z.shape[1], dim)
    eps_t = torch.tensor(0.013, device="cuda")
    got_rt = tfl.fused_trajectory_rt_cuda(z, p, Xb, y, mask, inv_pv, eps_t,
                                          n_leap, link, im)
    want_rt = tfl._fused_trajectory_plain(z, p, Xb, y, mask, inv_pv, eps_t,
                                          n_leap, link, im)
    torch.cuda.synchronize()
    for g, w in ((got, want), (got_rt, want_rt)):
        _close_but_rare(g, w, chains)
        assert torch.all(g[0][:, dim:] == 0) and torch.all(g[1][:, dim:] == 0)


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


def _float64_errors(args, got, want):
    """The largest per-chain error of the kernel's ``got`` and the f32
    plain version's ``want`` against the plain version in float64 on the
    same inputs, each output's relative to its scale (chip_smoke.py phase
    7's measure)."""
    z, p, P, mean, eps, n_leap, dim = args
    exact = tfl._fused_gaussian_trajectory_plain(
        z.double(), p.double(), P.double(), mean.double(), float(eps),
        n_leap, dim)

    def worst(out):
        zk, pk, uk = (t.double() for t in out)
        ze, pe, ue = exact
        return float(torch.stack([
            (zk - ze).abs().amax(dim=1) / ze.abs().max().clamp_min(1),
            (pk - pe).abs().amax(dim=1) / pe.abs().max().clamp_min(1),
            (uk - ue).abs() / ue.abs().max()]).max())

    return worst(got), worst(want)


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
    return traj, (z, p, traj.P, traj.mean, eps, n_leap, dim)


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
@pytest.mark.parametrize("chains", [1, 7, 9])
@pytest.mark.parametrize("dim", [25, 32, 33, 64, 65, 100, 104, 105, 128])
def test_gaussian_kernel_live_widths(dim, chains):
    """Every live width the kernel is built for (32, 64, 104, 128) at and
    beside its edges, with a dense P and a mean; chain counts of one, one
    under and one over the 8-chain tile; the columns past the model's
    dimension come out exactly zero."""
    _require_card()
    _traj, args = _gaussian_problem("dense", dim, chains)
    zp, pp, up = tfl._fused_gaussian_trajectory_plain(*args)
    zk, pk, uk = tfl.fused_gaussian_trajectory_cuda(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(zk, zp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(pk, pp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(uk, up, rtol=1e-4, atol=1e-4)
    assert torch.all(zk[:, dim:] == 0) and torch.all(pk[:, dim:] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [25, 60, 100])
def test_gaussian_kernel_and_plain_agree_past_the_live_width(dim):
    """With the padding contract broken (state, mean and P non-zero past the
    live width) kernel and plain version still compute one function: the
    live block as from clean padding, the other columns as they went in."""
    _require_card()
    _traj, args = _gaussian_problem("dense", dim, 9)
    clean = tfl.fused_gaussian_trajectory_cuda(*args)
    live = tfl._live_width(dim, 128)
    z, p, P, mean = (t.clone() for t in args[:4])
    gen = torch.Generator(device="cuda").manual_seed(3)
    for t in (z, p):
        t[:, live:] = torch.randn(t[:, live:].shape, device="cuda",
                                  generator=gen)
    mean[live:] = 2.0
    P[live:, :] = 0.5
    P[:, live:] = 0.5
    zk, pk, uk = tfl.fused_gaussian_trajectory_cuda(z, p, P, mean, *args[4:])
    zp, pp, up = tfl._fused_gaussian_trajectory_plain(z, p, P, mean,
                                                      *args[4:])
    torch.cuda.synchronize()
    assert torch.equal(zk[:, :live], clean[0][:, :live])
    assert torch.equal(pk[:, :live], clean[1][:, :live])
    assert torch.equal(uk, clean[2])
    for got in (zk, zp):
        assert torch.equal(got[:, live:], z[:, live:])
    for got in (pk, pp):
        assert torch.equal(got[:, live:], p[:, live:])
    torch.testing.assert_close(zk, zp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(pk, pp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(uk, up, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_gaussian_kernel_refuses_a_wrong_dim():
    """The wrapper raises on a dimension outside 1..dim_padded before any
    launch."""
    _require_card()
    _traj, args = _gaussian_problem("diagonal", 100, 8)
    for dim in (0, 129):
        with pytest.raises(ValueError, match="dim must be"):
            tfl.fused_gaussian_trajectory_cuda(*args[:6], dim)


@pytest.mark.cuda
def test_gaussian_kernel_is_deterministic_and_reads_eps_on_the_card():
    """Two launches give the same bits; the step is read from device
    memory at run time, as a float or a tensor; the trajectory built by
    ``make_fused_gaussian_trajectory`` launches the kernel."""
    _require_card()
    traj, args = _gaussian_problem("dense", 100, 1000)
    a = tfl.fused_gaussian_trajectory_cuda(*args)
    b = tfl.fused_gaussian_trajectory_cuda(*args)
    c = tfl.fused_gaussian_trajectory_cuda(*args[:4], 0.9, *args[5:])
    before = tfl.fused_gaussian_trajectory_cuda.launches
    d = traj(args[0], args[1])
    assert tfl.fused_gaussian_trajectory_cuda.launches == before + 1
    for u, v, w, x in zip(a, b, c, d):
        assert torch.equal(u, v) and torch.equal(u, w) and torch.equal(u, x)
    e = tfl.fused_gaussian_trajectory_cuda(*args[:4], args[4] * 0.5,
                                           *args[5:])
    assert not torch.equal(a[0], e[0])


@pytest.mark.cuda
def test_widths_not_instantiated_raise():
    """Past 1,024 padded columns the kernels launch: a 1,100-column model
    (1,152 padded) runs both trajectories through their factories, one
    launch each, with finite outputs and the padded columns zero; a width
    that is no multiple of 128 is still refused, naming the rule."""
    _require_card()
    traj = tfl.make_fused_gaussian_trajectory(np.ones(1100), block_chains=1,
                                              device="cuda")
    assert traj.dim_padded == 1152
    z = torch.zeros((8, traj.dim_padded), device="cuda")
    z[:, :1100] = 1.0
    before = tfl.fused_gaussian_trajectory_cuda.launches
    out = traj(z, z.clone())
    torch.cuda.synchronize()
    assert tfl.fused_gaussian_trajectory_cuda.launches == before + 1
    assert all(bool(torch.isfinite(t).all()) for t in out)
    assert torch.all(out[0][:, 1100:] == 0)
    with pytest.raises(ValueError, match="dim_padded a multiple of 128"):
        tfl.fused_gaussian_trajectory_cuda(z[:, :1100], z[:, :1100],
                                           traj.P[:1100, :1100],
                                           traj.mean[:1100], 0.1, 1, 1100)
    rng = np.random.default_rng(0)
    glm = tfl.make_fused_trajectory(
        torch.tensor(rng.standard_normal((64, 1100)), dtype=torch.float32),
        torch.zeros(64), 10.0, 0.01, 2, block_chains=1, device="cuda")
    z = torch.zeros((8, glm.dim_padded), device="cuda")
    before = tfl.fused_trajectory_cuda.launches
    out = glm(z, z.clone())
    torch.cuda.synchronize()
    assert tfl.fused_trajectory_cuda.launches == before + 1
    assert all(bool(torch.isfinite(t).all()) for t in out)
    assert torch.all(out[0][:, 1100:] == 0)
    with pytest.raises(ValueError, match="dim_padded a multiple of 128"):
        tfl.fused_trajectory_cuda(z[:, :1100], z[:, :1100],
                                  glm.Xb[:, :1100].contiguous(), glm.y,
                                  glm.mask, glm.inv_pv, 0.01, 2, "logistic")


@pytest.mark.cuda
@pytest.mark.parametrize("chains", [1, 65, 300])
@pytest.mark.parametrize("dim,n", [(1100, 1000), (1100, 130), (2000, 1000),
                                   (2100, 333), (8100, 512)])
def test_xwide_kernel_matches_plain(dim, n, chains):
    """The two-pass body past 1,024 padded columns (1,152, 2,048, 2,176 and
    8,192), for the fixed-step and the run-time entry: one chain, a second
    warpgroup with one chain (65), a third cluster ragged (300); clusters
    of 2 to 8 blocks (130, 333 and 512 rows make 2, 3 and 4 row tiles),
    the last tile of 64 rows (130 and 333 rows pad to 192 and 384); padded
    columns exactly zero; one launch per call. The tolerances of
    ``_close_but_rare``."""
    _require_card()
    z, p, args = _problem("logistic", dim, n=n, chains=chains)
    Xb, y, mask, inv_pv, eps, n_leap, link = args
    before = (tfl.fused_trajectory_cuda.launches,
              tfl.fused_trajectory_rt_cuda.launches)
    got = tfl.fused_trajectory_cuda(z, p, *args)
    want = tfl._fused_trajectory_plain(z, p, *args)
    im = _inv_mass(z.shape[1], dim)
    eps_t = torch.tensor(0.013, device="cuda")
    got_rt = tfl.fused_trajectory_rt_cuda(z, p, Xb, y, mask, inv_pv, eps_t,
                                          n_leap, link, im)
    want_rt = tfl._fused_trajectory_plain(z, p, Xb, y, mask, inv_pv, eps_t,
                                          n_leap, link, im)
    torch.cuda.synchronize()
    assert (tfl.fused_trajectory_cuda.launches,
            tfl.fused_trajectory_rt_cuda.launches) == (before[0] + 1,
                                                       before[1] + 1)
    for g, w in ((got, want), (got_rt, want_rt)):
        _close_but_rare(g, w, chains)
        assert torch.all(g[0][:, dim:] == 0) and torch.all(g[1][:, dim:] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["logistic", "poisson", "linear", "probit",
                                  "studentt"])
def test_xwide_kernel_links(name):
    """Every built-in link through the two-pass body at 2,048 padded
    columns (2,000 of them the model's), 100 chains."""
    _require_card()
    z, p, args = _problem(name, 2000)
    got = tfl.fused_trajectory_cuda(z, p, *args)
    want = tfl._fused_trajectory_plain(z, p, *args)
    torch.cuda.synchronize()
    _close_but_rare(got, want, 100)
    assert torch.all(got[0][:, 2000:] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("chains", [1, 65, 2048])
def test_xwide_traced_link_matches_plain(chains):
    """The traced cloglog link on the two-pass body at 2,048 padded columns
    (its own library, built at the factory), K1 and K3 against their plain
    versions, and K3 at inverse mass 1 bit-equal to K1."""
    _require_card()
    z, p, args = _traced_problem("cloglog", 2000, 1000, chains)
    Xb, y, mask, inv_pv, eps, n_leap, link = args
    got = tfl.fused_trajectory_cuda(z, p, *args)
    want = tfl._fused_trajectory_plain(z, p, *args)
    im = _inv_mass(z.shape[1], 2000)
    eps_t = torch.tensor(eps, device="cuda")
    got_rt = tfl.fused_trajectory_rt_cuda(z, p, Xb, y, mask, inv_pv, eps_t,
                                          n_leap, link, im)
    want_rt = tfl._fused_trajectory_plain(z, p, Xb, y, mask, inv_pv, eps_t,
                                          n_leap, link, im)
    one = tfl.fused_trajectory_rt_cuda(z, p, Xb, y, mask, inv_pv, eps_t,
                                       n_leap, link, torch.ones_like(im))
    torch.cuda.synchronize()
    _close_but_rare(got, want, chains)
    _close_but_rare(got_rt, want_rt, chains)
    assert all(torch.equal(a, b) for a, b in zip(one, got))


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [1100, 2000])
def test_xwide_kernel_is_deterministic_and_rt_at_unit_mass_equal(dim):
    """Five launches of the two-pass body give the same bits (its sums run
    over panels, row tiles and the cluster's blocks in a fixed order); the
    run-time entry at inverse mass 1 and the same step gives the
    fixed-step entry's bits. At 1,152 and 2,048 padded columns."""
    _require_card()
    z, p, args = _problem("logistic", dim, chains=1000)
    Xb, y, mask, inv_pv, eps, n_leap, link = args
    a = tfl.fused_trajectory_cuda(z, p, *args)
    ones = torch.ones((z.shape[1],), device="cuda")
    for _ in range(4):
        b = tfl.fused_trajectory_cuda(z, p, *args)
        for u, v in zip(a, b):
            assert torch.equal(u, v)
    c = tfl.fused_trajectory_rt_cuda(z, p, Xb, y, mask, inv_pv,
                                     torch.tensor(eps, device="cuda"), n_leap,
                                     link, ones)
    for u, w in zip(a, c):
        assert torch.equal(u, w)


@pytest.mark.cuda
def test_xwide_workspace_error_names_its_bytes():
    """A workspace the card cannot hold raises torch's out-of-memory error,
    naming the bytes the body needed."""
    _require_card()
    with pytest.raises(torch.OutOfMemoryError, match="1125899906842624 bytes"):
        tfl._workspace("fused trajectory", 1 << 50, torch.device("cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("dim,n", [(1100, 1000), (2000, 1200), (2100, 333),
                                   (1100, 130)])
def test_xwide_blocks_with_fewer_items(dim, n):
    """The two-pass body's operands are multicast to the cluster, so every
    block walks the same items and a block with a smaller share runs its
    last rounds without products: 1,152's 9 panels over 8 blocks (one block
    two panels), 1,200 rows' 10 row tiles over 8 blocks (two blocks two
    tiles), 17 panels over 3 blocks and 9 over 2; 200 chains (no multiple
    of 128). Both entries against their plain versions, padded columns
    zero, a second launch bit-equal."""
    _require_card()
    z, p, args = _problem("logistic", dim, n=n, chains=200)
    Xb, y, mask, inv_pv, eps, n_leap, link = args
    got = tfl.fused_trajectory_cuda(z, p, *args)
    again = tfl.fused_trajectory_cuda(z, p, *args)
    want = tfl._fused_trajectory_plain(z, p, *args)
    im = _inv_mass(z.shape[1], dim)
    eps_t = torch.tensor(0.013, device="cuda")
    got_rt = tfl.fused_trajectory_rt_cuda(z, p, Xb, y, mask, inv_pv, eps_t,
                                          n_leap, link, im)
    want_rt = tfl._fused_trajectory_plain(z, p, Xb, y, mask, inv_pv, eps_t,
                                          n_leap, link, im)
    torch.cuda.synchronize()
    for g, w in ((got, want), (got_rt, want_rt)):
        _close_but_rare(g, w, 200)
        assert torch.all(g[0][:, dim:] == 0) and torch.all(g[1][:, dim:] == 0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_xwide_more_clusters_than_resident():
    """4,096 chains at 2,048 padded columns: 32 clusters of 8 blocks, more
    than the card holds at once (one 200 KB block an SM), so they run in
    waves; against the plain version."""
    _require_card()
    z, p, args = _problem("logistic", 2000, chains=4096)
    got = tfl.fused_trajectory_cuda(z, p, *args)
    want = tfl._fused_trajectory_plain(z, p, *args)
    torch.cuda.synchronize()
    _close_but_rare(got, want, 4096)
    assert torch.all(got[0][:, 2000:] == 0)


@pytest.mark.cuda
def test_xwide_500_launches_keep_their_bits():
    """500 back-to-back launches of the two-pass body (2,048 padded
    columns, 256 chains: two clusters of 8) give the first launch's bits:
    no stage of the ring is refilled before every block released it."""
    _require_card()
    z, p, args = _problem("logistic", 2000, chains=256)
    first = tfl.fused_trajectory_cuda(z, p, *args)
    differ = []
    for i in range(1, 500):
        out = tfl.fused_trajectory_cuda(z, p, *args)
        if not all(torch.equal(a, b) for a, b in zip(first, out)):
            differ.append(i)
    assert not differ, differ[:10]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["logistic", "poisson", "linear", "probit",
                                  "studentt", "cloglog (traced)"])
def test_xwide_every_link_and_rt_at_unit_mass_at_3072(name):
    """The main path's width past 1,024: 3,072 padded columns (the model's
    own) on 2,000 rows, clusters of 8, 300 chains; every built-in link and
    the traced cloglog link against the plain version, and the run-time
    entry at inverse mass 1 bit-equal to the fixed-step entry."""
    _require_card()
    if name == "cloglog (traced)":
        z, p, args = _traced_problem("cloglog", 3072, 2000, 300)
    else:
        z, p, args = _problem(name, 3072, n=2000, chains=300)
    Xb, y, mask, inv_pv, eps, n_leap, link = args
    got = tfl.fused_trajectory_cuda(z, p, *args)
    want = tfl._fused_trajectory_plain(z, p, *args)
    one = tfl.fused_trajectory_rt_cuda(
        z, p, Xb, y, mask, inv_pv, torch.tensor(eps, device="cuda"), n_leap,
        link, torch.ones((z.shape[1],), device="cuda"))
    torch.cuda.synchronize()
    _close_but_rare(got, want, 300)
    assert all(torch.equal(a, b) for a, b in zip(got, one))


_QUOTIENT_TU = """#include "fused_glm_common.cuh"
__global__ void quotients(const unsigned* a, const unsigned* b,
                          unsigned* mine, unsigned* ieee, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float x = __uint_as_float(a[i]), y = __uint_as_float(b[i]);
    mine[i] = __float_as_uint(div_rn(x, y));
    ieee[i] = __float_as_uint(__fdiv_rn(x, y));
  }
}
extern "C" int run(const void* a, const void* b, void* mine, void* ieee,
                   long long n) {
  quotients<<<1056, 256>>>((const unsigned*)a, (const unsigned*)b,
                           (unsigned*)mine, (unsigned*)ieee, n);
  return (int)cudaGetLastError();
}
"""

# f32 bit patterns the quotient must get right: signed zeros, infinities,
# NaNs (quiet, signalling, negative), subnormals, FLT_MIN, FLT_MAX and
# ordinary values
_QUOTIENT_SPECIALS = [
    0x00000000, 0x80000000, 0x7f800000, 0xff800000, 0x7fc00000, 0x7fffffff,
    0xffc00000, 0x7f800001, 0x00000001, 0x80000001, 0x007fffff, 0x00400000,
    0x80400000, 0x00800000, 0x80800000, 0x7f7fffff, 0xff7fffff, 0x3f800000,
    0xbf800000, 0x40400000, 0x3eaaaaab, 0x00000003, 0x4b000001, 0x34000000]


@pytest.mark.cuda
def test_traced_quotient_bit_equal_to_fdiv_rn(tmp_path):
    """``div_rn`` (``csrc/fused_glm_common.cuh``), the quotient a traced
    link's functor calls, against ``__fdiv_rn`` bit for bit, in a tiny
    kernel built with the package's nvcc flags: 2^26 pairs of random f32
    bit patterns (every exponent: overflow, underflow to subnormals and
    zero, NaNs), 2^24 pairs of random values in [0.5, 4) and [-4, -0.5)
    (the ordinary range, near every rounding boundary), 2^24 of such a
    value over random bits, and every pair of the special values."""
    _require_card()
    import ctypes
    import subprocess

    from mcmc_tpu_torch.ops import _cuda

    src = tmp_path / "quotient.cu"
    src.write_text(_QUOTIENT_TU)
    so = tmp_path / "quotient.so"
    r = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I",
                        str(_cuda.CSRC), "-o", str(so), str(src)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    lib = ctypes.CDLL(str(so))
    lib.run.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
    lib.run.restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(11)

    def bits(n):
        return torch.randint(-2 ** 31, 2 ** 31, (n,), generator=gen,
                             dtype=torch.int64, device="cuda").to(torch.int32)

    def ordinary(n):
        v = 0.5 + 3.5 * torch.rand((n,), generator=gen, device="cuda")
        sign = torch.randint(0, 2, (n,), generator=gen, device="cuda")
        return torch.where(sign == 1, -v, v).view(torch.int32)

    sp = torch.tensor(np.array(_QUOTIENT_SPECIALS, np.uint32).view(np.int32),
                      device="cuda")
    a = torch.cat([bits(1 << 26), ordinary(1 << 24), ordinary(1 << 24),
                   sp.repeat_interleave(len(sp))])
    b = torch.cat([bits(1 << 26), ordinary(1 << 24), bits(1 << 24),
                   sp.repeat(len(sp))])
    mine, ieee = torch.empty_like(a), torch.empty_like(a)
    assert lib.run(a.data_ptr(), b.data_ptr(), mine.data_ptr(),
                   ieee.data_ptr(), a.numel()) == 0
    torch.cuda.synchronize()
    bad = (mine != ieee).nonzero().flatten()
    assert bad.numel() == 0, [
        (hex(int(a[i]) & 0xffffffff), hex(int(b[i]) & 0xffffffff),
         hex(int(mine[i]) & 0xffffffff), hex(int(ieee[i]) & 0xffffffff))
        for i in bad[:8].tolist()]


@pytest.mark.cuda
@pytest.mark.parametrize("chains", [1, 65, 100, 129, 300])
@pytest.mark.parametrize("dim,n", [(200, 1000), (300, 130), (300, 50),
                                   (450, 1000), (600, 700), (700, 333),
                                   (784, 2000), (1000, 200)])
def test_wide_kernel_matches_plain(dim, n, chains):
    """The cluster body at every cluster size, 2 to 8 blocks (256, 384,
    512, 640, 768, 896 and 1024 padded columns), for the fixed-step and the
    run-time entry: one chain, a second warpgroup with one chain (65), one
    half empty (100), a second cluster with one chain (129), a third
    cluster ragged (300); row counts that are no multiple of the 128-row
    exchange tile, among them a last tile of 64 rows (130, 333 and 700 pad
    to 192, 384 and 704 rows) and a single one (50 rows pad to 64); padded
    columns exactly zero; one launch per call."""
    _require_card()
    z, p, args = _problem("logistic", dim, n=n, chains=chains)
    Xb, y, mask, inv_pv, eps, n_leap, link = args
    before = (tfl.fused_trajectory_cuda.launches,
              tfl.fused_trajectory_rt_cuda.launches)
    got = tfl.fused_trajectory_cuda(z, p, *args)
    want = tfl._fused_trajectory_plain(z, p, *args)
    im = _inv_mass(z.shape[1], dim)
    eps_t = torch.tensor(0.013, device="cuda")
    got_rt = tfl.fused_trajectory_rt_cuda(z, p, Xb, y, mask, inv_pv, eps_t,
                                          n_leap, link, im)
    want_rt = tfl._fused_trajectory_plain(z, p, Xb, y, mask, inv_pv, eps_t,
                                          n_leap, link, im)
    torch.cuda.synchronize()
    assert (tfl.fused_trajectory_cuda.launches,
            tfl.fused_trajectory_rt_cuda.launches) == (before[0] + 1,
                                                       before[1] + 1)
    for g, w in ((got, want), (got_rt, want_rt)):
        _close_but_rare(g, w, chains)
        assert torch.all(g[0][:, dim:] == 0) and torch.all(g[1][:, dim:] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["logistic", "poisson", "linear", "probit",
                                  "studentt"])
def test_wide_kernel_links(name):
    """Every built-in link through the cluster body at 384 padded columns
    (300 of them the model's), 100 chains."""
    _require_card()
    z, p, args = _problem(name, 300)
    got = tfl.fused_trajectory_cuda(z, p, *args)
    want = tfl._fused_trajectory_plain(z, p, *args)
    torch.cuda.synchronize()
    _close_but_rare(got, want, 100)
    assert torch.all(got[0][:, 300:] == 0) and torch.all(got[1][:, 300:] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [200, 300, 784, 896])
def test_wide_kernel_is_deterministic_and_rt_at_unit_mass_equal(dim):
    """Five launches of the cluster body give the same bits (the cluster's
    sums run in rank order, whatever order its blocks' messages arrive in);
    the run-time entry at inverse mass 1 and the same step gives the
    fixed-step entry's bits. At 256, 384 and 896 padded columns (896 also
    with no padded column)."""
    _require_card()
    z, p, args = _problem("logistic", dim, chains=1000)
    Xb, y, mask, inv_pv, eps, n_leap, link = args
    a = tfl.fused_trajectory_cuda(z, p, *args)
    ones = torch.ones((z.shape[1],), device="cuda")
    for _ in range(4):
        b = tfl.fused_trajectory_cuda(z, p, *args)
        for u, v in zip(a, b):
            assert torch.equal(u, v)
    c = tfl.fused_trajectory_rt_cuda(z, p, Xb, y, mask, inv_pv,
                                     torch.tensor(eps, device="cuda"), n_leap,
                                     link, ones)
    for u, w in zip(a, c):
        assert torch.equal(u, w)


@pytest.mark.cuda
@pytest.mark.parametrize("chains", [1, 17, 2048])
@pytest.mark.parametrize("dim", [129, 250, 500, 784, 1000])
@pytest.mark.parametrize("kind", ["diagonal", "dense"])
def test_wide_gaussian_kernel_matches_plain(kind, dim, chains):
    """The body that streams P at 256, 512, 896 and 1024 padded columns:
    chain counts of one, one over the 16-chain tile and the suite's 2048;
    live widths 144, 256, 512, 784 and 1008 (the columns past them copied);
    padded columns exactly zero; two launches bit-equal; on the diagonal
    precision z and p bit-equal to the plain version. z, p and U to rtol
    1e-4 and 1e-4 of each output's largest magnitude: the positions span
    the variances' 1 to 1e3 (up to about 100), and the two sum products of
    up to 1000 terms in different orders, so an element near 0 of a chain
    far out (measured: 1.3e-4 at 0.04 in one of a million elements, 500
    dims) differs by more than a fixed 1e-4."""
    _require_card()
    _traj, args = _gaussian_problem(kind, dim, chains)
    zp, pp, up = tfl._fused_gaussian_trajectory_plain(*args)
    before = tfl.fused_gaussian_trajectory_cuda.launches
    got = tfl.fused_gaussian_trajectory_cuda(*args)
    again = tfl.fused_gaussian_trajectory_cuda(*args)
    torch.cuda.synchronize()
    assert tfl.fused_gaussian_trajectory_cuda.launches == before + 2
    zk, pk, uk = got
    for a, b in ((zk, zp), (pk, pp), (uk, up)):
        torch.testing.assert_close(
            a, b, rtol=1e-4, atol=1e-4 * max(1.0, float(b.abs().max())))
    assert torch.all(zk[:, dim:] == 0) and torch.all(pk[:, dim:] == 0)
    for u, v in zip(got, again):
        assert torch.equal(u, v)
    if kind == "diagonal":   # one non-zero term per product: exact
        assert torch.equal(zk, zp) and torch.equal(pk, pp)


@pytest.mark.cuda
@pytest.mark.parametrize("chains", [1, 15, 17, 2048])
@pytest.mark.parametrize("dim", [250, 500, 784, 1000])
@pytest.mark.parametrize("kind", ["diagonal", "dense"])
def test_wide_gaussian_kernel_at_block_edges(kind, dim, chains):
    """The wide body takes 16 chains a block: one chain, one below and one
    above a block (15, 17), and the suite's 2,048. The tolerances of
    test_wide_gaussian_kernel_matches_plain; on the diagonal precision z
    and p bit-equal to the plain version."""
    _require_card()
    _traj, args = _gaussian_problem(kind, dim, chains)
    zp, pp, up = tfl._fused_gaussian_trajectory_plain(*args)
    zk, pk, uk = tfl.fused_gaussian_trajectory_cuda(*args)
    torch.cuda.synchronize()
    for a, b in ((zk, zp), (pk, pp), (uk, up)):
        torch.testing.assert_close(
            a, b, rtol=1e-4, atol=1e-4 * max(1.0, float(b.abs().max())))
    assert torch.all(zk[:, dim:] == 0) and torch.all(pk[:, dim:] == 0)
    if kind == "diagonal":
        assert torch.equal(zk, zp) and torch.equal(pk, pp)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [250, 500, 784, 1000])
def test_wide_gaussian_kernel_five_launches_bit_equal(dim):
    """Five launches at 2,048 chains (128 blocks, every warp arriving on
    its block's ring barriers) give the same bits."""
    _require_card()
    _traj, args = _gaussian_problem("dense", dim, 2048)
    first = tfl.fused_gaussian_trajectory_cuda(*args)
    for _ in range(4):
        again = tfl.fused_gaussian_trajectory_cuda(*args)
        torch.cuda.synchronize()
        for u, v in zip(first, again):
            assert torch.equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["diagonal", "dense"])
def test_wide_gaussian_kernel_500_launches_bit_equal(kind):
    """500 back-to-back launches at 256 padded columns, 2,048 chains and
    157 leapfrogs, the wide Gaussian path's shape (it launches the kernel
    1,200 times):
    none fails and every one gives the first one's bits, so the ring's
    barriers neither stall nor let a stage be overwritten early."""
    _require_card()
    _traj, args = _gaussian_problem(kind, 250, 2048, n_leap=157)
    first = tfl.fused_gaussian_trajectory_cuda(*args)
    differ = torch.zeros((), dtype=torch.int64, device="cuda")
    for _ in range(499):
        again = tfl.fused_gaussian_trajectory_cuda(*args)
        differ += sum((u != v).any().long() for u, v in zip(first, again))
    torch.cuda.synchronize()
    assert int(differ) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("chains", [1, 17, 2048])
@pytest.mark.parametrize("dim", [1100, 2000, 4096])
@pytest.mark.parametrize("kind", ["diagonal", "dense"])
def test_xwide_gaussian_kernel_matches_plain(kind, dim, chains):
    """The 3xTF32 body past 1,024 padded columns (1,152, 2,048 and 4,096:
    9, 16 and 32 slices of 128 columns): one chain, one over a 16-chain
    tile and the suite's 2,048 (16 tiles of 128, 8 blocks a tile); live
    widths 1,104, 2,000 and 4,096; the tolerances of
    test_wide_gaussian_kernel_matches_plain; padded columns exactly zero;
    two launches bit-equal; against the plain version in float64, on the
    diagonal and the dense precision, the kernel's largest per-chain scaled
    error at most 4 times the f32 plain version's."""
    _require_card()
    _traj, args = _gaussian_problem(kind, dim, chains)
    zp, pp, up = tfl._fused_gaussian_trajectory_plain(*args)
    before = tfl.fused_gaussian_trajectory_cuda.launches
    got = tfl.fused_gaussian_trajectory_cuda(*args)
    again = tfl.fused_gaussian_trajectory_cuda(*args)
    torch.cuda.synchronize()
    assert tfl.fused_gaussian_trajectory_cuda.launches == before + 2
    zk, pk, uk = got
    for a, b in ((zk, zp), (pk, pp), (uk, up)):
        torch.testing.assert_close(
            a, b, rtol=1e-4, atol=1e-4 * max(1.0, float(b.abs().max())))
    assert torch.all(zk[:, dim:] == 0) and torch.all(pk[:, dim:] == 0)
    for u, v in zip(got, again):
        assert torch.equal(u, v)
    kernel_err, plain_err = _float64_errors(args, got, (zp, pp, up))
    assert kernel_err <= 4 * plain_err, (kernel_err, plain_err)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [1100, 2000, 4096])
def test_xwide_gaussian_grid_is_one_wave(dim):
    """At the suite's 2,048 chains the grid is 16 tiles of 128 chains, each
    split over as many blocks as run at once with the others' (8 of the 9,
    16 and 32 slices), in one wave; one chain gets a block a slice."""
    _require_card()
    g = tfl.gaussian_xwide_grid(2048, dim)
    assert g["tiles"] == 16 and g["waves"] == 1
    assert g["blocks"] == 16 * g["per_tile"] <= g["capacity"]
    assert g["per_tile"] == min(g["capacity"] // 16, -(-dim // 128))
    one = tfl.gaussian_xwide_grid(1, dim)
    assert one["blocks"] == one["per_tile"] == -(-dim // 128)


@pytest.mark.cuda
def test_xwide_gaussian_kernel_past_one_wave():
    """More chain tiles than the card runs blocks at once (one over: 133
    tiles of 128 at 1,100 dimensions): a block a tile takes every slice
    and waits on no other, in two waves; the tolerances and the float64
    check of test_xwide_gaussian_kernel_matches_plain at 4 leapfrogs."""
    _require_card()
    capacity = tfl.gaussian_xwide_grid(1, 1100)["capacity"]
    chains = 128 * capacity + 1
    g = tfl.gaussian_xwide_grid(chains, 1100)
    assert (g["per_tile"], g["blocks"], g["waves"]) == (1, capacity + 1, 2)
    _traj, args = _gaussian_problem("dense", 1100, chains, n_leap=4)
    got = tfl.fused_gaussian_trajectory_cuda(*args)
    want = tfl._fused_gaussian_trajectory_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(
            a, b, rtol=1e-4, atol=1e-4 * max(1.0, float(b.abs().max())))
    kernel_err, plain_err = _float64_errors(args, got, want)
    assert kernel_err <= 4 * plain_err, (kernel_err, plain_err)


@pytest.mark.cuda
def test_xwide_gaussian_kernel_five_launches_bit_equal():
    """Five launches at 2,000 dimensions (2,048 padded) and 2,048 chains
    (16 tiles x 8 blocks, meeting through flags) give the same bits."""
    _require_card()
    _traj, args = _gaussian_problem("dense", 2000, 2048)
    first = tfl.fused_gaussian_trajectory_cuda(*args)
    for _ in range(4):
        again = tfl.fused_gaussian_trajectory_cuda(*args)
        torch.cuda.synchronize()
        for u, v in zip(first, again):
            assert torch.equal(u, v)


@pytest.mark.cuda
def test_xwide_gaussian_kernel_and_plain_agree_past_the_live_width():
    """With the padding contract broken past the live width (1,104 of
    1,152 columns) the cluster body and the plain version still compute
    one function: the live block as from clean padding, the other columns
    as they went in."""
    _require_card()
    dim = 1100
    _traj, args = _gaussian_problem("dense", dim, 9)
    clean = tfl.fused_gaussian_trajectory_cuda(*args)
    live = tfl._live_width(dim, 1152)
    assert live == 1104
    z, p, P, mean = (t.clone() for t in args[:4])
    gen = torch.Generator(device="cuda").manual_seed(3)
    for t in (z, p):
        t[:, live:] = torch.randn(t[:, live:].shape, device="cuda",
                                  generator=gen)
    mean[live:] = 2.0
    P[live:, :] = 0.5
    P[:, live:] = 0.5
    zk, pk, uk = tfl.fused_gaussian_trajectory_cuda(z, p, P, mean, *args[4:])
    zp, pp, up = tfl._fused_gaussian_trajectory_plain(z, p, P, mean,
                                                      *args[4:])
    torch.cuda.synchronize()
    assert torch.equal(zk[:, :live], clean[0][:, :live])
    assert torch.equal(pk[:, :live], clean[1][:, :live])
    assert torch.equal(uk, clean[2])
    for got in (zk, zp):
        assert torch.equal(got[:, live:], z[:, live:])
    for got in (pk, pp):
        assert torch.equal(got[:, live:], p[:, live:])
    torch.testing.assert_close(zk, zp, rtol=1e-4,
                               atol=1e-4 * max(1.0, float(zp.abs().max())))
    torch.testing.assert_close(pk, pp, rtol=1e-4,
                               atol=1e-4 * max(1.0, float(pp.abs().max())))
    torch.testing.assert_close(uk, up, rtol=1e-4,
                               atol=1e-4 * max(1.0, float(up.abs().max())))


@pytest.mark.cuda
def test_wide_gaussian_kernel_and_plain_agree_past_the_live_width():
    """With the padding contract broken past the live width (784 of 896
    columns) kernel and plain version still compute one function: the live
    block as from clean padding, the other columns as they went in."""
    _require_card()
    dim = 784
    _traj, args = _gaussian_problem("dense", dim, 9)
    clean = tfl.fused_gaussian_trajectory_cuda(*args)
    live = tfl._live_width(dim, 896)
    assert live == 784
    z, p, P, mean = (t.clone() for t in args[:4])
    gen = torch.Generator(device="cuda").manual_seed(3)
    for t in (z, p):
        t[:, live:] = torch.randn(t[:, live:].shape, device="cuda",
                                  generator=gen)
    mean[live:] = 2.0
    P[live:, :] = 0.5
    P[:, live:] = 0.5
    zk, pk, uk = tfl.fused_gaussian_trajectory_cuda(z, p, P, mean, *args[4:])
    zp, pp, up = tfl._fused_gaussian_trajectory_plain(z, p, P, mean,
                                                      *args[4:])
    torch.cuda.synchronize()
    assert torch.equal(zk[:, :live], clean[0][:, :live])
    assert torch.equal(pk[:, :live], clean[1][:, :live])
    assert torch.equal(uk, clean[2])
    for got in (zk, zp):
        assert torch.equal(got[:, live:], z[:, live:])
    for got in (pk, pp):
        assert torch.equal(got[:, live:], p[:, live:])
    torch.testing.assert_close(zk, zp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(pk, pp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(uk, up, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_nuts_on_the_card_repeats_under_one_seed():
    """``nuts`` at 64 chains on the flagship target (100 dims, 1000 rows),
    from numpy data and start with no ``device=``: it runs on the card,
    its draws are finite, and two runs with one seed are bit-equal."""
    _require_card()
    from mcmc_tpu_torch import NUTSSettings, nuts
    from mcmc_tpu_torch.convert import glm_data
    from mcmc_tpu_torch.models import (logistic_regression_model,
                                       make_logistic_regression_data)

    X, y, _ = make_logistic_regression_data(0, 1000, 100, device="cpu")
    lk = logistic_regression_model(*glm_data(X.numpy(), y.numpy()))
    s = NUTSSettings(n_burnin_draws=30, n_keep_draws=30, n_adapt_draws=30,
                     target_accept_rate=0.65)
    kw = dict(n_chains=64, key=7, pooled_adaptation=True,
              adapt_mass_matrix=True, adapt_depth=True,
              warmup_tree_depth=4)
    a = nuts(np.zeros(100, np.float32), lk, s, **kw)
    b = nuts(np.zeros(100, np.float32), lk, s, **kw)
    assert a.draws.is_cuda and a.draws.shape == (30, 64, 100)
    assert bool(torch.isfinite(a.draws).all())
    assert torch.equal(a.draws, b.draws)
    for k in ("tree_depth", "accept_stat", "step_size"):
        assert torch.equal(a.diagnostics[k], b.diagnostics[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["chees", "ghmc", "mclmc", "mams", "rwmh",
                                  "mala", "rmhmc", "de"])
def test_sampler_on_the_card_repeats_under_one_seed(name):
    """Each of ``chees``, ``ghmc``, ``mclmc``, ``mams``, ``rwmh`` (DRAM:
    dense pooled covariance, dual averaging, delayed rejection), ``mala``
    (dense pooled preconditioner) and ``de`` (64 walkers) at 64 chains on
    the flagship target (100 dims, 1000 rows), and ``rmhmc`` with the
    SoftAbs metric on a 3-d funnel (16 chains, a few draws), from numpy
    data and start with no ``device=``: it runs on the card, its draws are
    finite, and two runs with one seed are bit-equal, diagnostics
    included."""
    _require_card()
    import mcmc_tpu_torch
    from mcmc_tpu_torch.convert import glm_data
    from mcmc_tpu_torch.models import (logistic_regression_model,
                                       make_logistic_regression_data,
                                       neals_funnel)

    settings = {"chees": "ChEESSettings", "ghmc": "GHMCSettings",
                "mclmc": "MCLMCSettings", "mams": "MAMSSettings",
                "rwmh": "RWMHSettings", "mala": "MALASettings",
                "rmhmc": "RMHMCSettings", "de": "DESettings"}[name]
    fn = getattr(mcmc_tpu_torch, name)
    if name == "rmhmc":
        lk = neals_funnel(3, 3.0)
        s = mcmc_tpu_torch.RMHMCSettings(n_burnin_draws=3, n_keep_draws=3,
                                         step_size=0.5, n_leap_steps=2,
                                         n_fp_steps=2)
        args = (np.zeros(3, np.float32), lk,
                mcmc_tpu_torch.softabs_metric(lk, 1.0), s)
        kw, shape = dict(n_chains=16), (3, 16, 3)
    else:
        X, y, _ = make_logistic_regression_data(0, 1000, 100, device="cpu")
        lk = logistic_regression_model(*glm_data(X.numpy(), y.numpy()))
        extra = {"de": dict(n_pop=64)}.get(name, {})
        s = getattr(mcmc_tpu_torch, settings)(n_burnin_draws=30,
                                              n_keep_draws=30, **extra)
        args = (np.full(100, 0.01, np.float32), lk, s)
        kw = {"chees": dict(adapt_mass_matrix=True), "ghmc": {},
              "mclmc": dict(adapt_mass=True), "mams": dict(adapt_mass=True),
              "rwmh": dict(adapt_scale=True, adapt_precond="dense",
                           pooled_adaptation=True, delayed_rejection=True),
              "mala": dict(adapt_step_size=True, adapt_precond="dense",
                           pooled_adaptation=True),
              "de": {}}[name]
        if name != "de":
            kw["n_chains"] = 64
        shape = (30, 64, 100)
    a = fn(*args, key=7, **kw)
    b = fn(*args, key=7, **kw)
    assert a.draws.is_cuda and a.draws.shape == shape
    assert bool(torch.isfinite(a.draws).all())
    assert torch.equal(a.draws, b.draws)
    for k, v in a.diagnostics.items():
        if torch.is_tensor(v):
            assert torch.equal(v, b.diagnostics[k]), k


@pytest.mark.cuda
def test_softabs_graphed_metric_matches_eager():
    """``softabs_metric``'s fast path replays CUDA graphs of the funnel's
    Hessian and its cube on the card: at two batch sizes and over three
    points each (the graph's input refilled each replay), ``tensor`` and
    ``tensor_and_derivative`` give what ``metric_fn`` and its ``d`` JVPs
    give, within 1e-6 of each one's scale (float32)."""
    _require_card()
    import mcmc_tpu_torch
    from mcmc_tpu_torch.models import neals_funnel

    m = mcmc_tpu_torch.softabs_metric(neals_funnel(3, 3.0), 1.0)
    gen = torch.Generator(device="cuda").manual_seed(3)
    eye = torch.eye(3, device="cuda")
    for c in (5, 256):
        for _ in range(3):
            x = torch.randn(c, 3, device="cuda", generator=gen)
            G, cube = m.tensor_and_derivative(x)
            want = torch.stack([torch.func.jvp(m, (x,), (eye[i].expand_as(
                x),))[1] for i in range(3)], dim=1)
            assert float((cube - want).abs().max()) <= 1e-6 * float(
                want.abs().max())
            for got in (G, m.tensor(x)):
                assert float((got - m(x)).abs().max()) <= 1e-6 * float(
                    G.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pt", "aees", "aees_capped", "smc",
                                  "stretch", "demcz"])
def test_tempering_and_ensemble_on_the_card_repeat_under_one_seed(name):
    """Each of ``pt`` (adapted ladder, HMC inner moves, 64 ladders),
    ``aees`` (16 runs, with the full history and with a 64-entry
    reservoir), ``smc`` (4,096 particles),
    ``stretch`` (256 walkers) and ``demcz`` (16 runs of 6 walkers) on the
    suite's two-mode mixture, from numpy start with no ``device=``: it runs
    on the card, its draws are finite, and two runs with one seed are
    bit-equal, diagnostics included."""
    _require_card()
    import mcmc_tpu_torch
    from mcmc_tpu_torch.models import gaussian_mixture_model

    mu = np.array([[-2.0, -2.0], [2.0, 2.0]], np.float32)
    lk = gaussian_mixture_model(mu, np.array([0.1, 0.1]),
                                np.array([0.5, 0.5]))
    aees_s = mcmc_tpu_torch.AEESSettings(
        n_initial_draws=40, n_burnin_draws=40, n_keep_draws=30, n_rings=5,
        ee_prob_par=0.2, temper_vec=np.array([20.0, 4.0]),
        cov_mat=0.35 * np.eye(2))
    call = {
        "pt": lambda: mcmc_tpu_torch.pt(mu[0], lk, mcmc_tpu_torch.PTSettings(
            n_burnin_draws=30, n_keep_draws=30, n_temps=6, max_temp=60.0,
            adapt_temps=True, step_size=0.12, n_leap_steps=5), n_chains=64,
            key=7),
        "aees": lambda: mcmc_tpu_torch.aees(
            mu[0], lk, aees_s, key=7, n_runs=16),
        "aees_capped": lambda: mcmc_tpu_torch.aees(
            mu[0], lk, aees_s, key=7, n_runs=16, history_capacity=64),
        "smc": lambda: mcmc_tpu_torch.smc(
            np.zeros(2, np.float32), lk, mcmc_tpu_torch.SMCSettings(
                n_particles=4096, init_scale=4.0), key=7),
        "stretch": lambda: mcmc_tpu_torch.stretch(
            np.zeros(2, np.float32), lk, mcmc_tpu_torch.StretchSettings(
                n_walkers=256, n_burnin_draws=30, n_keep_draws=30), key=7),
        "demcz": lambda: mcmc_tpu_torch.demcz(
            np.zeros(2, np.float32), lk, mcmc_tpu_torch.DEMCZSettings(
                n_pop=6, n_burnin_draws=30, n_keep_draws=30), n_runs=16,
            key=7),
    }[name]
    a, b = call(), call()
    shape = {"pt": (30, 64, 2), "aees": (30, 16, 2),
             "aees_capped": (30, 16, 2), "smc": (4096, 2),
             "stretch": (30, 256, 2), "demcz": (30, 96, 2)}[name]
    assert a.draws.is_cuda and a.draws.shape == shape
    assert bool(torch.isfinite(a.draws).all())
    assert torch.equal(a.draws, b.draws)
    assert torch.equal(a.n_accept_draws, b.n_accept_draws)
    for k, v in a.diagnostics.items():
        if torch.is_tensor(v):
            assert torch.equal(v, b.diagnostics[k]), k
        elif k != "resume":
            assert v == b.diagnostics[k], k


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["slice", "slice_adapt", "elliptical",
                                  "barker", "mmala", "sgld", "psgld_shared",
                                  "sghmc_shared", "gibbs", "entry"])
def test_remaining_samplers_on_the_card_repeat_under_one_seed(name):
    """Each of ``slice_sampler`` (and with pooled width adaptation),
    ``elliptical_slice`` (a 32-point GP prior), ``barker`` (pooled step and
    preconditioner adaptation on the flagship target), ``mmala`` (the
    Fisher metric), ``sgld`` (per-chain minibatches), pSGLD and ``sghmc``
    (shared minibatches) on a logistic regression of 4,096 rows, ``gibbs``
    (an exact block drawing from the run's generator and an HMC block), and
    ``entry.entry()``, from numpy inputs with no ``device=``: it runs on
    the card, its draws are finite, and two runs with one seed are
    bit-equal, diagnostics included."""
    _require_card()
    import mcmc_tpu_torch
    from mcmc_tpu_torch.convert import glm_data
    from mcmc_tpu_torch.entry import entry
    from mcmc_tpu_torch.models import (gaussian_mean_scale_model,
                                       logistic_regression_model,
                                       make_logistic_regression_data,
                                       normal_fisher_metric, rbf_kernel)

    dev = torch.device("cuda")
    x2 = 2.0 + 2.0 * np.random.default_rng(0).standard_normal(500)
    lk_ms = gaussian_mean_scale_model(x2)
    rng = np.random.default_rng(1)
    Xs = rng.standard_normal((4096, 8)).astype(np.float32)
    ys = (rng.uniform(size=4096) < 0.5).astype(np.float32)
    lik = lambda th, b: (b[1] * (b[0] @ th[:, :, None])[..., 0]
                         - torch.nn.functional.softplus(
                             (b[0] @ th[:, :, None])[..., 0])).sum(-1)
    prior = lambda th: -0.5 * (th * th).sum(-1) / 100.0
    sgs = dict(batch_size=128, n_burnin_draws=20, n_keep_draws=30)
    s = lambda cls, **kw: getattr(mcmc_tpu_torch, cls)(
        n_burnin_draws=20, n_keep_draws=30, **kw)
    xs = np.linspace(0.0, 4.0, 32)
    yt = torch.tensor(np.sin(2.0 * xs), dtype=torch.float32, device=dev)

    def cond(g, full):
        return full[:, :1] * 0.5 + torch.randn(
            (full.shape[0], 1), generator=g, device=full.device)

    if name == "entry":
        def call():
            fn, (gen, state) = entry()
            return fn(gen, state)
        (pa, aa), (pb, ab) = call(), call()
        assert pa.is_cuda and pa.shape == (1024, 100)
        assert torch.equal(pa, pb) and torch.equal(aa, ab)
        return
    call = {
        "slice": lambda: mcmc_tpu_torch.slice_sampler(
            np.array([2.0, 2.0]), lk_ms, s("SliceSettings"), n_chains=64,
            key=7),
        "slice_adapt": lambda: mcmc_tpu_torch.slice_sampler(
            np.array([2.0, 2.0]), lk_ms, s("SliceSettings"), n_chains=64,
            key=7, adapt_w=True, pooled_adaptation=True),
        "elliptical": lambda: mcmc_tpu_torch.elliptical_slice(
            np.zeros(32), lambda f: -0.5 * ((yt - f) ** 2).sum(-1) / 0.25,
            s("EllipticalSettings"), prior_cov=rbf_kernel(xs, 0.5),
            n_chains=64, key=7),
        "barker": lambda: mcmc_tpu_torch.barker(
            np.full(100, 0.01, np.float32), logistic_regression_model(
                *glm_data(*[a.numpy() for a in make_logistic_regression_data(
                    0, 1000, 100, device="cpu")[:2]])),
            s("BarkerSettings"), n_chains=64, key=7, adapt_step_size=True,
            adapt_precond=True, pooled_adaptation=True),
        "mmala": lambda: mcmc_tpu_torch.mmala(
            np.array([2.0, 2.0]), lk_ms, normal_fisher_metric(500),
            s("MMALASettings"), n_chains=64, key=7, adapt_step_size=True),
        "sgld": lambda: mcmc_tpu_torch.sgld(
            np.zeros(8), prior, lik, (Xs, ys), mcmc_tpu_torch.SGLDSettings(
                step_size=1e-4, **sgs), n_chains=32, key=7),
        "psgld_shared": lambda: mcmc_tpu_torch.sgld(
            np.zeros(8), prior, lik, (Xs, ys), mcmc_tpu_torch.SGLDSettings(
                step_size=1e-4, **sgs), n_chains=32, key=7,
            adapt_precond=True, minibatch="shared"),
        "sghmc_shared": lambda: mcmc_tpu_torch.sghmc(
            np.zeros(8), prior, lik, (Xs, ys), mcmc_tpu_torch.SGHMCSettings(
                **sgs), n_chains=32, key=7, minibatch="shared"),
        "gibbs": lambda: mcmc_tpu_torch.gibbs(
            np.zeros(3), lambda v: -0.5 * (v * v).sum(-1),
            s("GibbsSettings"), blocks=[([0], cond), ([1, 2], "hmc")],
            n_chains=64, key=7),
    }[name]
    a, b = call(), call()
    assert a.draws.is_cuda and a.draws.ndim == 3 and a.draws.shape[0] == 30
    assert bool(torch.isfinite(a.draws).all())
    assert torch.equal(a.draws, b.draws)
    assert torch.equal(a.n_accept_draws, b.n_accept_draws)
    for k, v in a.diagnostics.items():
        if torch.is_tensor(v):
            assert torch.equal(v, b.diagnostics[k]), k


def _flagship_kernel():
    from mcmc_tpu_torch.convert import glm_data
    from mcmc_tpu_torch.models import (logistic_regression_model,
                                       make_logistic_regression_data)
    X, y, _ = make_logistic_regression_data(0, 1000, 100, device="cpu")
    return logistic_regression_model(*glm_data(X.numpy(), y.numpy()))


@pytest.mark.cuda
@pytest.mark.parametrize("algo,init", [("nuts", None), ("chees", "laplace"),
                                       ("stretch", "laplace"),
                                       ("demcz", "pathfinder")])
def test_fit_on_the_card_repeats_under_one_seed(algo, init):
    """``fit`` at 64 chains on the flagship target from a numpy start with
    no ``device=``: on the card, finite, bit-equal under one seed (an
    extension round included). The ensembles take the search's card
    tensors as their center, spread and box."""
    _require_card()
    import mcmc_tpu_torch
    lk = _flagship_kernel()
    kw = dict(algorithm=algo, init=init, n_chains=64, n_warmup=40,
              n_draws=20, key=5, rhat_target=1.0, max_rounds=2)
    a = mcmc_tpu_torch.fit(np.zeros(100, np.float32), lk, **kw)
    b = mcmc_tpu_torch.fit(np.zeros(100, np.float32), lk, **kw)
    assert a.draws.is_cuda and a.draws.shape[0] == 40
    assert a.draws.shape[2] == 100
    assert bool(torch.isfinite(a.draws).all())
    assert torch.equal(a.draws, b.draws)
    assert a.diagnostics["n_rounds"] == 2


@pytest.mark.cuda
def test_pathfinder_on_the_card():
    """``pathfinder`` on the flagship target from numpy: finite draws on
    the card, one host synchronisation per line-search iteration (at least
    one per L-BFGS iteration), bit-equal under one seed."""
    _require_card()
    import mcmc_tpu_torch
    lk = _flagship_kernel()
    a = mcmc_tpu_torch.pathfinder(np.zeros(100, np.float32), lk, n_paths=4,
                                  n_draws=200, max_iters=30, key=3)
    b = mcmc_tpu_torch.pathfinder(np.zeros(100, np.float32), lk, n_paths=4,
                                  n_draws=200, max_iters=30, key=3)
    assert a.draws.is_cuda and a.draws.shape == (200, 100)
    assert bool(torch.isfinite(a.draws).all())
    assert 30 <= a.host_syncs <= 30 * 20
    assert torch.equal(a.draws, b.draws) and a.host_syncs == b.host_syncs


@pytest.mark.cuda
def test_psis_loo_on_the_card_equals_the_cpu():
    """``psis_loo`` of a card tensor equals the CPU's on the same array at
    rtol 1e-5: elpd, p_loo and se; each observation's elpd and Pareto k
    also within 1e-5 and 2e-5 absolute (a term near 0 is a float32
    log-sum of thousands of weights, summed in another order on the card:
    measured 1.9e-6 absolute on terms of about 0.1)."""
    _require_card()
    from mcmc_tpu_torch import psis_loo, waic
    rng = np.random.default_rng(0)
    ll = (-0.5 * (rng.normal(size=(4000, 1)) * 0.3
                  + rng.normal(size=(1, 50))) ** 2).astype(np.float32)
    cpu = psis_loo(torch.tensor(ll))
    card = psis_loo(torch.tensor(ll, device="cuda"))
    for k in ("elpd", "p_eff", "se"):
        torch.testing.assert_close(card[k].cpu(), cpu[k], rtol=1e-5, atol=0)
    torch.testing.assert_close(card["pointwise"].cpu(), cpu["pointwise"],
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(card["pareto_k"].cpu(), cpu["pareto_k"],
                               rtol=1e-5, atol=2e-5)
    torch.testing.assert_close(waic(torch.tensor(ll, device="cuda"))["elpd"]
                               .cpu(), waic(torch.tensor(ll))["elpd"],
                               rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_checkpointed_hmc_on_the_card_equals_in_memory(tmp_path):
    """A checkpointed ``hmc`` run on the card (chunks of 7 kept draws, the
    draws through the pinned double buffer and the native sink) is
    bit-equal to the in-memory run with the same seed, and so is a run
    stopped after two chunks and resumed."""
    _require_card()
    import mcmc_tpu_torch
    from mcmc_tpu_torch import checkpoint
    from mcmc_tpu_torch.samplers.hmc import build_hmc_kernel
    from mcmc_tpu_torch.samplers import common
    from mcmc_tpu_torch.integrators import grad_of
    lk = lambda v: -0.5 * (v * v).sum(-1) - 0.3 * v[:, 0]
    s = mcmc_tpu_torch.HMCSettings(n_burnin_draws=9, n_keep_draws=30,
                                   step_size=0.3, n_leap_steps=3)
    plain = mcmc_tpu_torch.hmc(np.zeros(3), lk, s, n_chains=64, key=4,
                               adapt_step_size=True)
    ck = mcmc_tpu_torch.hmc(np.zeros(3), lk, s, n_chains=64, key=4,
                            adapt_step_size=True, checkpoint_every=7,
                            checkpoint_dir=tmp_path / "ck")
    assert plain.draws.is_cuda and not ck.draws.is_cuda
    assert torch.equal(ck.draws, plain.draws.cpu())
    assert torch.equal(ck.n_accept_draws, plain.n_accept_draws.cpu())
    init, step = build_hmc_kernel(lk, grad_of(lk),
                                  common.make_spd(None, 3, None), 0.3, 3)
    s0 = init(torch.zeros((64, 3), device="cuda"))
    runs = []
    for stop in (None, 2):
        r = checkpoint.ChunkedRunner(step, lambda st: st.position,
                                     tmp_path / f"r{stop}")
        gen = torch.Generator(device="cuda").manual_seed(1)
        if stop:
            r.run(gen, s0, n_draws=30, chunk_size=7, n_burnin=5,
                  max_chunks=stop)
            gen = torch.Generator(device="cuda").manual_seed(1)
        runs.append(np.array(r.run(gen, s0, n_draws=30, chunk_size=7,
                                   n_burnin=5)[1]))
    np.testing.assert_array_equal(runs[0], runs[1])


@pytest.mark.cuda
def test_pinned_double_buffered_copy_equals_plain_copy():
    """The runner's copies of consecutive chunks through two page-locked
    buffers, each waited on by its event only after the next chunk was
    written on the card, equal plain ``.cpu()`` copies."""
    _require_card()
    from mcmc_tpu_torch.checkpoint import _host_copy
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.empty((64, 256, 100), device="cuda")
    bufs = [torch.empty(dev.shape, pin_memory=True) for _ in range(2)]
    want, pending = [], None
    for i in range(6):
        dev.normal_(generator=gen)            # the next chunk overwrites
        want.append(dev.cpu())
        host = _host_copy(dev, bufs[i % 2])
        ev = torch.cuda.Event()
        ev.record()
        if pending is not None:
            pending[1].synchronize()
            assert torch.equal(pending[0], want[i - 1])
        pending = (host, ev)
    pending[1].synchronize()
    assert torch.equal(pending[0], want[-1])
    assert bufs[0].is_pinned() and bufs[1].is_pinned()


@pytest.mark.cuda
def test_estimate_from_ll_on_the_card_equals_the_cpu():
    """Stepping-stone, corrected TI and the per-rung curves of one
    log-likelihood trace, with -inf entries on the prior rung, on the card
    and on the CPU at rtol 1e-6."""
    _require_card()
    from mcmc_tpu_torch.evidence import estimate_from_ll, power_schedule
    rng = np.random.default_rng(2)
    betas = power_schedule(24, 5.0)
    ll = (-800.0 + 700.0 * betas.numpy() + rng.standard_normal((500, 16, 24))
          * (30.0 - 20.0 * betas.numpy())).astype(np.float32)
    ll[rng.random((500, 16)) < 0.2, 0] = -np.inf
    cpu = estimate_from_ll(torch.from_numpy(ll), betas)
    card = estimate_from_ll(torch.from_numpy(ll).cuda(), betas.cuda())
    for a, b in zip(card, cpu):
        assert a.is_cuda
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-6)
