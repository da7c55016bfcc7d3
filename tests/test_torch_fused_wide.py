"""The fused trajectories past 128 padded columns against the JAX package's.

The CUDA kernels take every multiple of 128 padded columns, as the JAX
package pads: the GLM trajectory (K1, and K3, its run-time-parameter entry)
through a cluster body of one block per 128-column panel up to 1,024 and a
two-pass cluster body past it, the Gaussian trajectory (K2) by streaming P
from L2, past 1,024 with its products 3xTF32 on the tensor cores. On the CPU the
port runs their plain PyTorch versions, which these tests hold against the
JAX package's Pallas kernels in interpret mode, as
tests/test_torch_fused_logreg.py and tests/test_torch_fused_gaussian.py do
at 128 columns: K1 at 256, 384, 896, 1,152 and 2,176 padded columns (200,
300, 784, 1,100 and 2,100 of them the model's; 784 is an MNIST image's
pixel count; 2,176 is 17 panels, more than a 16-block cluster could give
one each) and every link at 384, K3 at 384 and 1,152, K2 at 256, 512, 1,152
and 2,176 on a diagonal and a dense precision, and one fused HMC transition
at 384 and at 1,152 fed JAX's momenta and uniforms; two callable links,
written once in ``jnp`` and once in torch (a complementary log-log
Bernoulli and the JAX package's logistic hook), K1 at 384 on each, K3 at
384 on the first, and K1 at 1,152 on the first; ``convert``'s carriers at
1,152; and the arithmetic of K2's products past 1,024 padded columns, 3xTF32
on the tensor cores, emulated (the TF32 split through an int32 view, each
product three float32 products) at 384 against Pallas and float64. The
kernels themselves (a callable link traced into them) are
held against these plain versions on the card in
tests/test_torch_kernels_cuda.py.

Inputs are small (8 chains, 64 data rows, 2-3 leapfrogs) and made with
numpy from a seed; each JAX run is built once per module. Tolerances are
those of the 128-column files: the GLM trajectory's z and p to atol 1e-5 and
U to rtol 1e-5 (both sides round z and r to bf16 at the same points and
accumulate in f32); the Gaussian trajectory's z, p and U to rtol 2e-4,
atol 2e-4 (f32, only the summation order differs). The fused step's stored
potential is the f32 one at the end position (a Deviation: the JAX step
stores the trajectory's bf16-path U), so it is held to JAX's bf16-path U at
the reference's rtol 2e-2 (tests/test_fused_logreg.py:46-49) and to JAX's
f32 ``reference_potential`` at rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mcmc_tpu.ops import fused_logreg as jfl
from mcmc_tpu_torch import convert
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


N, L, EPS, N_CHAINS = 64, 2, 0.05, 8
LINKS = ["logistic", "poisson", "linear", "probit", "studentt"]


def _cloglog(exp, expm1, log):
    """The complementary log-log Bernoulli link, P(y = 1) = 1 - exp(-e^eta),
    in the array library of ``exp``, ``expm1`` and ``log``."""
    def link(eta, y):
        m = exp(eta)
        p = -expm1(-m)
        score = y * m * exp(-m) / p - (1 - y) * m
        return y - score, y * log(p) - (1 - y) * m
    return link


# the callable links: (the JAX package's, the port's)
CALLABLE = {
    "cloglog": (_cloglog(jnp.exp, jnp.expm1, jnp.log),
                _cloglog(torch.exp, torch.expm1, torch.log)),
    "logistic_hook": (
        lambda eta, yv: (jax.nn.sigmoid(eta), yv * eta - jax.nn.softplus(eta)),
        lambda eta, yv: (torch.sigmoid(eta), yv * eta - F.softplus(eta))),
}


def _links(name):
    if name == "studentt":
        return jfl.studentt_link(4.0), tfl.studentt_link(4.0)
    return CALLABLE.get(name, (name, name))


def _glm_data(name, dim, seed=0):
    rng = np.random.default_rng(seed + dim)
    X = (rng.standard_normal((N, dim)) / np.sqrt(dim)).astype(np.float32)
    eta = X @ rng.standard_normal(dim)
    if name in ("logistic", "probit", "logistic_hook"):
        y = rng.uniform(size=N) < 1.0 / (1.0 + np.exp(-eta))
    elif name == "cloglog":
        y = rng.uniform(size=N) < -np.expm1(-np.exp(eta))
    elif name == "poisson":
        y = rng.poisson(np.exp(0.5 * eta))
    elif name == "studentt":
        y = eta + 0.3 * rng.standard_t(4.0, size=N)
    else:
        y = eta + 0.1 * rng.standard_normal(N)
    return X, np.asarray(y, np.float32)


def _state(dim, dp, seed=1, scale=0.1):
    rng = np.random.default_rng(seed)
    z = np.zeros((N_CHAINS, dp), np.float32)
    p = np.zeros((N_CHAINS, dp), np.float32)
    z[:, :dim] = scale * rng.standard_normal((N_CHAINS, dim))
    p[:, :dim] = rng.standard_normal((N_CHAINS, dim))
    return z, p


def _inv_mass(dim, dp):
    im = np.ones(dp, np.float32)
    im[:dim] = np.linspace(0.5, 2.0, dim)
    return im


@pytest.fixture(scope="module")
def jax_glm():
    """``(name, dim) -> (z0, p0, JAX's (z, p, U))``: the JAX package's fused
    trajectory on the model, its interpret-mode kernel built once."""
    made = {}

    def get(name, dim):
        if (name, dim) not in made:
            X, y = _glm_data(name, dim)
            traj = jfl.make_fused_trajectory(X, y, 10.0, EPS, L,
                                             block_chains=8, interpret=True,
                                             link=_links(name)[0])
            z0, p0 = _state(dim, traj.dim_padded)
            out = traj(jnp.asarray(z0), jnp.asarray(p0))
            made[name, dim] = (z0, p0, [np.asarray(a) for a in out])
        return made[name, dim]

    return get


def _check_glm(got, want, dim):
    zt, pt, ut = (t.numpy() for t in got)
    zj, pj, uj = want
    np.testing.assert_allclose(zt, zj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ut, uj, rtol=1e-5)
    assert np.all(zt[:, dim:] == 0) and np.all(pt[:, dim:] == 0)


@pytest.mark.parametrize("dim,dp", [(200, 256), (300, 384), (784, 896),
                                    (1100, 1152), (2100, 2176)])
def test_trajectory_matches_pallas(dim, dp, jax_glm):
    """K1's plain version, logistic, at 256, 384, 896, 1,152 and 2,176
    padded columns."""
    X, y = _glm_data("logistic", dim)
    traj = tfl.make_fused_trajectory(X, y, 10.0, EPS, L, block_chains=8,
                                     device="cpu")
    assert traj.dim_padded == dp
    z0, p0, want = jax_glm("logistic", dim)
    _check_glm(traj(torch.from_numpy(z0), torch.from_numpy(p0)), want, dim)


@pytest.mark.parametrize("name", LINKS[1:])
def test_every_link_at_384(name, jax_glm):
    """The other four built-in links at 384 padded columns (logistic is
    ``test_trajectory_matches_pallas[300-384]``)."""
    X, y = _glm_data(name, 300)
    traj = tfl.make_fused_trajectory(X, y, 10.0, EPS, L, block_chains=8,
                                     link=_links(name)[1], device="cpu")
    z0, p0, want = jax_glm(name, 300)
    _check_glm(traj(torch.from_numpy(z0), torch.from_numpy(p0)), want, 300)


@pytest.mark.parametrize("name", list(CALLABLE))
def test_callable_link_at_384(name, jax_glm):
    """K1's plain version on a callable link at 384 padded columns: the
    port's torch callable against the JAX package's ``jnp`` one traced into
    its Pallas kernel."""
    X, y = _glm_data(name, 300)
    traj = tfl.make_fused_trajectory(X, y, 10.0, EPS, L, block_chains=8,
                                     link=_links(name)[1], device="cpu")
    z0, p0, want = jax_glm(name, 300)
    _check_glm(traj(torch.from_numpy(z0), torch.from_numpy(p0)), want, 300)


def test_callable_link_past_1024(jax_glm):
    """K1's plain version on the callable cloglog link at 1,152 padded
    columns (1,100 of them the model's), against the JAX package's."""
    X, y = _glm_data("cloglog", 1100)
    traj = tfl.make_fused_trajectory(X, y, 10.0, EPS, L, block_chains=8,
                                     link=_links("cloglog")[1], device="cpu")
    assert traj.dim_padded == 1152
    z0, p0, want = jax_glm("cloglog", 1100)
    _check_glm(traj(torch.from_numpy(z0), torch.from_numpy(p0)), want, 1100)


def test_callable_link_rt_at_384():
    """K3's plain version on the cloglog link at 384 padded columns with a
    diagonal inverse mass against the JAX package's; at inverse mass 1 the
    bits of the fixed-step trajectory on the same link."""
    dim = 300
    X, y = _glm_data("cloglog", dim)
    jlink, tlink = _links("cloglog")
    jtraj = jfl.make_fused_trajectory_rt(X, y, 10.0, L, block_chains=8,
                                         interpret=True, link=jlink)
    ttraj = tfl.make_fused_trajectory_rt(X, y, 10.0, L, block_chains=8,
                                         link=tlink, device="cpu")
    z0, p0 = _state(dim, 384)
    im = _inv_mass(dim, 384)
    want = jtraj(jnp.asarray(z0), jnp.asarray(p0), jnp.asarray(EPS),
                 jnp.asarray(im))
    z, p = torch.from_numpy(z0), torch.from_numpy(p0)
    _check_glm(ttraj(z, p, EPS, torch.from_numpy(im)),
               [np.asarray(a) for a in want], dim)
    fixed = tfl.make_fused_trajectory(X, y, 10.0, EPS, L, block_chains=8,
                                      link=tlink, device="cpu")
    for a, b in zip(ttraj(z, p, torch.tensor(EPS), torch.ones(384)),
                    fixed(z, p)):
        assert torch.equal(a, b)


def _check_rt(dim, dp):
    """K3's plain version at ``dp`` padded columns with a diagonal inverse
    mass against the JAX package's run-time-parameter trajectory; at
    inverse mass 1 the bits of the fixed-step trajectory."""
    X, y = _glm_data("logistic", dim)
    jtraj = jfl.make_fused_trajectory_rt(X, y, 10.0, L, block_chains=8,
                                         interpret=True)
    ttraj = tfl.make_fused_trajectory_rt(X, y, 10.0, L, block_chains=8,
                                         device="cpu")
    assert ttraj.dim_padded == jtraj.dim_padded == dp
    z0, p0 = _state(dim, dp)
    im = _inv_mass(dim, dp)
    want = jtraj(jnp.asarray(z0), jnp.asarray(p0), jnp.asarray(EPS),
                 jnp.asarray(im))
    z, p = torch.from_numpy(z0), torch.from_numpy(p0)
    _check_glm(ttraj(z, p, EPS, torch.from_numpy(im)),
               [np.asarray(a) for a in want], dim)
    fixed = tfl.make_fused_trajectory(X, y, 10.0, EPS, L, block_chains=8,
                                      device="cpu")
    for a, b in zip(ttraj(z, p, torch.tensor(EPS), torch.ones(dp)),
                    fixed(z, p)):
        assert torch.equal(a, b)


def test_trajectory_rt_at_384_matches_pallas_and_the_fixed_step():
    """K3's plain version at 384 padded columns (``_check_rt``)."""
    _check_rt(300, 384)


def test_trajectory_rt_past_1024_matches_pallas_and_the_fixed_step():
    """K3's plain version at 1,152 padded columns (``_check_rt``)."""
    _check_rt(1100, 1152)


def _gauss_target(kind, dim, seed=2):
    rng = np.random.default_rng(seed + dim)
    var = np.logspace(0.0, 3.0, dim)
    if kind == "diagonal":
        return (1.0 / var).astype(np.float32), None
    Q, _ = np.linalg.qr(rng.standard_normal((dim, dim)))
    P = (Q / var) @ Q.T
    return (0.5 * (P + P.T)).astype(np.float32), \
        rng.standard_normal(dim).astype(np.float32)


@pytest.mark.parametrize("kind", ["diagonal", "dense"])
@pytest.mark.parametrize("dim,dp", [(250, 256), (500, 512), (1100, 1152),
                                    (2100, 2176)])
def test_gaussian_trajectory_matches_pallas(kind, dim, dp):
    """K2's plain version at 256, 512, 1,152 and 2,176 padded columns (the
    live widths of 250 and 500 dimensions are the padded widths; of 1,100
    and 2,100 the dimensions, multiples of 16), 3 leapfrogs at step 0.9 on
    log-spaced variances, condition number 1e3."""
    P, mean = _gauss_target(kind, dim)
    jtraj = jfl.make_fused_gaussian_trajectory(P, mean, 0.9, 3,
                                               block_chains=8, interpret=True)
    ttraj = tfl.make_fused_gaussian_trajectory(P, mean, 0.9, 3,
                                               block_chains=8, device="cpu")
    assert ttraj.dim_padded == jtraj.dim_padded == dp
    assert tfl._live_width(dim, dp) == {250: 256, 500: 512, 1100: 1104,
                                        2100: 2112}[dim]
    z0, p0 = _state(dim, dp, scale=1.0)
    want = jtraj(jnp.asarray(z0), jnp.asarray(p0))
    got = ttraj(torch.from_numpy(z0), torch.from_numpy(p0))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-4)
    assert torch.all(got[0][:, dim:] == 0) and torch.all(got[1][:, dim:] == 0)


def _tf32(x):
    """``x`` (float32) rounded to TF32 as the kernel's ``cvt.rna.tf32.f32``
    does: to nearest, ties away from zero, to 10 mantissa bits, through an
    int32 view (the sign is a bit of its own, so adding half of the 13
    dropped bits' unit to the magnitude rounds ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    """The kernel's split: hi = tf32(x), lo = tf32(x - hi)."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _trajectory_3xtf32(z, p, P, mean, eps, n_leap):
    """K2's trajectory (``_fused_gaussian_trajectory_plain``'s order of
    updates) with every product d . P done as the kernel past 1,024 padded
    columns does it, in float32: d_lo . P_hi + d_hi . P_lo + d_hi . P_hi,
    each operand split into TF32 parts."""
    P_hi, P_lo = _split(P)

    def grad_of(z):
        d_hi, d_lo = _split(z - mean)
        return -((d_lo @ P_hi + d_hi @ P_lo) + d_hi @ P_hi)

    half_eps = 0.5 * eps
    g = grad_of(z)
    for _ in range(n_leap):
        p = p + half_eps * g
        z = z + eps * p
        g = grad_of(z)
        p = p + half_eps * g
    d_hi, d_lo = _split(z - mean)
    u = 0.5 * ((z - mean) * ((d_lo @ P_hi + d_hi @ P_lo) + d_hi @ P_hi)
               ).sum(dim=1)
    return z, p, u


def test_tf32_split_rounds_to_nearest_ties_away():
    """The emulated split: hi keeps 10 mantissa bits, rounded to nearest
    with ties away from zero; lo is the rest to 2^-11 of it, so hi + lo
    is x to about 2^-22 of x."""
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -23, 3.0 + 2.0 ** -10],
                     dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                         3.0 + 2.0 ** -9], dtype=torch.float32)
    assert torch.equal(_tf32(x), want)
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(
        10_000).astype(np.float32))
    hi, lo = _split(v)
    assert torch.equal(_tf32(hi), hi) and torch.equal(_tf32(lo), lo)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    rel = (hi.double() + lo.double() - v.double()).abs() / v.double().abs()
    assert float(rel.max()) <= 2.0 ** -22


@pytest.mark.parametrize("kind", ["diagonal", "dense"])
def test_gaussian_trajectory_3xtf32_arithmetic(kind):
    """The arithmetic the card's check holds K2 to past 1,024 padded
    columns, on the CPU: 8 leapfrogs at step 0.9 on 300 dimensions (384
    padded columns; condition number 1e3), 16 chains, with every product
    split into TF32 parts as the kernel splits them and done as three
    float32 products, against JAX's Pallas kernel in interpret mode at this
    file's Gaussian tolerance (rtol, atol 2e-4), and against the same
    trajectory in float64: its largest per-chain error relative to each
    output's scale at most 4 times that of the float32 plain version
    (the card's check; measured 1.37 and 1.38 times here)."""
    dim, n_leap, chains = 300, 8, 16
    P, mean = _gauss_target(kind, dim)
    jtraj = jfl.make_fused_gaussian_trajectory(P, mean, 0.9, n_leap,
                                               block_chains=chains,
                                               interpret=True)
    ttraj = tfl.make_fused_gaussian_trajectory(P, mean, 0.9, n_leap,
                                               block_chains=chains,
                                               device="cpu")
    dp = ttraj.dim_padded
    rng = np.random.default_rng(11)
    z0 = np.zeros((chains, dp), np.float32)
    p0 = np.zeros((chains, dp), np.float32)
    z0[:, :dim] = rng.standard_normal((chains, dim))
    p0[:, :dim] = rng.standard_normal((chains, dim))
    z, p = torch.from_numpy(z0), torch.from_numpy(p0)
    got = _trajectory_3xtf32(z, p, ttraj.P, ttraj.mean, 0.9, n_leap)
    want = jtraj(jnp.asarray(z0), jnp.asarray(p0))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-4)
    plain = tfl._fused_gaussian_trajectory_plain(z, p, ttraj.P, ttraj.mean,
                                                 0.9, n_leap)
    exact = tfl._fused_gaussian_trajectory_plain(
        z.double(), p.double(), ttraj.P.double(), ttraj.mean.double(), 0.9,
        n_leap)

    def worst(out):
        return max(float(((a.double() - b).abs().max(dim=-1).values
                          if a.ndim > 1 else (a.double() - b).abs()).max()
                         / b.abs().max().clamp_min(1))
                   for a, b in zip(out, exact))

    assert worst(got) <= 4 * worst(plain), (worst(got), worst(plain))


def test_fused_step_at_384_fed_jax_draws(monkeypatch):
    """One ``make_fused_hmc_step`` transition at 384 padded columns
    (``_fed_step``)."""
    _fed_step(300, 384, monkeypatch)


def test_fused_step_past_1024_fed_jax_draws(monkeypatch):
    """One ``make_fused_hmc_step`` transition at 1,152 padded columns
    (``_fed_step``)."""
    _fed_step(1100, 1152, monkeypatch)


def _fed_step(dim, dp, monkeypatch):
    """One ``make_fused_hmc_step`` transition at ``dp`` padded columns, its
    momenta and accept uniforms those JAX's step draws from its key: the
    same accept decisions and positions (the trajectory's tolerances), the
    stored potential JAX's bf16-path one within 2e-2 and JAX's f32
    ``reference_potential`` at the new positions within 1e-5."""
    X, y = _glm_data("logistic", dim)
    pos = (0.1 * np.random.default_rng(4).standard_normal((N_CHAINS, dim))
           ).astype(np.float32)
    jstep = jfl.make_fused_hmc_step(X, y, step_size=EPS, n_leap=L,
                                    block_chains=8, interpret=True)
    tstep = tfl.make_fused_hmc_step(X, y, step_size=EPS, n_leap=L,
                                    block_chains=8, device="cpu")
    assert tstep.dim_padded == jstep.dim_padded == dp
    key = jax.random.PRNGKey(9)
    js0 = jstep.init(jnp.asarray(pos))
    js1, jinfo = jstep(key, js0)
    # the draws of JAX's step (fused_logreg.py make_fused_hmc_step: step)
    k_mom, k_acc = jax.random.split(key)
    p0 = np.array(jax.random.normal(k_mom, (N_CHAINS, dp), jnp.float32))
    u = np.array(jax.random.uniform(k_acc, (N_CHAINS,), jnp.float32))
    feed = {"randn": torch.from_numpy(p0), "rand": torch.from_numpy(u)}
    monkeypatch.setattr(torch, "randn", lambda *a, **k: feed["randn"])
    monkeypatch.setattr(torch, "rand", lambda *a, **k: feed["rand"])
    ts0 = tstep.init(torch.from_numpy(pos))
    ts1, tinfo = tstep(torch.Generator(), ts0)
    np.testing.assert_array_equal(tinfo["accepted"].numpy(),
                                  np.asarray(jinfo["accepted"]))
    np.testing.assert_allclose(ts1.position.numpy(), np.asarray(js1.position),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(ts1.potential.numpy(),
                               np.asarray(js1.potential), rtol=2e-2)
    f32 = np.asarray(jstep.init(js1.position[:, :dim]).potential)
    np.testing.assert_allclose(ts1.potential.numpy(), f32, rtol=1e-5)


def test_convert_carriers_past_1024(jax_glm):
    """``convert``'s carriers of the JAX package's fused data and state at
    1,152 padded columns: ``glm_data`` into the GLM factory (the same
    trajectory as JAX's), ``gaussian_target`` into the Gaussian one (padded
    to 1,152 with the identity past the model), and ``fused_state`` from
    JAX's step state, its position and potential unchanged."""
    dim, dp = 1100, 1152
    X, y = _glm_data("logistic", dim)
    Xt, yt = convert.glm_data(X, y, "cpu")
    traj = tfl.make_fused_trajectory(Xt, yt, 10.0, EPS, L, block_chains=8)
    assert traj.dim_padded == dp
    z0, p0, want = jax_glm("logistic", dim)
    _check_glm(traj(torch.from_numpy(z0), torch.from_numpy(p0)), want, dim)
    P, mean = _gauss_target("diagonal", dim)
    Pt, mt = convert.gaussian_target(P, mean, "cpu")
    assert mt is None and tuple(Pt.shape) == (dim,)
    g = tfl.make_fused_gaussian_trajectory(Pt, mt, block_chains=8)
    assert g.dim_padded == dp and torch.equal(g.P[dim:, dim:],
                                              torch.eye(dp - dim))
    jstep = jfl.make_fused_hmc_step(X, y, step_size=EPS, n_leap=L,
                                    block_chains=8, interpret=True)
    pos = (0.1 * np.random.default_rng(6).standard_normal((N_CHAINS, dim))
           ).astype(np.float32)
    js = jstep.init(jnp.asarray(pos))
    state = convert.fused_state(js.position, js.potential, dp, "cpu")
    assert tuple(state.position.shape) == (N_CHAINS, dp)
    np.testing.assert_array_equal(state.position.numpy(),
                                  np.asarray(js.position))
    np.testing.assert_array_equal(state.potential.numpy(),
                                  np.asarray(js.potential))
    short = convert.fused_state(pos, np.asarray(js.potential), dp, "cpu")
    assert torch.equal(short.position, state.position)


def test_kernels_refuse_past_1024_columns():
    """The launching wrappers take every width that is a multiple of 128:
    past 1,024 columns too (a 1,100-column model pads to 1,152), so there
    the width passes and only the CPU tensors are refused; a width that is
    no multiple of 128 is still refused, by name, first. The plain
    versions run 1,152 on the CPU."""
    rng = np.random.default_rng(5)
    X = rng.standard_normal((N, 1100)).astype(np.float32)
    y = (rng.uniform(size=N) < 0.5).astype(np.float32)
    traj = tfl.make_fused_trajectory(X, y, 10.0, EPS, 1, block_chains=1,
                                     device="cpu")
    assert traj.dim_padded == 1152
    z = torch.zeros((2, 1152))
    args = (traj.Xb, traj.y, traj.mask, traj.inv_pv)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        tfl.fused_trajectory_cuda(z, z, *args, EPS, 1, "logistic")
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        tfl.fused_trajectory_rt_cuda(z, z, *args, EPS, 1, "logistic",
                                     torch.ones(1152))
    with pytest.raises(ValueError, match="dim_padded a multiple of 128"):
        tfl.fused_trajectory_cuda(z[:, :1100], z[:, :1100],
                                  traj.Xb[:, :1100], *args[1:], EPS, 1,
                                  "logistic")
    zn, pn, un = traj(z, z.clone())
    assert zn.shape == (2, 1152) and bool(torch.isfinite(un).all())
    g = tfl.make_fused_gaussian_trajectory(np.ones(1100, np.float32),
                                           block_chains=1, device="cpu")
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        tfl.fused_gaussian_trajectory_cuda(z, z, g.P, g.mean, 0.1, 1, 1100)
    with pytest.raises(ValueError, match="dim_padded a multiple of 128"):
        tfl.fused_gaussian_trajectory_cuda(z[:, :200], z[:, :200],
                                           g.P[:200, :200], g.mean[:200],
                                           0.1, 1, 150)
    assert all(bool(torch.isfinite(t).all()) for t in g(z, z.clone()))
