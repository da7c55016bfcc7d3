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

The fused step accepts on the f32 potential at the end position (a
Deviation: the JAX step accepts on the trajectory's bf16-path U), held to
JAX's ``reference_potential`` there at rtol 1e-5.

The run-time-parameter trajectory (``make_fused_trajectory_rt``: step size
and diagonal inverse mass at call time) is held to the same tolerances
against the JAX package's, and at inverse mass 1 to the bits of the
fixed-step trajectory.

Besides the five built-in links, two callable links written once in
``jnp`` and once in torch go through the same tests at the same
tolerances: a complementary log-log Bernoulli (``cloglog``) and the JAX
package's logistic hook (tests/test_fused_logreg.py
``test_fused_trajectory_custom_link_hook``). On the card the port traces
such a callable into its kernel (``mcmc_tpu_torch.ops.link_codegen``); here
its plain version runs the callable.
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


D, N, L, EPS = 10, 64, 3, 0.05
N_CHAINS = 16
LINKS = ["logistic", "poisson", "linear", "probit", "studentt", "cloglog",
         "logistic_hook"]


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


def _data(name, seed=0):
    rng = np.random.default_rng(seed)
    X = (0.4 * rng.standard_normal((N, D))).astype(np.float32)
    eta = X @ (0.5 * np.ones(D))
    if name in ("logistic", "probit", "logistic_hook"):
        y = rng.uniform(size=N) < 1.0 / (1.0 + np.exp(-eta))
    elif name == "cloglog":
        y = rng.uniform(size=N) < -np.expm1(-np.exp(eta))
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


@pytest.fixture(scope="module")
def jax_fused():
    """The JAX package's trajectory and step per link, each built (and its
    interpret-mode Pallas kernel compiled) once for the module's tests."""
    made = {}

    def get(name):
        if name not in made:
            X, y = _data(name)
            jlink, _ = _links(name)
            made[name] = (
                jfl.make_fused_trajectory(X, y, 10.0, EPS, L, block_chains=8,
                                          interpret=True, link=jlink),
                jfl.make_fused_hmc_step(X, y, step_size=EPS, n_leap=L,
                                        block_chains=8, interpret=True,
                                        link=jlink))
        return made[name]

    return get


@pytest.mark.parametrize("name", LINKS)
def test_trajectory_matches_pallas(name, jax_fused):
    X, y = _data(name)
    _, tlink = _links(name)
    jtraj = jax_fused(name)[0]
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
def test_init_matches_reference_potential(name, jax_fused):
    """``step.init`` computes the f32 potential as JAX's
    ``reference_potential`` does (f32 on both sides; rtol 1e-5 covers the
    summation order); the JAX state carried over by ``convert`` equals the
    port's."""
    X, y = _data(name)
    _, tlink = _links(name)
    pos = 0.1 * np.random.default_rng(2).standard_normal((N_CHAINS, D))
    pos = pos.astype(np.float32)
    jstep = jax_fused(name)[1]
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


@pytest.mark.parametrize("name", LINKS)
def test_step_accept_potential_is_f32(name, jax_fused):
    """The fused step's accept test (a Deviation from the JAX package, whose
    step accepts on the trajectory's bf16-path potential): fed the momenta
    and uniforms of its generator, the step's trajectory matches JAX's (z
    and p at atol 1e-5); its accept potential is JAX's
    ``reference_potential`` at JAX's end position (rtol 1e-5, where JAX's
    own bf16-path U is held to atol 0.5 in tests/test_fused_logreg.py:48-49);
    and its accept decisions and stored potentials are those recomputed
    from the f32 potentials with the same uniforms."""
    X, y = _data(name)
    _, tlink = _links(name)
    pos = (0.1 * np.random.default_rng(2).standard_normal((N_CHAINS, D))
           ).astype(np.float32)
    jtraj, jstep = jax_fused(name)
    Xt, yt = convert.glm_data(X, y, "cpu")
    tstep = tfl.make_fused_hmc_step(Xt, yt, step_size=EPS, n_leap=L,
                                    block_chains=8, link=tlink)
    ttraj = tfl.make_fused_trajectory(Xt, yt, 10.0, EPS, L, block_chains=8,
                                      link=tlink)
    Dp = tstep.dim_padded
    st0 = tstep.init(torch.from_numpy(pos))
    # the step's draws: momenta on the real columns, then the uniforms
    g = torch.Generator().manual_seed(11)
    p0 = torch.randn((N_CHAINS, Dp), generator=g) \
        * (torch.arange(Dp) < D).to(torch.float32)
    u = torch.rand((N_CHAINS,), generator=g)
    st1, info = tstep(torch.Generator().manual_seed(11), st0)

    zj, pj, _uj = jtraj(jnp.asarray(st0.position.numpy()),
                        jnp.asarray(p0.numpy()))
    zt, pt, _ut = ttraj(st0.position, p0)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-5)
    U_end = np.asarray(jstep.init(zj[:, :D]).potential)
    tU = tstep.reference_potential(zt)
    np.testing.assert_allclose(tU.numpy(), U_end, rtol=1e-5)

    K = lambda p: 0.5 * (np.asarray(p, np.float64) ** 2).sum(1)
    comp = np.minimum(-(U_end + K(pj)) + (st0.potential.numpy() + K(p0)),
                      0.01)
    acc = u.numpy() < np.exp(comp)
    np.testing.assert_array_equal(info["accepted"].numpy(), acc)
    assert torch.equal(st1.potential, torch.where(info["accepted"], tU,
                                                  st0.potential))
    assert torch.equal(st1.position, torch.where(info["accepted"][:, None],
                                                 zt, st0.position))


@pytest.mark.parametrize("dim,n", [(D, N), (20, 1000)])
def test_callable_logistic_hook_near_builtin(dim, n):
    """The counterpart of the JAX package's
    ``test_fused_trajectory_custom_link_hook`` (tests/test_fused_logreg.py),
    at its sizes and at 20 columns and 1,000 rows: the logistic hook, a
    callable restating the built-in logistic family, against
    ``link="logistic"``. z and p are the same bits, as in the JAX package;
    U is not (a Deviation, stated in the module docstring): the built-in
    link sums a chain's log-likelihood as ``eta @ (w * y) - softplus(eta) @
    w``, the callable as ``ll_terms @ w``, and the two differ by up to
    1.9e-7 relative (measured over five seeds of models of 10 to 300
    columns), about two units in the last place; held to 1e-6."""
    rng = np.random.default_rng(7)
    X = (rng.standard_normal((n, dim)) / np.sqrt(dim)).astype(np.float32)
    eta = X @ rng.standard_normal(dim)
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-eta))).astype(np.float32)
    builtin = tfl.make_fused_trajectory(X, y, 10.0, EPS, L, block_chains=8,
                                        link="logistic", device="cpu")
    hook = tfl.make_fused_trajectory(X, y, 10.0, EPS, L, block_chains=8,
                                     link=CALLABLE["logistic_hook"][1],
                                     device="cpu")
    dp = builtin.dim_padded
    z = torch.zeros((8, dp))
    p = torch.zeros((8, dp))
    z[:, :dim] = torch.from_numpy(
        0.1 * rng.standard_normal((8, dim)).astype(np.float32))
    p[:, :dim] = torch.from_numpy(
        rng.standard_normal((8, dim)).astype(np.float32))
    zb, pb, ub = builtin(z, p)
    zc, pc, uc = hook(z, p)
    assert torch.equal(zb, zc) and torch.equal(pb, pc)
    np.testing.assert_allclose(uc.numpy(), ub.numpy(), rtol=1e-6, atol=0)


def test_callable_link_has_no_kernel():
    """A callable link the tracer cannot turn into a kernel (here one that
    reads a tensor of the data's length it captured) raises
    ``NotImplementedError`` naming what it met, on the kernel path and at
    the factories on the card, instead of falling back; the plain version
    on the CPU runs it. ``studentt_link`` is known by its code, and a
    traceable callable is traced."""
    X, y = convert.glm_data(*_data("linear"), "cpu")
    z, p = (torch.from_numpy(a) for a in _state(128))
    offset = torch.linspace(0.0, 0.1, N)
    link = lambda eta, yv: (eta + offset, -0.5 * (yv - eta - offset) ** 2)  # noqa: E731
    with pytest.raises(NotImplementedError,
                       match=r"captured tensor of shape \(64,\)"):
        tfl.fused_trajectory_cuda(z, p, X, y, y, 0.01, EPS, L, link)
    with pytest.raises(NotImplementedError, match="elementwise"):
        tfl._prepare_link(link, torch.device("cuda"), 128)
    tfl._prepare_link(link, torch.device("cpu"), 128)   # the CPU: nothing
    traj = tfl.make_fused_trajectory(X, y, 10.0, EPS, L, block_chains=8,
                                     link=link, device="cpu")
    assert bool(torch.isfinite(traj(z, p)[2]).all())
    assert tfl._link_code(tfl.studentt_link(4.0)) == (4, 4.0)
    assert tfl._link_code(CALLABLE["cloglog"][1])[0].ops[0] == \
        "aten.exp.default"
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
