"""The PyTorch port's Pathfinder against the JAX package's, on the CPU.

- The compact-BFGS pieces (``_diag_bfgs_update``, ``_gauss_pieces``,
  ``_sigma_mv``, ``_sample_gauss``) fed the same (S, Y, alpha, mask, z)
  agree with JAX's at rtol 1e-5 (W up to its columns' signs, through
  ``W diag(lam) W^T`` and the draws) and with the dense BFGS recursion
  (``tests/test_pathfinder.py:37``, ``:59``), one batch of both cases.
- One L-BFGS-plus-zoom step from the same optax state gives optax's next
  point at rtol 1e-5 and the same line-search iteration count, on a
  Gaussian and on a small logistic regression, two paths as one batch.
- On a 10-d Gaussian the batched path agrees with JAX's ``_lbfgs_path``
  over every iteration in which both take the same curvature-pair
  decisions (the first 22 of 30 here; at least 20 required): the iterates
  and their gradients at rtol 1e-4 of their scale, and the curvature pairs
  and ``alpha`` at rtol 1e-4 of each iteration's own scale while the
  gradient is resolved in float32 (|g| >= 1e-5 |g_0|: the first 11
  iterations). Past that the paths sit at the mode, the pairs difference
  gradients of rounding noise (1e-8), and at iteration 22 the port's first
  path reads an exact zero gradient (no pair) where JAX's takes one more.
- Fed JAX's path and its ELBO normals the ELBO argmax picks the same
  iterates; fed the same Gumbel uniforms the PSIS resample picks the same
  indices.
- Port analogs of ``:112``, ``:135``, ``:150`` and ``:178``, and
  ``convert.pathfinder_result`` handing JAX's draws to the port's pieces.
"""

import functools
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mcmc_tpu
import mcmc_tpu_torch
from mcmc_tpu import model_compare as jmc
from mcmc_tpu import stats as jstats
from mcmc_tpu_torch import convert
from mcmc_tpu_torch.integrators import value_and_grad_of
from mcmc_tpu_torch import model_compare as tmc
from mcmc_tpu_torch import stats as tstats


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for every test here: the tests run in several
    worker processes at once, and torch's default of a thread per core
    oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the packages export the function under the module's name
jpf = importlib.import_module("mcmc_tpu.pathfinder")
tpf = importlib.import_module("mcmc_tpu_torch.pathfinder")


def _dense_bfgs(S, Y, alpha):
    """Reference dense inverse-BFGS recursion from H0 = diag(alpha)."""
    d = S.shape[1]
    H = np.diag(alpha.astype(np.float64))
    for s, y in zip(S.astype(np.float64), Y.astype(np.float64)):
        rho = 1.0 / (s @ y)
        V = np.eye(d) - rho * np.outer(s, y)
        H = V @ H @ V.T + rho * np.outer(s, s)
    return H


def _spd_case(seed, masked):
    rng = np.random.default_rng(seed)
    d, J = 7, 4
    A = rng.normal(size=(d, d))
    S = rng.normal(size=(J, d))
    Y = S @ (A @ A.T + d * np.eye(d)).T           # y = H s  =>  s.y > 0
    alpha = np.abs(rng.normal(size=d)) + 0.5
    mask = np.ones(J, bool)
    H = _dense_bfgs(S, Y, alpha)
    if masked:
        H = _dense_bfgs(S[2:], Y[2:], alpha)
        S[:2], Y[:2], mask[:2] = 0.0, 0.0, False
    f = lambda a: a.astype(np.float32)
    return f(S), f(Y), f(alpha), mask, H


def test_compact_pieces_match_jax_and_dense_bfgs():
    cases = [_spd_case(0, False), _spd_case(1, True)]
    S, Y, alpha, mask = (np.stack([c[i] for c in cases]) for i in range(4))
    t = lambda a: torch.tensor(a)
    W, lam, logdet, ok = tpf._gauss_pieces(t(S), t(Y), t(alpha), t(mask))
    v = np.linspace(-1, 1, 7).astype(np.float32)
    mv = tpf._sigma_mv(t(np.stack([v, v])), t(alpha), t(S), t(Y), t(mask))
    z = np.random.default_rng(2).normal(size=(2, 50, 7)).astype(np.float32)
    mu = np.linspace(-2, 2, 7).astype(np.float32)
    x, logq = tpf._sample_gauss(t(z), t(np.stack([mu, mu])), t(alpha), W,
                                lam)
    assert bool(ok.all())
    for i, (_S, _Y, _a, _m, H) in enumerate(cases):
        jW, jlam, jlogdet, jok = jax.jit(jpf._gauss_pieces)(
            jnp.asarray(S[i]), jnp.asarray(Y[i]), jnp.asarray(alpha[i]),
            jnp.asarray(mask[i]))
        assert bool(jok)
        WL = lambda W_, l_: np.asarray(W_) @ np.diag(np.asarray(l_)) \
            @ np.asarray(W_).T
        np.testing.assert_allclose(WL(W[i], lam[i]), WL(jW, jlam),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(logdet[i]), float(jlogdet),
                                   rtol=1e-5)
        np.testing.assert_allclose(
            mv[i].numpy(), np.asarray(jax.jit(jpf._sigma_mv)(
                jnp.asarray(v), jnp.asarray(alpha[i]), jnp.asarray(S[i]),
                jnp.asarray(Y[i]), jnp.asarray(mask[i]))), rtol=1e-5)
        # the draws from the same normals (JAX draws them from a key)
        key = jax.random.PRNGKey(i)
        zj = jax.random.normal(key, (50, 7))
        xt, lqt = tpf._sample_gauss(t(np.asarray(zj)), t(mu), t(alpha[i]),
                                    W[i], lam[i])
        xj, lqj = jax.jit(jpf._sample_gauss, static_argnums=5)(
            key, jnp.asarray(mu), jnp.asarray(alpha[i]), jW, jlam, 50)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(lqt.numpy(), np.asarray(lqj), rtol=1e-5)
        # both against the dense recursion
        sa = np.sqrt(alpha[i].astype(np.float64))
        Sigma = sa[:, None] * (np.eye(7) + WL(W[i], lam[i])) * sa[None, :]
        np.testing.assert_allclose(Sigma, H, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(float(logdet[i]), np.linalg.slogdet(H)[1],
                                   rtol=1e-4)
        np.testing.assert_allclose(mv[i].numpy(), H @ v, rtol=2e-3)
    # the batch's draws are each case's own
    np.testing.assert_allclose(x[1, :3].numpy(), tpf._sample_gauss(
        t(z[1, :3]), t(mu), t(alpha[1]), W[1], lam[1])[0].numpy(),
        rtol=1e-6)


def test_diag_bfgs_update_matches_jax():
    rng = np.random.default_rng(3)
    alpha = (np.abs(rng.normal(size=(4, 5))) + 0.1).astype(np.float32)
    s = rng.normal(size=(4, 5)).astype(np.float32)
    y = rng.normal(size=(4, 5)).astype(np.float32)
    y = np.where((s * y).sum(1, keepdims=True) > 0, y, -y)
    ok = np.array([True, False, True, True])
    got = tpf._diag_bfgs_update(torch.tensor(alpha), torch.tensor(s),
                                torch.tensor(y), torch.tensor(ok))
    for i in range(4):
        want = jpf._diag_bfgs_update(jnp.asarray(alpha[i]), jnp.asarray(s[i]),
                                     jnp.asarray(y[i]), jnp.asarray(ok[i]))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   rtol=1e-5)
    assert bool((got > 0).all())
    np.testing.assert_array_equal(got[1].numpy(), alpha[1])


def _gaussian10():
    rng = np.random.default_rng(4)
    d = 10
    A = rng.normal(size=(d, d)) * 0.4
    cov = A @ A.T + np.eye(d)
    prec = np.linalg.inv(cov).astype(np.float32)
    mu = rng.normal(size=d).astype(np.float32)
    jneg = lambda x: 0.5 * (x - mu) @ prec @ (x - mu)
    P, M = torch.tensor(prec), torch.tensor(mu)
    tneg = lambda x: 0.5 * (((x - M) @ P) * (x - M)).sum(-1)
    return jneg, tneg, np.stack([np.full(d, 3.0), np.linspace(-4, 4, d)])


def _logistic():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 5)).astype(np.float32)
    beta = (rng.normal(size=5) * 2).astype(np.float32)
    y = (rng.uniform(size=200) < 1 / (1 + np.exp(-X @ beta))).astype(
        np.float32)

    def jneg(b):
        lg = X @ b
        return -(jnp.sum(y * lg - jax.nn.softplus(lg))
                 - 0.5 * jnp.sum(b ** 2) / 100)
    Xt, yt = torch.tensor(X), torch.tensor(y)

    def tneg(b):
        lg = b @ Xt.T
        return -((yt * lg - torch.nn.functional.softplus(lg)).sum(-1)
                 - 0.5 * (b ** 2).sum(-1) / 100)
    return jneg, tneg, np.stack([np.full(5, 4.0), np.linspace(-3, 3, 5)])


@pytest.mark.parametrize("target", ["gaussian", "logistic"])
def test_lbfgs_zoom_step_matches_optax(target):
    """From the optax state after three iterations (its memory partly
    filled), one more iteration of each path: the port's batched direction
    and zoom line search give optax's next point and iteration count."""
    jneg, tneg, starts = (_gaussian10 if target == "gaussian"
                          else _logistic)()
    starts = starts.astype(np.float32)
    opt = optax.lbfgs(memory_size=6)

    @jax.jit
    def step(x, st):
        v, g = jax.value_and_grad(jneg)(x)
        u, st = opt.update(g, st, x, value=v, grad=g, value_fn=jneg)
        return optax.apply_updates(x, u), st

    states, xs, nexts, counts = [], [], [], []
    for x0 in starts:
        x = jnp.asarray(x0)
        st = opt.init(x)
        for k in range(4):
            if k == 3:
                states.append(st)
                xs.append(np.asarray(x))
            x, st = step(x, st)
        nexts.append(np.asarray(x))
        counts.append(int(st[2].info.num_linesearch_steps))
    lb = [s[0] for s in states]
    stack = lambda f: torch.tensor(np.stack([np.asarray(f(s)) for s in lb]))
    ls = tpf.LBFGSState(
        int(lb[0].count), stack(lambda s: s.params),
        stack(lambda s: s.updates), stack(lambda s: s.diff_params_memory),
        stack(lambda s: s.diff_updates_memory),
        stack(lambda s: s.weights_memory))
    x = torch.tensor(np.stack(xs))
    tvg = value_and_grad_of(tneg)
    v, g = tvg(x)
    u, _ls = tpf.lbfgs_direction(ls, x, g)
    lr, _v, _g, count, syncs = tpf.zoom_linesearch(tvg, x, u, v, g)
    got = x + lr[:, None] * u
    np.testing.assert_allclose(got.numpy(), np.stack(nexts), rtol=1e-5,
                               atol=1e-6)
    assert count.tolist() == counts
    assert syncs == max(counts)


@functools.lru_cache(maxsize=None)
def _jax_paths(T=30):
    """JAX's ``_lbfgs_path`` from the 10-d Gaussian's two starts."""
    jneg, _, starts = _gaussian10()
    box = lambda z: -jneg(z)
    run = jax.jit(jax.vmap(lambda x0: jpf._lbfgs_path(box, x0, T, 6)))
    return [np.asarray(a) for a in run(jnp.asarray(starts, jnp.float32))]


def test_path_iterates_match_jax_while_branches_agree():
    jneg, tneg, starts = _gaussian10()
    want = _jax_paths()
    path, syncs = tpf._lbfgs_path(lambda z: -tneg(z),
                                  torch.tensor(starts, dtype=torch.float32),
                                  30, 6)
    got = [p.numpy() for p in path]
    # the iterations in which both took the same curvature decisions
    same = np.cumprod((got[6] == want[6]).all(axis=0))
    K = int(same.sum())
    assert K >= 20
    for a, b in zip(got[:2], want[:2]):      # theta, g
        np.testing.assert_allclose(a[:, :K], b[:, :K], rtol=1e-4,
                                   atol=1e-4 * np.abs(b[:, :K]).max())
    np.testing.assert_array_equal(got[5][:, :K], want[5][:, :K])
    g_norm = np.abs(want[1]).max(axis=-1).max(axis=0)       # (T,)
    resolved = int(np.cumprod(g_norm >= 1e-5 * g_norm[0]).sum())
    assert resolved >= 10
    for a, b in zip(got[2:5], want[2:5]):    # S, Y, alpha
        for k in range(resolved):
            np.testing.assert_allclose(a[:, k], b[:, k], rtol=1e-4,
                                       atol=1e-4 * np.abs(b[:, k]).max())
    assert syncs >= 30


def test_elbo_argmax_and_resample_match_jax():
    """Fed JAX's path (both starts of the 10-d Gaussian) and the normals
    its ELBO phase draws from its keys, the port scores every iterate and
    picks JAX's best; fed JAX's Gumbel uniforms, the smoothed resample
    picks JAX's indices."""
    jneg, tneg, _ = _gaussian10()
    path = _jax_paths()
    T, M, d = 30, 25, 10
    box_j = lambda x: -jneg(x)

    @jax.jit
    def jax_elbo(key, theta, g, S, Y, alpha, pmask, ok):
        """JAX's ELBO phase of one path (``pathfinder.one_path``) and the
        normals its ``_sample_gauss`` draws from the iterates' keys."""
        W, lam, _ld, ok_g = jax.vmap(jpf._gauss_pieces)(S, Y, alpha, pmask)
        mu = theta + jax.vmap(jpf._sigma_mv)(g, alpha, S, Y, pmask)
        valid = ok & ok_g & jnp.all(jnp.isfinite(mu), axis=1)
        keys = jax.random.split(key, T)
        xs, lq = jax.vmap(lambda k, m, a, w, l: jpf._sample_gauss(
            k, m, a, w, l, M))(keys, mu, alpha, W, lam)
        lp = jax.vmap(jax.vmap(box_j))(xs)
        elbo = jnp.where(valid, jnp.mean(lp - lq, axis=1), -jnp.inf)
        z = jax.vmap(lambda k: jax.random.normal(k, (M, d)))(keys)
        return jnp.argmax(elbo), elbo.max(), z

    outs = [jax_elbo(k, *(jnp.asarray(a[p]) for a in path))
            for p, k in enumerate(jax.random.split(jax.random.PRNGKey(7),
                                                   2))]
    best_j = [int(o[0]) for o in outs]
    elbo_j = [float(o[1]) for o in outs]
    z = np.stack([np.asarray(o[2]) for o in outs])       # (P, T, M, d)
    tpath = [torch.tensor(a) for a in path]
    *_pieces, elbo_t, best_t = tpf._best_iterates(lambda x: -tneg(x), tpath,
                                                  torch.tensor(z))
    assert best_t.tolist() == best_j
    np.testing.assert_allclose(elbo_t.numpy(), elbo_j, rtol=1e-4)

    rng = np.random.default_rng(8)
    lw = (rng.normal(size=400) + 0.5 * rng.standard_exponential(400)).astype(
        np.float32)
    Mt = int(min(0.2 * 400, 3.0 * math.sqrt(400)))
    lw_j, _k = jax.jit(functools.partial(jmc._psis_smooth_one, M=Mt))(
        jnp.asarray(lw))
    k_gum = jax.random.PRNGKey(9)
    take_j = np.asarray(jstats.gumbel_topk(k_gum, lw_j, 200))
    u = np.asarray(jax.random.uniform(k_gum, (400,)))
    lw_t, _k = tmc._psis_smooth_one(torch.tensor(lw), Mt)
    take_t = tstats.gumbel_topk_from_uniforms(torch.tensor(u), lw_t, 200)
    np.testing.assert_array_equal(take_t.numpy(), take_j)


def test_pathfinder_gaussian_recovery():
    """``tests/test_pathfinder.py:112`` on the port: the resampled draws
    match mean and covariance, the best ELBO is near the exact
    log-normalizer, the pooled Pareto k is small."""
    rng = np.random.default_rng(4)
    d = 8
    A = rng.normal(size=(d, d)) * 0.4
    cov = A @ A.T + np.eye(d)
    P = torch.tensor(np.linalg.inv(cov), dtype=torch.float32)
    mu = torch.tensor(rng.normal(size=d), dtype=torch.float32)
    lk = lambda x: -0.5 * (((x - mu) @ P) * (x - mu)).sum(-1)
    res = mcmc_tpu_torch.pathfinder(torch.zeros(d), lk, n_paths=4,
                                    n_draws=2000, key=0)
    draws = res.draws.numpy()
    assert draws.shape == (2000, d)
    assert np.abs(draws.mean(0) - mu.numpy()).max() < 0.15
    assert np.abs(np.cov(draws.T) - cov).max() / np.abs(cov).max() < 0.45
    exact = 0.5 * d * np.log(2 * np.pi) + 0.5 * np.linalg.slogdet(cov)[1]
    assert float(res.elbo.max()) > exact - 0.5
    assert float(res.pareto_k) < 0.7
    assert res.host_syncs >= 60            # one per line-search iteration


def test_pathfinder_bounded():
    """``:135``: Gamma(3, 2) behind a lower bound."""
    lk = lambda x: 2.0 * torch.log(x[:, 0]) - 2.0 * x[:, 0]
    s = mcmc_tpu_torch.AlgoSettings(vals_bound=True, lower_bounds=[0.0])
    res = mcmc_tpu_torch.pathfinder(torch.ones(1), lk, s, n_paths=2,
                                    n_draws=400, key=1)
    d = res.draws.numpy()
    assert d.min() > 0.0
    assert abs(d.mean() - 1.5) < 0.3
    lo, hi = res.init_box(2.0)
    assert float(lo[0]) > 0.0 and float(hi[0]) > float(lo[0])
    assert float(res.center[0]) > 0.0


def test_pathfinder_funnel_prefers_early_iterate():
    """``:150``: on a funnel no path's best iterate is the last one."""
    def funnel(x):
        v, z = x[:, 0], x[:, 1:]
        return -0.5 * (v / 3.0) ** 2 - 0.5 * (z ** 2).sum(-1) \
            * torch.exp(-v) - 2.0 * v
    res = mcmc_tpu_torch.pathfinder(torch.zeros(6), funnel, n_paths=4,
                                    n_draws=400, max_iters=40, key=2)
    assert bool((res.best_iter < 39).all())
    assert bool(torch.isfinite(res.elbo).all())


def test_pathfinder_validation_errors():
    lk = lambda x: -0.5 * (x * x).sum(-1)
    with pytest.raises(TypeError, match="settings"):
        mcmc_tpu_torch.pathfinder(torch.zeros(2), lk, settings=1.0)
    with pytest.raises(ValueError, match="pool"):
        mcmc_tpu_torch.pathfinder(torch.zeros(2), lk, n_paths=2,
                                  n_draws=1000, n_draws_per_path=10)
    with pytest.raises(ValueError, match="n_paths"):
        mcmc_tpu_torch.pathfinder(torch.zeros(2), lk, n_paths=0)


def test_port_pieces_on_jax_result():
    """``convert.pathfinder_result`` hands a JAX ``PathfinderResult`` (of
    seeded draws behind a lower bound) to the port: ``center``,
    ``init_box`` and ``spread_z`` equal JAX's; ``draw_init`` resamples
    rows of the draws."""
    rng = np.random.default_rng(5)
    dz = rng.normal(size=(300, 2)).astype(np.float32) + [0.5, -1.0]
    lb = np.array([0.0, -np.inf], np.float32)
    ub = np.full(2, np.inf, np.float32)
    codes = np.array([2, 1], np.int32)
    draws = np.asarray(mcmc_tpu.bounds.inv_transform(
        jnp.asarray(dz), jnp.asarray(codes), jnp.asarray(lb),
        jnp.asarray(ub)))
    res = mcmc_tpu.PathfinderResult(
        draws=draws, log_p=np.zeros(300), log_q=np.zeros(300),
        pareto_k=0.3, elbo=np.zeros(2), best_iter=np.array([3, 4]),
        n_lbfgs_iters=np.array([30, 30]), _draws_z=jnp.asarray(dz),
        _codes=jnp.asarray(codes), _lb=jnp.asarray(lb), _ub=jnp.asarray(ub),
        _vals_bound=True)
    port = convert.pathfinder_result(res, device="cpu")
    np.testing.assert_allclose(port.center.numpy(), np.asarray(res.center),
                               rtol=1e-5)
    np.testing.assert_allclose(port.spread_z.numpy(),
                               np.asarray(res.spread_z), rtol=1e-5)
    for got, want in zip(port.init_box(2.0), res.init_box(2.0)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    init = port.draw_init(3, 64)
    assert init.shape == (64, 2)
    assert bool((init[:, None, :] == port.draws[None]).all(-1).any(-1).all())
