"""The PyTorch port's nested sampling against the JAX package's, on the
CPU.

Whole rounds are held exactly: the port's round loop (``nested._run``) fed
the initial live set, the survivor picks and the walk normals that JAX's
``nested_sampling`` draws from its key, against JAX's result capped at one
and at three rounds: log Z, H, the error bar, every dead and live point
with its log-likelihood and log-weight, the acceptance, rtol 1e-5. Also a
hard-constraint likelihood (ties at -inf, where the stable sort matters).
The rest is distributional, on the cases of ``tests/test_nested.py`` at
its sizes: the Gaussian evidence within 3 error bars of its closed form,
the two-mode mass, the ``ndtri`` prior, and the validation and round cap.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmc_tpu.nested import nested_sampling as jnested
from mcmc_tpu_torch import convert
from mcmc_tpu_torch import nested as tnested
from mcmc_tpu_torch import nested_sampling


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for every test here: the tests run in several
    worker processes at once, and torch's default of a thread per core
    oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _phi(x):
    return 0.5 * (1 + math.erf(x / math.sqrt(2)))


A, S = 5.0, 0.6
M = np.array([0.5, -0.8, 1.2, 0.0], np.float32)


def _gauss(hard=False):
    """Gaussian likelihood on the box (-A, A)^4, batched for the port; with
    ``hard`` it is -inf where theta_0 < 0."""
    mj, mt = jnp.asarray(M), torch.from_numpy(M)
    c = float(np.log(S) + 0.5 * np.log(2 * np.pi))

    def jll(th):
        ll = jnp.sum(-0.5 * ((th - mj) / S) ** 2 - c)
        return jnp.where(th[0] > 0.0, ll, -jnp.inf) if hard else ll

    def tll(th):
        ll = (-0.5 * ((th - mt) / S) ** 2 - c).sum(-1)
        return torch.where(th[:, 0] > 0.0, ll, -torch.inf) if hard else ll

    return (lambda u: -A + 2 * A * u), jll, tll


def _jax_draws(seed, n_live, B, walks, d, rounds):
    """What JAX's ``nested_sampling`` draws from ``PRNGKey(seed)``: the
    initial live set, then each round's survivor picks and walk normals."""
    k_init, k_run = jax.random.split(jax.random.PRNGKey(seed))
    live_u0 = jax.random.uniform(k_init, (n_live, d), jnp.float32,
                                 minval=1e-7, maxval=1.0 - 1e-7)
    out = []
    for _ in range(rounds):
        k_run, k_pick, k_walk = jax.random.split(k_run, 3)
        pick = jax.random.randint(k_pick, (B,), 0, n_live - B)
        zs = [jax.random.normal(jax.random.split(k)[0], (B, d), jnp.float32)
              for k in jax.random.split(k_walk, walks)]
        out.append((torch.from_numpy(np.array(pick)).long(),
                    torch.from_numpy(np.stack([np.asarray(z) for z in zs]))))
    return torch.from_numpy(np.array(live_u0)), out


@pytest.mark.parametrize("rounds,hard", [(1, False), (3, False), (3, True)])
def test_rounds_match_jax(rounds, hard):
    """``rounds`` rounds of 64 live points, batch 8, 6 walks, fed JAX's
    draws: the whole result against JAX's at rtol 1e-5."""
    n_live, B, walks, d = 64, 8, 6, 4
    pt, jll, tll = _gauss(hard)
    want = jnested(pt, jll, d, n_live=n_live, kill_frac=B / n_live,
                   walks=walks, max_rounds=rounds, key=jax.random.PRNGKey(5))
    live_u0, draws = _jax_draws(5, n_live, B, walks, d, rounds)
    st, done, syncs = tnested._run(lambda u: tll(pt(u)), live_u0, B, walks,
                                   rounds, 1e-3, lambda r: draws[r])
    got = tnested._finalize(st, pt, n_live, B, walks, done, syncs)
    assert got.n_rounds == want.n_rounds == rounds and syncs == rounds
    assert got.converged == want.converged
    assert got.n_like_evals == want.n_like_evals
    for name in ("log_z", "h", "log_z_err", "samples", "log_l", "log_w",
                 "accept_rate"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * max(
            1.0, float(np.abs(w[np.isfinite(w)]).max(initial=0.0))),
            err_msg=name)
    if hard:
        assert np.isinf(got.log_l.numpy()).any()
        assert np.isfinite(float(got.h))


def test_one_round_from_converted_state():
    """A round of the port's ``_make_round`` from a converted JAX loop
    carry: the dead buffers and the live set after it equal a fresh run's
    (the state converter keeps every field)."""
    n_live, B, walks, d = 64, 8, 6, 4
    pt, _jll, tll = _gauss()
    ll = lambda u: tll(pt(u))
    live_u0, draws = _jax_draws(9, n_live, B, walks, d, 2)
    st1, _, _ = tnested._run(ll, live_u0, B, walks, 2, 1e-3,
                             lambda r: draws[r])
    st0, _, _ = tnested._run(ll, live_u0, B, walks, 1, 1e-3,
                             lambda r: draws[r])
    carry = (st0.live_u.numpy(), st0.live_L.numpy(), st0.logX.numpy(),
             st0.logZ.numpy(), st0.h.numpy(), np.int32(1), False, None,
             st0.scale.numpy(), np.concatenate([st0.dead_u.numpy(),
                                                np.zeros((B, d), np.float32)]),
             np.concatenate([st0.dead_L.numpy(),
                             np.full(B, -np.inf, np.float32)]),
             np.concatenate([st0.dead_logw.numpy(),
                             np.full(B, -np.inf, np.float32)]),
             st0.acc.numpy())
    round_ = tnested._make_round(ll, n_live, B, d, 1e-3, torch.float32, "cpu")
    st, _done = round_(convert.nested_state(carry, "cpu"), *draws[1])
    for f in ("live_u", "live_L", "logZ", "h", "dead_u", "dead_L",
              "dead_logw"):
        assert torch.equal(getattr(st, f), getattr(st1, f)), f


def test_gaussian_evidence_exact():
    """``tests/test_nested.py``'s Gaussian on the box: converged, log Z
    within 3 error bars of the closed form, the equal-weight draws'
    moments, normalised weights and a healthy walk acceptance."""
    logZ_exact = float(sum(
        math.log((_phi((A - mi) / S) - _phi((-A - mi) / S)) / (2 * A))
        for mi in M))
    pt, _, tll = _gauss()
    res = nested_sampling(pt, tll, 4, n_live=512, key=0, device="cpu")
    assert res.converged and res.host_syncs == res.n_rounds
    err = max(float(res.log_z_err), 1e-3)
    assert abs(float(res.log_z) - logZ_exact) < 3 * err, \
        (float(res.log_z), logZ_exact, err)
    pd = res.posterior_draws(1, 2000).numpy()
    assert np.abs(pd.mean(0) - M).max() < 0.08
    np.testing.assert_allclose(pd.std(0), S, rtol=0.15)
    assert abs(np.exp(res.log_w.double().numpy()).sum() - 1.0) < 0.02
    assert 0.1 < float(res.accept_rate) < 0.9


def test_multimodal_and_ndtri_prior():
    """Two modes with 3:1 weights keep their mass; a N(m0, v0) prior
    through ``torch.special.ndtri`` gives the conjugate log Z within 4
    error bars."""
    d, a, s = 2, 8.0, 0.4
    mu = torch.tensor([[-3.0, -3.0], [3.0, 3.0]])
    logw = torch.log(torch.tensor([0.75, 0.25]))

    def ll(th):
        comp = (-0.5 * ((th[:, None, :] - mu) / s) ** 2).sum(-1) + logw
        return torch.logsumexp(comp, -1) - d * math.log(s) \
            - 0.5 * d * math.log(2 * math.pi)

    res = nested_sampling(lambda u: -a + 2 * a * u, ll, d, n_live=1024,
                          key=0, device="cpu")
    assert res.converged
    err = max(float(res.log_z_err), 1e-3)
    assert abs(float(res.log_z) + d * math.log(2 * a)) < 4 * err
    frac1 = float((res.posterior_draws(1, 4000)[:, 0] < 0).float().mean())
    assert abs(frac1 - 0.75) < 0.08, frac1

    n, v0, v, m0 = 15, 4.0, 1.0, 0.5
    y = np.asarray(1.0 + np.random.default_rng(3).normal(size=n))
    vn = 1.0 / (1.0 / v0 + n / v)
    mn = vn * (m0 / v0 + y.sum() / v)
    exact = float(-0.5 * n * np.log(2 * np.pi * v) + 0.5 * np.log(vn / v0)
                  - 0.5 * ((y ** 2).sum() / v + m0 ** 2 / v0 - mn ** 2 / vn))
    yt = torch.tensor(y, dtype=torch.float32)
    res = nested_sampling(
        lambda u: m0 + math.sqrt(v0) * torch.special.ndtri(u),
        lambda th: (-0.5 * (yt - th[:, :1]) ** 2 / v
                    - 0.5 * math.log(2 * math.pi * v)).sum(-1),
        1, n_live=512, key=4, device="cpu")
    err = max(float(res.log_z_err), 1e-3)
    assert res.converged and abs(float(res.log_z) - exact) < 4 * err


def test_round_cap_validation_and_hard_constraint():
    """A tiny round cap reports ``converged=False`` after exactly that many
    rounds; a ``kill_frac`` that leaves no survivors raises; a likelihood
    that is -inf on half the prior leaves H and the error bar finite and
    log Z within 5 error bars of its closed form."""
    ll = lambda th: (-0.5 * (th / 0.05) ** 2).sum(-1)
    res = nested_sampling(lambda u: -5 + 10 * u, ll, 2, n_live=128,
                          max_rounds=3, key=6, device="cpu")
    assert not res.converged and res.n_rounds == 3
    with pytest.raises(ValueError, match="kill_frac"):
        nested_sampling(lambda u: u, ll, 2, n_live=16, kill_frac=1.0,
                        device="cpu")

    a, s = 4.0, 0.5
    def hard(th):
        base = -0.5 * ((th[:, 0] - 1.0) / s) ** 2 - math.log(s) \
            - 0.5 * math.log(2 * math.pi)
        return torch.where(th[:, 0] > 0.0, base, -torch.inf)

    exact = math.log((_phi((a - 1.0) / s) - _phi(-1.0 / s)) / (2 * a))
    res = nested_sampling(lambda u: -a + 2 * a * u, hard, 1, n_live=512,
                          key=7, device="cpu")
    assert np.isfinite(float(res.h)) and np.isfinite(float(res.log_z_err))
    err = max(float(res.log_z_err), 1e-3)
    assert abs(float(res.log_z) - exact) < 5 * err
