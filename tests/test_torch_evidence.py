"""The PyTorch port's power-posterior evidence against the JAX package's,
on the CPU.

``power_schedule`` and ``estimate_from_ll`` (stepping-stone and the
variance-corrected TI, their per-chain values and the per-rung curves) take
the same numpy inputs on both sides, rtol 1e-5. A ladder transition is held
exactly: JAX's step under ``jax.vmap`` with the chain axis named (the
per-rung dual averaging pools over it), the port's transition fed the
momenta or walk normals, accept uniforms and swap uniforms JAX's step draws
from its keys; every state field at rtol 1e-5 (the dual averaging's logs at
1e-4 absolute, as the other samplers' tests hold them) and the accept and
swap decisions exactly, for HMC and RWMH inner moves, swaps every draw and
every second draw, through the end of adaptation, and on a hard-constraint
likelihood that is -inf on half the prior. The rest is distributional: the
conjugate normal of ``tests/test_evidence.py`` within 5 cross-chain
standard errors of its closed-form log Z.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmc_tpu
import mcmc_tpu_torch
from mcmc_tpu_torch import convert
from test_torch_chees import AX, as_tensors, assert_close, jax_run

jev = importlib.import_module("mcmc_tpu.evidence")
tev = importlib.import_module("mcmc_tpu_torch.evidence")

C, D, K, N_TRANS, N_ADAPT = 8, 2, 5, 12, 6
M0, V0, V = 0.5, 4.0, 1.0


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for every test here: the tests run in several
    worker processes at once, and torch's default of a thread per core
    oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=20, seed=7):
    rng = np.random.default_rng(seed)
    return (1.2 + np.sqrt(V) * rng.standard_normal((n, D))).astype(np.float32)


def _exact_log_z(y):
    """Closed-form log Z of y_i ~ N(theta, V I), theta ~ N(M0, V0 I)."""
    y = y.astype(np.float64)
    n = y.shape[0]
    vn = 1.0 / (1.0 / V0 + n / V)
    mn = vn * (M0 / V0 + y.sum(axis=0) / V)
    return float((-0.5 * n * np.log(2 * np.pi * V) + 0.5 * np.log(vn / V0)
                  - 0.5 * ((y ** 2).sum(axis=0) / V + M0 ** 2 / V0
                           - mn ** 2 / vn)).sum())


def _models(y, hard=False):
    """(JAX log prior, JAX log lik, port log prior, port log lik); with
    ``hard`` the likelihood is -inf where theta_0 < 0.5."""
    yj, yt = jnp.asarray(y), torch.from_numpy(y)
    c = float(np.log(2 * np.pi * V0))

    def jprior(th):
        return (-0.5 * (th - M0) ** 2 / V0 - 0.5 * c).sum()

    def jlik(th):
        r = yj - th[None, :]
        ll = (-0.5 * r ** 2 / V - 0.5 * jnp.log(2 * jnp.pi * V)).sum()
        return jnp.where(th[0] > 0.5, ll, -jnp.inf) if hard else ll

    def tprior(th):
        return (-0.5 * (th - M0) ** 2 / V0 - 0.5 * c).sum(-1)

    def tlik(th):
        r = yt[None, :, :] - th[:, None, :]
        ll = (-0.5 * r ** 2 / V - 0.5 * float(np.log(2 * np.pi * V))) \
            .sum(dim=(1, 2))
        return torch.where(th[:, 0] > 0.5, ll, -torch.inf) if hard else ll

    return jprior, jlik, tprior, tlik


CASES = {"hmc": ("hmc", 1, False), "hmc_every2": ("hmc", 2, False),
         "rwmh": ("rwmh", 1, False), "hmc_hard": ("hmc", 1, True),
         "rwmh_hard_every2": ("rwmh", 2, True)}
_RUNS = {}


def _settings(inner, every):
    kw = dict(n_burnin_draws=N_ADAPT, n_keep_draws=4, n_temps=K,
              schedule_power=3.0, inner=inner, step_size=0.3,
              n_leap_steps=3, par_scale=0.8, swap_every=every)
    return mcmc_tpu.EvidenceSettings(**kw), \
        mcmc_tpu_torch.EvidenceSettings(**kw)


def _jax_draws(key, inner):
    """The random numbers JAX's ladder step takes from ``key``: each rung's
    momenta (or walk normals) and accept uniform, and the swap uniforms."""
    k_inner, k_swap = jax.random.split(key)

    def one(k):
        k1, k2 = jax.random.split(k)
        return (jax.random.normal(k1, (D,), jnp.float32),
                jax.random.uniform(k2, dtype=jnp.float32))

    noise, u = jax.vmap(one)(jax.random.split(k_inner, K))
    return noise, u, jax.random.uniform(k_swap, (K - 1,), jnp.float32)


def _case(name):
    """JAX's ``N_TRANS`` ladder transitions (cached) with the draws they
    take, and the port's kernel."""
    inner, every, hard = CASES[name]
    js, ts = _settings(inner, every)
    jprior, jlik, tprior, tlik = _models(_data(), hard)
    _, _, tstep = tev._build_kernel(tprior, tlik, ts, D, torch.float32,
                                    "cpu", N_ADAPT)
    if name not in _RUNS:
        _, jmake, jstep = jev._build_kernel(jprior, jlik, js, D, jnp.float32,
                                            N_ADAPT, axis_name=AX)
        first = (M0 + 1.5 * np.random.default_rng(3).standard_normal(
            (C, D))).astype(np.float32)
        state0 = jax.vmap(jmake)(first)
        _RUNS[name] = jax_run(jstep, lambda k: _jax_draws(k, inner), state0,
                              N_TRANS, seed=31)
    return tstep, _RUNS[name]


def _fields(state):
    return {"X": state.X, "ll": state.ll, "lp": state.lp, "da": state.da}


@pytest.mark.parametrize("name", list(CASES))
def test_ladder_transition_matches_jax(name):
    """Each of JAX's transitions from JAX's state before it, fed its draws:
    positions, log-likelihoods, log-priors and the per-rung dual averaging
    at rtol 1e-5, the draw counter equal, and every rung's accept and every
    pair's swap decision exactly (the attempts on the even/odd pattern of
    the round)."""
    tstep, (states, infos, draws) = _case(name)
    every = CASES[name][1]
    n_swaps = n_rej = 0
    for t, d in enumerate(draws):
        noise, u, u_swap = as_tensors(d)
        if t % every != every - 1:
            u_swap = None
        new, info = tstep.transition(convert.evidence_state(states[t], "cpu"),
                                     noise, u, u_swap)
        want = states[t + 1]
        assert_close(_fields(new), {"X": want.X, "ll": want.ll,
                                    "lp": want.lp, "da": want.da},
                     what=f"{name} state after {t}")
        assert new.draw_ind == int(np.asarray(want.draw_ind).reshape(-1)[0])
        assert_close(info, infos[t], what=f"{name} info of {t}")
        n_swaps += int(np.asarray(infos[t]["swap_accepted"]).sum())
        n_rej += int((np.asarray(infos[t]["acc_all"]) == 0).sum())
    assert n_swaps > 0 and n_rej > 0, (n_swaps, n_rej)
    if CASES[name][2]:      # the hard constraint put -inf on some rung
        assert any(np.isinf(s.ll).any() for s in states)


def test_power_schedule_matches_jax():
    for k, power in ((2, 5.0), (8, 5.0), (24, 3.0)):
        np.testing.assert_allclose(
            tev.power_schedule(k, power).numpy(),
            np.asarray(jev.power_schedule(k, power, jnp.float32)),
            rtol=1e-6, atol=0)
    with pytest.raises(ValueError):
        tev.power_schedule(1, 5.0)


@pytest.mark.parametrize("with_inf", [False, True])
def test_estimate_from_ll_matches_jax(with_inf):
    """Stepping-stone and corrected TI per chain, the pooled per-rung mean
    and variance curves, on the same ``(n_keep, C, K)`` trace: rtol 1e-5
    (and -inf likelihoods on the prior rung, the hard-constraint case)."""
    rng = np.random.default_rng(11)
    betas = np.array(jev.power_schedule(K, 5.0, jnp.float32))
    ll = (-40.0 + 30.0 * betas + rng.standard_normal((50, C, K))
          * (3.0 - 2.0 * betas)).astype(np.float32)
    if with_inf:
        ll[rng.random((50, C)) < 0.3, 0] = -np.inf
    want = jev.estimate_from_ll(jnp.asarray(ll), jnp.asarray(betas))
    got = tev.estimate_from_ll(torch.from_numpy(ll), torch.from_numpy(betas))
    for g, w, what in zip(got, want, ("ss", "ti", "e_ll", "v_ll")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=what)
        assert np.isfinite(g.numpy()).all(), what
    se = lambda v: np.std(v, ddof=1) / np.sqrt(C)
    np.testing.assert_allclose(se(got[0].numpy()), se(np.asarray(want[0])),
                               rtol=1e-4)


def test_thermo_evidence_conjugate_normal():
    """``tests/test_evidence.py``'s conjugate normal (its settings, its
    data drawn with numpy): stepping-stone and corrected TI within 5 of
    their cross-chain standard errors of the closed-form log Z (floor
    0.25, as the JAX test), each other within 0.3, the per-rung curve
    rising, every rung accepting over 30% and every pair swapping over
    20%."""
    y = _data()
    _, _, tprior, tlik = _models(y)
    s = mcmc_tpu_torch.AlgoSettings(
        evidence_settings=mcmc_tpu_torch.EvidenceSettings(
            n_burnin_draws=600, n_keep_draws=600, n_temps=16,
            n_leap_steps=6))
    res = mcmc_tpu_torch.thermo_evidence(torch.zeros(D), tprior, tlik, s,
                                         n_chains=8, key=1)
    exact = _exact_log_z(y)
    assert res.n_chains == 8 and res.log_z_per_chain.shape == (8,)
    se = max(float(res.log_z_se), 1e-3)
    assert abs(float(res.log_z) - exact) < max(5 * se, 0.25), \
        (float(res.log_z), exact, se)
    se_ti = max(float(res.log_z_ti_se), 1e-3)
    assert abs(float(res.log_z_ti) - exact) < max(5 * se_ti, 0.25)
    assert abs(float(res.log_z) - float(res.log_z_ti)) < 0.3
    e = res.expected_log_lik.numpy()
    assert e[-1] > e[0]
    acc = res.accept_rate.numpy()
    assert acc.min() > 0.3 and acc.max() <= 1.0
    assert float(res.swap_accept_rate.min()) > 0.2
    assert res.step_sizes.shape == (16,)


def test_thermo_evidence_bounded_and_mesh():
    """Bounds attach the log-Jacobian to the untempered prior: a uniform
    prior on (0, 2) with a N(1, 0.3^2) likelihood of one observation has
    log Z = log(Phi((2-1)/0.3) - Phi(-1/0.3)) - log 2, within 5 standard
    errors; ``mesh=`` raises, naming A12."""
    from scipy.stats import norm
    lp = lambda th: torch.full(th.shape[:1], -float(np.log(2.0)),
                               dtype=th.dtype)
    ll = lambda th: (-0.5 * ((th[:, 0] - 1.0) / 0.3) ** 2
                     - float(np.log(0.3 * np.sqrt(2 * np.pi))))
    s = mcmc_tpu_torch.AlgoSettings(
        vals_bound=True, lower_bounds=np.zeros(1), upper_bounds=2 * np.ones(1),
        evidence_settings=mcmc_tpu_torch.EvidenceSettings(
            n_burnin_draws=200, n_keep_draws=200, n_temps=8))
    res = mcmc_tpu_torch.thermo_evidence(np.ones(1), lp, ll, s, n_chains=8,
                                         key=2, device="cpu")
    exact = np.log(norm.cdf(1 / 0.3) - norm.cdf(-1 / 0.3)) - np.log(2.0)
    se = max(float(res.log_z_se), 1e-3)
    assert abs(float(res.log_z) - exact) < max(5 * se, 0.1), \
        (float(res.log_z), exact, se)
    with pytest.raises(NotImplementedError, match="A12"):
        mcmc_tpu_torch.thermo_evidence(np.ones(1), lp, ll, s, mesh=object(),
                                       device="cpu")
