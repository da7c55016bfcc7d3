"""The PyTorch port's tempered SMC against the JAX package's, on the CPU.

A stage is held exactly: the JAX package's ``smc`` run for one and for two
stages (``max_stages``) on 512 particles, and the port's stage from JAX's
cloud before it, fed the resampling uniform, mutation normals and accept
uniforms JAX's stage takes from its key chain; with the population random
walk and with whitened HMC mutations. The next temperature, the evidence,
the cloud, the per-particle accept counts and the stage's diagnostics at
rtol 1e-5 (the counts exactly). ``next_lambda`` and ``resample_indices``
(the three kinds) are held against JAX's on the same inputs. The rest is
distributional, on the cases of ``tests/test_smc.py`` at smaller sizes.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmc_tpu
import mcmc_tpu_torch
from mcmc_tpu import models as jmodels
from mcmc_tpu_torch import convert
from mcmc_tpu_torch import models as tmodels
from test_torch_chees import assert_close

jsmc = importlib.import_module("mcmc_tpu.samplers.smc")
tsmc = importlib.import_module("mcmc_tpu_torch.samplers.smc")

N, D, SEED = 512, 2, 12
_MU = np.array([[-2.0, -2.0], [2.0, 2.0]], np.float32)
_HALF = np.array([0.5, 0.5], np.float32)
CASES = {"rwmh": dict(inner="rwmh"),
         "hmc": dict(inner="hmc", step_size=0.4, n_leap_steps=3)}
_RUNS = {}


def _settings(name, max_stages):
    return dict(n_particles=N, n_mcmc_steps=3, init_scale=3.0,
                max_stages=max_stages, **CASES[name])


def _stage_draws(key, n_mcmc):
    """JAX's stage from its carried key: the resampling uniform, then per
    mutation step the particles' normals and accept uniforms; returns them
    and the key the next stage starts from."""
    key, k_res = jax.random.split(key)
    u_res = jax.random.uniform(k_res, (), jnp.float32)
    noise, u = [], []
    for _ in range(n_mcmc):
        key, sub = jax.random.split(key)
        ks = jax.random.split(sub, N)
        pairs = jax.vmap(jax.random.split)(ks)
        noise.append(jax.vmap(lambda k: jax.random.normal(k, (D,)))(
            pairs[:, 0]))
        u.append(jax.vmap(jax.random.uniform)(pairs[:, 1]))
    return (np.asarray(u_res), np.asarray(jnp.stack(noise)),
            np.asarray(jnp.stack(u))), key


def _smc_case(name):
    """The JAX package's runs of 1 and 2 stages (cached), its initial cloud
    and the draws of both stages."""
    if name not in _RUNS:
        jlk = jmodels.gaussian_mixture_model(_MU, _HALF, _HALF)
        outs = [mcmc_tpu.smc(np.zeros(D, np.float32), jlk,
                             mcmc_tpu.SMCSettings(**_settings(name, m)),
                             key=jax.random.PRNGKey(SEED)) for m in (1, 2)]
        key, k_init = jax.random.split(jax.random.PRNGKey(SEED))
        X0 = 3.0 * jax.random.normal(k_init, (N, D), jnp.float32)
        draws = []
        for _ in range(2):
            d, key = _stage_draws(key, 3)
            draws.append(d)
        _RUNS[name] = (np.asarray(X0), outs, draws)
    return _RUNS[name]


def _tstage(name):
    tlk = tmodels.gaussian_mixture_model(_MU, _HALF, _HALF, device="cpu")
    s = mcmc_tpu_torch.SMCSettings(**_settings(name, 2))
    return tsmc.build_smc_stage(tlk, s, torch.zeros(D),
                                torch.full((D,), 3.0))


def _after(out, stages):
    """The port's view of the JAX run's result after ``stages`` stages."""
    dg = out.diagnostics
    return {"X": np.asarray(out.draws), "n_acc": np.asarray(out.n_accept_draws),
            "lam": np.asarray(dg["lambdas"])[stages - 1],
            "log_z": np.asarray(dg["log_z"]),
            "lambdas": np.asarray(dg["lambdas"]),
            "ess_frac": np.asarray(dg["ess_fraction"]),
            "acc_rate": np.asarray(dg["mutation_accept_rate"])}


def _port(st):
    n = st.stage
    return {"X": st.X, "n_acc": st.n_acc, "lam": st.lam, "log_z": st.log_z,
            "lambdas": st.lambdas[:n], "ess_frac": st.ess_frac[:n],
            "acc_rate": st.acc_rate[:n]}


@pytest.mark.parametrize("name", list(CASES))
def test_smc_stages_match_jax(name):
    """Stage 1 from JAX's initial cloud and stage 2 from JAX's cloud after
    stage 1 (the carried kernel values recomputed from it), each fed JAX's
    draws: every field at rtol 1e-5 against JAX's run of that many stages,
    the accept counts exactly; neither stage reaches lambda 1."""
    X0, outs, draws = _smc_case(name)
    stage = _tstage(name)
    with torch.no_grad():
        st = stage.init(torch.tensor(X0))
        st1 = stage.transition(st, *[torch.tensor(a) for a in draws[0]])
        assert_close(_port(st1), _after(outs[0], 1), what="stage 1")
        a1 = _after(outs[0], 1)
        st = stage.init(torch.tensor(a1["X"]))._replace(
            lam=torch.tensor(a1["lam"]), stage=1,
            log_z=torch.tensor(a1["log_z"]),
            n_acc=torch.tensor(a1["n_acc"]),
            lambdas=st1.lambdas, ess_frac=st1.ess_frac,
            acc_rate=st1.acc_rate)
        st2 = stage.transition(st, *[torch.tensor(a) for a in draws[1]])
        assert_close(_port(st2), _after(outs[1], 2), what="stage 2")
    assert float(st2.lam) < 1.0
    assert 0.05 < float(st2.acc_rate[1]) < 0.95


def test_convert_round_trip():
    """``convert.smc_state`` takes the JAX package's ``SMCState`` without
    its key (the stage count as a host integer) and equals the port's
    initial state of the same cloud."""
    X0, _, _ = _smc_case("rwmh")
    stage = _tstage("rwmh")
    want = stage.init(torch.tensor(X0))
    jstate = jsmc.SMCState(
        key=jax.random.PRNGKey(0), X=X0, lk=want.lk.numpy(),
        lq=want.lq.numpy(), lam=np.float32(0.0), stage=np.int32(0),
        log_z=np.float32(0.0), n_acc=np.zeros(N, np.int32),
        lambdas=np.zeros(2, np.float32), ess_frac=np.zeros(2, np.float32),
        acc_rate=np.zeros(2, np.float32))
    got = convert.smc_state(jstate, "cpu")
    assert got.stage == 0 and got.n_acc.dtype == torch.int32
    for f, g, w in zip(got._fields, got, want):
        if f != "stage":
            torch.testing.assert_close(g, w, msg=f)


def test_next_lambda_and_resampling_match_jax():
    """``next_lambda`` on JAX's weight profile (tests/test_smc.py) equals
    JAX's at rtol 1e-6, with the conservative ESS and the jump to 1 when
    reachable; ``resample_indices`` of each kind, on the same uniforms JAX
    draws from its key, picks JAX's ancestors exactly, including the
    degenerate and the uniform weights."""
    delta = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (512,))
                       * 20.0)
    for lam in (0.0, 0.2, 0.9):
        want = float(jsmc.next_lambda(jnp.asarray(lam), delta,
                                      jnp.asarray(0.5)))
        got = float(tsmc.next_lambda(torch.tensor(lam), torch.tensor(delta),
                                     0.5))
        assert got == pytest.approx(want, rel=1e-6)
    assert float(tsmc.next_lambda(torch.tensor(0.2),
                                  torch.tensor(delta) * 1e-4, 0.5)) == 1.0
    n = 64
    rng = np.random.default_rng(4)
    cases = [np.zeros(n, np.float32),
             np.full(n, -1e30, np.float32),
             (3.0 * rng.standard_normal(n)).astype(np.float32)]
    cases[1][7] = 0.0
    for logw in cases:
        for kind in ("systematic", "stratified", "multinomial"):
            key = jax.random.PRNGKey(int(rng.integers(1000)))
            want = np.asarray(jsmc.resample_indices(key, logw, n, kind))
            shape = () if kind == "systematic" else (n,)
            u = torch.tensor(np.asarray(jax.random.uniform(key, shape)))
            got = tsmc.resample_indices(u, torch.tensor(logw), kind)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=kind)
    np.testing.assert_array_equal(
        np.sort(tsmc.resample_indices(torch.tensor(0.3), torch.zeros(n))
                .numpy()), np.arange(n))


def test_smc_gaussian_moments_and_evidence():
    """tests/test_smc.py::test_smc_gaussian_moments_and_evidence at 2,048
    particles: mean 1 within 0.1, variance 1.69 within 12%, log Z within
    0.15 of (d/2) log(2 pi 1.69); the schedule increases to exactly 1 with
    every stage's ESS at the target or above; one host sync a stage."""
    d, sig2 = 3, 1.69
    lk = lambda v: -0.5 * ((v - 1.0) ** 2).sum(-1) / sig2
    s = mcmc_tpu_torch.SMCSettings(n_particles=2048, init_scale=3.0)
    out = mcmc_tpu_torch.smc(np.zeros(d), lk, s, key=0, device="cpu")
    dd = out.draws.numpy()
    assert dd.shape == (2048, d) and out.diagnostics["completed"]
    np.testing.assert_allclose(dd.mean(axis=0), 1.0, atol=0.1)
    np.testing.assert_allclose(dd.var(axis=0), sig2, rtol=0.12)
    exact = 0.5 * d * np.log(2 * np.pi * sig2)
    assert abs(float(out.diagnostics["log_z"]) - exact) < 0.15
    lams = out.diagnostics["lambdas"].numpy()
    assert (np.diff(np.concatenate([[0.0], lams])) > 0).all()
    assert lams[-1] == 1.0
    assert (out.diagnostics["ess_fraction"].numpy() >= 0.5 - 1e-4).all()
    assert out.n_accept_draws.shape == (2048,)
    assert int(out.n_accept_draws.max()) <= 5 * out.diagnostics["n_stages"]


def test_smc_unequal_mixture_mass_and_modes():
    """``test_smc_unequal_mixture_mass_and_modes`` at 4,096 particles: the
    0.3 / 0.7 split within 0.05, each mode's mean within 0.08 of -+2, log Z
    within 0.2 of log(2 pi 0.25)."""
    def mix(v):
        return torch.logaddexp(
            math.log(0.3) - 0.5 * ((v + 2.0) ** 2).sum(-1) / 0.25,
            math.log(0.7) - 0.5 * ((v - 2.0) ** 2).sum(-1) / 0.25)

    s = mcmc_tpu_torch.SMCSettings(n_particles=4096, init_scale=4.0)
    out = mcmc_tpu_torch.smc(np.zeros(2), mix, s, key=1, device="cpu")
    d = out.draws.numpy()
    pos = d[..., 0] > 0
    assert abs(pos.mean() - 0.7) < 0.05, pos.mean()
    np.testing.assert_allclose(d[pos].mean(axis=0), [2.0, 2.0], atol=0.08)
    np.testing.assert_allclose(d[~pos].mean(axis=0), [-2.0, -2.0], atol=0.08)
    assert abs(float(out.diagnostics["log_z"])
               - np.log(2 * np.pi * 0.25)) < 0.2


def test_smc_hmc_inner_ill_conditioned():
    """``test_smc_hmc_inner_ill_conditioned`` at 10 dims and 2,048
    particles: whitened HMC mutations reach lambda 1 and every variance
    within 25% of the target's."""
    lk = tmodels.ill_conditioned_gaussian(10, condition_number=1000.0,
                                          device="cpu")
    s = mcmc_tpu_torch.SMCSettings(n_particles=2048, init_scale=10.0,
                                   inner="hmc", n_mcmc_steps=3,
                                   step_size=0.5, n_leap_steps=5)
    out = mcmc_tpu_torch.smc(np.zeros(10), lk, s, key=2, device="cpu")
    assert out.diagnostics["completed"]
    ratio = out.draws.var(dim=0).numpy() / np.asarray(lk.variances)
    np.testing.assert_allclose(ratio, 1.0, atol=0.25)


def test_smc_bounded_truncated_normal():
    """``test_smc_bounded_truncated_normal`` at 2,048 particles: the cloud
    stays above 0, the truncated normal's mean within 0.06, and log Z within
    0.12 of the constrained-space integral."""
    from scipy.stats import norm
    algo = mcmc_tpu_torch.AlgoSettings(
        vals_bound=True, lower_bounds=np.zeros(2),
        upper_bounds=np.full(2, np.inf),
        smc_settings=mcmc_tpu_torch.SMCSettings(n_particles=2048))
    lk = lambda v: -0.5 * ((v - 1.0) ** 2).sum(-1)
    out = mcmc_tpu_torch.smc(np.ones(2), lk, algo, key=3, device="cpu")
    d = out.draws.numpy()
    assert (d > 0).all()
    np.testing.assert_allclose(d.mean(), 1.0 + norm.pdf(1.0) / norm.cdf(1.0),
                               atol=0.06)
    exact = 2 * (0.5 * np.log(2 * np.pi) + np.log(norm.cdf(1.0)))
    assert abs(float(out.diagnostics["log_z"]) - exact) < 0.12


def test_smc_determinism_stages_and_refusals():
    """One seed repeats bit for bit; ``max_stages`` stops an unfinished run
    (``completed`` false, diagnostics trimmed to the stages taken); the
    refusals of tests/test_smc.py::test_smc_validation_errors, and ``mesh``
    (not ported)."""
    lk = lambda v: -0.5 * (v ** 2).sum(-1) / 0.01
    s = mcmc_tpu_torch.SMCSettings(n_particles=512, max_stages=20,
                                   resample="stratified")
    a = mcmc_tpu_torch.smc(np.zeros(2), lk, s, key=7, device="cpu")
    b = mcmc_tpu_torch.smc(np.zeros(2), lk, s, key=7, device="cpu")
    assert torch.equal(a.draws, b.draws)
    assert float(a.diagnostics["log_z"]) == float(b.diagnostics["log_z"])
    s2 = mcmc_tpu_torch.SMCSettings(n_particles=512, max_stages=2,
                                    resample="multinomial")
    c = mcmc_tpu_torch.smc(np.zeros(2), lk, s2, key=7, device="cpu")
    assert c.diagnostics["n_stages"] == 2 and not c.diagnostics["completed"]
    assert c.diagnostics["lambdas"].shape == (2,)
    sq = lambda v: -0.5 * (v ** 2).sum(-1)
    with pytest.raises(ValueError, match="n_particles"):
        mcmc_tpu_torch.smc(np.zeros((4, 2)), sq, device="cpu")
    with pytest.raises(ValueError, match="ess_target"):
        mcmc_tpu_torch.smc(np.zeros(2), sq,
                           mcmc_tpu_torch.SMCSettings(ess_target=1.5),
                           device="cpu")
    with pytest.raises(ValueError, match="inner"):
        mcmc_tpu_torch.smc(np.zeros(2), sq,
                           mcmc_tpu_torch.SMCSettings(inner="nuts"),
                           device="cpu")
    with pytest.raises(ValueError, match="resample"):
        mcmc_tpu_torch.smc(np.zeros(2), sq,
                           mcmc_tpu_torch.SMCSettings(resample="x"),
                           device="cpu")
    with pytest.raises(NotImplementedError, match="A12"):
        mcmc_tpu_torch.smc(np.zeros(2), sq, mesh=object(), device="cpu")
