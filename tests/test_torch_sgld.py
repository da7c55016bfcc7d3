"""The PyTorch port's SGLD, pSGLD and SGHMC against the JAX package's, on
the CPU.

The transition is held exactly: JAX's step (``minibatch="per-chain"``:
the single-chain step under ``jax.vmap``; ``"shared"``: its chain-batch
step, chain 0's key giving the indices) and the port's transition fed the
minibatch indices (``randint``) and the injected normals JAX draws from its
keys, on a logistic regression: SGLD with a fixed step, with the decay
schedule, with a diagonal preconditioner and on a bounded problem; pSGLD;
SGHMC; each where it applies in both minibatch modes. Every state field at
rtol 1e-5 (the draw counter, a host integer, equal) and the finite-update
decisions exactly. The anchors are ``tests/test_sgld.py``'s: the exact
unadjusted-Langevin variance and SGHMC's exact discrete-Lyapunov variance,
at smaller sizes; the validation errors are JAX's.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmc_tpu
import mcmc_tpu_torch
from mcmc_tpu.samplers import common as jcommon
from mcmc_tpu_torch import convert
from mcmc_tpu_torch.samplers import common as tcommon
from test_sgld import _lyapunov_var_x
from test_torch_chees import as_tensors, jax_run
from test_torch_slice_sampler import assert_host_state


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for every test here: the tests run in several
    worker processes at once, and torch's default of a thread per core
    oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


jsgld = importlib.import_module("mcmc_tpu.samplers.sgld")
tsgld = importlib.import_module("mcmc_tpu_torch.samplers.sgld")

D, C, N, B, N_TRANS = 3, 16, 512, 32, 30
_RNG = np.random.default_rng(11)
_X = _RNG.standard_normal((N, D)).astype(np.float32)
_BETA = np.array([0.5, -1.0, 0.25], np.float32)
_Y = (_RNG.uniform(size=N) < 1.0 / (1.0 + np.exp(-_X @ _BETA))
      ).astype(np.float32)
_LB = np.array([-np.inf, -np.inf, 0.0], np.float32)
_UB = np.array([np.inf, 0.0, np.inf], np.float32)

# sampler, minibatch, settings, rmsprop, bounded
CASES = {
    "sgld": ("sgld", "per-chain", dict(step_size=2e-3), False, False),
    "sgld_shared": ("sgld", "shared", dict(step_size=2e-3), False, False),
    "sgld_decay": ("sgld", "per-chain", dict(step_size=4e-3,
                                             decay_gamma=0.55, decay_b=5.0),
                   False, False),
    "sgld_precond": ("sgld", "shared", dict(
        step_size=2e-3, precond_mat=np.array([0.5, 1.0, 2.0])), False,
        False),
    "sgld_bounded": ("sgld", "per-chain", dict(step_size=2e-3), False,
                     True),
    "psgld": ("sgld", "per-chain", dict(step_size=2e-3), True, False),
    "psgld_shared": ("sgld", "shared", dict(step_size=2e-3), True, False),
    "sghmc": ("sghmc", "per-chain", dict(step_size=2e-4), False, False),
    "sghmc_shared": ("sghmc", "shared", dict(step_size=2e-4), False, False),
}
_RUNS = {}


def _jax_lik(beta, batch):
    Xb, yb = batch
    eta = Xb @ beta
    return jnp.sum(yb * eta - jax.nn.softplus(eta))


def _torch_lik(theta, batch):
    Xb, yb = batch
    eta = (Xb @ theta[:, :, None])[..., 0]
    return (yb * eta - torch.nn.functional.softplus(eta)).sum(-1)


def _draws(key):
    k_idx, k_noise = jax.random.split(key)
    return (jax.random.randint(k_idx, (B,), 0, N),
            jax.random.normal(k_noise, (D,), jnp.float32))


def _jax_shared_run(jstep, state0, n, seed):
    """``n`` shared-minibatch transitions of JAX's chain-batch step, with
    its draws: chain 0's indices and every chain's normals (each chain's
    key split in two as in ``_draws``)."""
    step = jax.jit(jstep)
    draws_of = jax.jit(jax.vmap(_draws))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    states, infos, draws = [as_np(state0)], [], []
    st = state0
    for k in jax.random.split(jax.random.PRNGKey(seed), n):
        keys = jax.random.split(k, C)
        idx, noise = draws_of(keys)
        draws.append((np.asarray(idx)[0], np.asarray(noise)))
        st, info = step(keys, st)
        states.append(as_np(st))
        infos.append(as_np(info))
    return states, infos, draws


def _settings(name):
    kind, _, kw, _, _ = CASES[name]
    cls = "SGLDSettings" if kind == "sgld" else "SGHMCSettings"
    return (getattr(mcmc_tpu, cls)(batch_size=B, **kw),
            getattr(mcmc_tpu_torch, cls)(batch_size=B, **kw))


def _case(name):
    kind, mb, kw, rmsprop, bounded = CASES[name]
    js, ts = _settings(name)
    akw = dict(vals_bound=True, lower_bounds=_LB, upper_bounds=_UB) \
        if bounded else {}
    x0 = np.tile(np.array([0.4, -0.8, 0.3], np.float32), (C, 1)) \
        + 0.05 * np.random.default_rng(1).standard_normal((C, D)
                                                           ).astype(np.float32)
    jprior = lambda b: -0.5 * jnp.sum(b ** 2) / 100.0
    tprior = lambda b: -0.5 * (b * b).sum(-1) / 100.0
    tprob = tcommon.setup_problem(torch.from_numpy(x0), tprior,
                                  mcmc_tpu_torch.AlgoSettings(**akw), None)
    tdata = (torch.from_numpy(_X), torch.from_numpy(_Y))
    shared = mb == "shared"
    if name not in _RUNS:
        jprob = jcommon.setup_problem(jnp.asarray(x0), jprior,
                                      mcmc_tpu.AlgoSettings(**akw), None)
        jdata = (jnp.asarray(_X), jnp.asarray(_Y))
        if kind == "sgld":
            jinit, jstep, jbatched = jsgld.build_sgld_kernel(
                jprob, _jax_lik, jdata, N,
                jcommon.make_spd(js.precond_mat, D, jnp.float32), js,
                rmsprop=rmsprop)
        else:
            jinit, jstep, jbatched = jsgld.build_sghmc_kernel(
                jprob, _jax_lik, jdata, N, js)
        st0 = jax.vmap(jinit)(jprob.first_draw)
        _RUNS[name] = (_jax_shared_run(jbatched, st0, N_TRANS, 4) if shared
                       else jax_run(jstep, _draws, st0, N_TRANS, 4))
    if kind == "sgld":
        tinit, tstep = tsgld.build_sgld_kernel(
            tprob, _torch_lik, tdata, N,
            tcommon.make_spd(ts.precond_mat, D, torch.float32, "cpu"), ts,
            rmsprop=rmsprop, shared=shared)
        conv = convert.sgld_state
    else:
        tinit, tstep = tsgld.build_sghmc_kernel(tprob, _torch_lik, tdata, N,
                                                ts, shared=shared)
        conv = convert.sghmc_state
    return tprob, tinit, tstep, conv, _RUNS[name]


@pytest.mark.parametrize("name", list(CASES))
def test_sg_transition_matches_jax(name):
    """Each of JAX's 30 transitions from JAX's state before it, fed its
    indices and normals: every state field at rtol 1e-5, the draw counter
    equal, the finite-update decisions exactly; the port's ``init`` gives
    JAX's first state."""
    tprob, tinit, tstep, conv, (states, infos, draws) = _case(name)
    with torch.no_grad():
        assert_host_state(tinit(tprob.first_draw), states[0], what="init")
        for t, d in enumerate(draws):
            new, info = tstep.transition(conv(states[t], "cpu"),
                                         *as_tensors(d))
            assert_host_state(new, states[t + 1], what=f"state after {t}")
            np.testing.assert_array_equal(info["accepted"].numpy(),
                                          infos[t]["accepted"])
    moved = np.abs(states[-1].position - states[0].position).max()
    assert moved > 1e-2, moved


@pytest.mark.parametrize("name", list(CASES))
def test_sg_run_fed_jax_draws(name):
    """The port's 30 transitions from JAX's start, fed JAX's draws: every
    update finite as in JAX, the final state within 1e-4; two autograd
    gradients a transition and no host synchronisation."""
    _, _, tstep, conv, (states, infos, draws) = _case(name)
    st = conv(states[0], "cpu")
    with torch.no_grad():
        for d in draws:
            st, info = tstep.transition(st, *as_tensors(d))
            assert bool(info["accepted"].all())
    assert_host_state(st, states[-1], 1e-4, "final state")
    assert tstep.counts == {"draws": N_TRANS, "gradients": 2 * N_TRANS,
                            "syncs": 0}


def test_gather_batch_shapes_and_no_copy():
    """Per-chain indices gather ``(c, B, ...)``; shared indices gather
    ``(B, ...)`` once and expand it to ``(c, B, ...)`` without a copy
    (stride 0 on the chain axis); a dict keeps its keys."""
    X, y = torch.from_numpy(_X), torch.from_numpy(_Y)
    idx = torch.randint(0, N, (C, B))
    Xb, yb = tsgld.gather_batch((X, y), idx, C)
    assert Xb.shape == (C, B, D) and yb.shape == (C, B)
    torch.testing.assert_close(Xb[3, 5], X[idx[3, 5]])
    got = tsgld.gather_batch({"X": X, "y": y}, idx[0], C)
    assert got["X"].shape == (C, B, D) and got["X"].stride(0) == 0
    assert torch.equal(got["y"][7], y[idx[0]])


def _zero_lik(theta, batch):
    return 0.0 * batch.sum(dim=(1, 2)) + 0.0 * theta.sum(-1)


def test_full_batch_ula_matches_exact_stationary_variance():
    """``tests/test_sgld.py``'s ULA anchor at a smaller size: on N(0, 1)
    with h = 0.5 the stationary variance is exactly 1 / (1 - h / 4) =
    8/7."""
    h = 0.5
    out = mcmc_tpu_torch.sgld(
        np.zeros(1), lambda x: -0.5 * (x * x).sum(-1), _zero_lik,
        np.zeros((4, 1)), mcmc_tpu_torch.SGLDSettings(
            step_size=h, batch_size=4, n_burnin_draws=200, n_keep_draws=1500),
        n_chains=64, key=0, device="cpu")
    d = out.draws.double()
    assert float(out.accept_rate.mean()) == 1.0
    assert float(d.var()) == pytest.approx(1.0 / (1.0 - h / 4.0), rel=0.04)
    assert abs(float(d.mean())) < 0.03


def test_sghmc_matches_exact_lyapunov_variance():
    """``tests/test_sgld.py::test_sghmc_matches_exact_lyapunov_variance``
    at a smaller size: full-batch SGHMC on N(0, 1) at eta 0.3, alpha 0.8
    has the exact discrete-Lyapunov variance 1.1429 (not 1), in both
    minibatch modes."""
    eta, alpha = 0.3, 0.8
    expected = _lyapunov_var_x(eta, alpha)
    assert abs(expected - 1.0) > 0.02
    for mb in ("per-chain", "shared"):
        out = mcmc_tpu_torch.sghmc(
            np.zeros(1), lambda x: -0.5 * (x * x).sum(-1), _zero_lik,
            np.zeros((4, 1)), mcmc_tpu_torch.SGHMCSettings(
                step_size=eta, friction_alpha=alpha, batch_size=4,
                n_burnin_draws=200, n_keep_draws=1500),
            n_chains=64, key=0, device="cpu", minibatch=mb)
        d = out.draws.double()
        assert float(out.accept_rate.mean()) == 1.0
        assert float(d.var()) == pytest.approx(expected, rel=0.05), mb
        assert abs(float(d.mean())) < 0.04, mb


def test_validation_errors_match_jax():
    """The JAX package's validation errors: ``minibatch``, the batch size,
    the leading observation axis, a rank-0 leaf, ``log_lik``,
    ``adapt_precond`` and SGHMC's friction and ``beta_hat``; and a finite
    but exploding update is rejected in place."""
    lk = lambda x: -0.5 * (x * x).sum(-1)
    data = np.zeros((8, 1))
    s = mcmc_tpu_torch.SGLDSettings(batch_size=4, n_burnin_draws=2,
                                    n_keep_draws=2)
    for fn in (mcmc_tpu_torch.sgld, mcmc_tpu_torch.sghmc):
        with pytest.raises(ValueError, match="minibatch must be"):
            fn(np.zeros(1), lk, _zero_lik, data, minibatch="global",
               device="cpu")
    with pytest.raises(ValueError, match="batch_size"):
        mcmc_tpu_torch.sgld(np.zeros(2), lk, _zero_lik, np.zeros((2, 1)),
                            mcmc_tpu_torch.SGLDSettings(batch_size=4),
                            device="cpu")
    with pytest.raises(ValueError, match="leading observation axis"):
        mcmc_tpu_torch.sgld(np.zeros(2), lk, _zero_lik,
                            (np.zeros((8, 1)), np.zeros((6,))),
                            mcmc_tpu_torch.SGLDSettings(batch_size=2),
                            device="cpu")
    with pytest.raises(ValueError, match="rank-0"):
        mcmc_tpu_torch.sgld(np.zeros(2), lk, _zero_lik,
                            (np.zeros((8, 1)), np.float32(1.0)), s,
                            device="cpu")
    with pytest.raises(TypeError, match="log_lik"):
        mcmc_tpu_torch.sgld(np.zeros(2), lk, None, data, s, device="cpu")
    with pytest.raises(ValueError, match="adapt_precond"):
        mcmc_tpu_torch.sgld(np.zeros(2), lk, _zero_lik, data, s,
                            adapt_precond="adam", device="cpu")
    with pytest.raises(ValueError, match="friction_alpha"):
        mcmc_tpu_torch.sghmc(np.zeros(1), lk, _zero_lik, data,
                             mcmc_tpu_torch.SGHMCSettings(
                                 friction_alpha=1.5, batch_size=2),
                             device="cpu")
    with pytest.raises(ValueError, match="beta_hat"):
        mcmc_tpu_torch.sghmc(np.zeros(1), lk, _zero_lik, data,
                             mcmc_tpu_torch.SGHMCSettings(
                                 friction_alpha=0.1, beta_hat=0.2,
                                 batch_size=2), device="cpu")
    pole = lambda x: torch.log(x.abs()).sum(-1)
    out = mcmc_tpu_torch.sgld(
        np.full(1, 1e-30, np.float32), pole, _zero_lik, np.zeros((2, 1)),
        mcmc_tpu_torch.SGLDSettings(step_size=1e30, batch_size=2,
                                    n_burnin_draws=0, n_keep_draws=20),
        key=9, device="cpu")
    assert bool(torch.isfinite(out.draws).all())
    assert float(out.accept_rate) < 1.0
