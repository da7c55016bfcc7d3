"""The port's multi-process sampling (``mcmc_tpu_torch.parallel``) held
against the JAX package's sharded tests.

Two Gloo jobs, one of 2 ranks and one of 4, run every check of
``tests/torch_mesh_worker.py`` (no JAX in the ranks); the jobs are started
once per test run, shared by the xdist workers through a locked cache
directory, while this process runs the JAX references on its 8 virtual
devices (``tests/conftest.py``). Where the random streams differ the
comparisons are distributional: a mean within 5 combined Monte-Carlo
standard errors (batch means) of JAX's, or the JAX test's own bounds; the
fed sweeps, the data-parallel value and gradient, the pooled adaptation and
the checkpoints are exact. Every rank must report the same global
statistics.
"""

import fcntl
import json
import math
import os
import pathlib
import tempfile

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import mcmc_tpu
from mcmc_tpu import models
from mcmc_tpu.parallel import make_mesh

from mcmc_tpu_torch.parallel import launch_local
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for every test here: the tests run in several
    worker processes at once, and torch's default of a thread per core
    oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WORKER = str(pathlib.Path(__file__).with_name("torch_mesh_worker.py"))


def _cache_dir():
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID") or f"pid{os.getpid()}"
    d = pathlib.Path(tempfile.gettempdir()) / f"mcmc_torch_mesh_{uid}"
    d.mkdir(exist_ok=True)
    return d


def _write_data(d):
    """The JAX tests' inputs, made by JAX, for the ranks to read."""
    path = d / "data.npz"
    if path.exists():
        return
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    X = jax.random.normal(k1, (4096, 8))
    beta_true = jax.random.normal(k2, (8,))
    p = jax.nn.sigmoid(X @ beta_true)
    y = (jax.random.uniform(k3, (4096,)) < p).astype(jnp.float32)
    betas = jnp.stack([0.3 * jax.random.normal(jax.random.PRNGKey(s), (8,))
                       for s in range(3)])
    tmp = d / "data.tmp.npz"
    np.savez(tmp,
             x31=np.asarray(2.0 + jax.random.normal(jax.random.PRNGKey(31),
                                                    (100,))),
             x1=np.asarray(2.0 + jax.random.normal(jax.random.PRNGKey(1),
                                                   (100,))),
             dp_X=np.asarray(X), dp_y=np.asarray(y),
             dp_betas=np.asarray(betas))
    os.replace(tmp, path)


def _shared(name, run):
    """``run(dir)``'s JSON result, computed once per test run under a lock
    and read back by every other xdist worker."""
    d = _cache_dir()
    with open(d / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            out = d / f"{name}.json"
            if not out.exists():
                out.write_text(json.dumps(run(d)))
            return json.loads(out.read_text())
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _jax_references(d):
    """The JAX package's runs of the sharded tests' cases, on its virtual
    devices: the data-parallel value and gradient on its (2, 4) grid, and
    sharded DE, stretch, SMC and four-rung PT."""
    data = np.load(d / "data.npz")
    X, y = jnp.asarray(data["dp_X"]), jnp.asarray(data["dp_y"])

    def kernel_of_data(beta, dat):
        # the worker's kernel: a standard-normal prior, constant included
        Xa, ya = dat
        eta = Xa @ beta
        return jnp.sum(ya * eta - jax.nn.softplus(eta)) \
            - 0.5 * jnp.sum(beta ** 2) - 0.5 * beta.shape[-1] \
            * math.log(2 * math.pi)

    from mcmc_tpu import parallel
    from mcmc_tpu.parallel import pt_sharded
    lk = parallel.data_parallel_kernel(kernel_of_data, (X, y),
                                       parallel.make_grid_mesh(2, 4))
    f = jax.jit(jax.value_and_grad(lk))
    vals, grads = zip(*[f(b) for b in jnp.asarray(data["dp_betas"])])
    out = {"dp_value": np.asarray(vals).tolist(),
           "dp_grad": np.asarray(grads).tolist()}
    mesh8 = make_mesh(8)
    de = mcmc_tpu.de(jnp.array([1.0]),
                     models.gaussian_mean_model(jnp.asarray(data["x31"]),
                                                sigma=1.0),
                     mcmc_tpu.DESettings(n_pop=64, n_burnin_draws=400,
                                         n_keep_draws=400),
                     key=jax.random.PRNGKey(0), mesh=mesh8)
    out["de"] = _jax_stats(de.draws)
    out["de_rate"] = int(de.n_accept_draws) / (400 * 64)
    st = mcmc_tpu.stretch(jnp.array([1.0]),
                          models.gaussian_mean_model(jnp.asarray(data["x1"])),
                          mcmc_tpu.StretchSettings(n_walkers=64,
                                                   n_burnin_draws=200,
                                                   n_keep_draws=400),
                          key=jax.random.PRNGKey(8), mesh=mesh8)
    out["stretch"] = _jax_stats(st.draws)
    out["stretch_acc"] = float(
        st.diagnostics["accept_rate_per_walker"].mean())
    sm = mcmc_tpu.smc(jnp.zeros(3),
                      lambda v: -0.5 * jnp.sum((v - 1.0) ** 2) / 1.69,
                      mcmc_tpu.SMCSettings(n_particles=4096, init_scale=3.0),
                      key=jax.random.PRNGKey(0), mesh=mesh8)
    out["smc_mean"] = np.asarray(sm.draws).mean(0).tolist()
    out["smc_log_z"] = float(sm.diagnostics["log_z"])

    def bimodal(v):
        return jnp.logaddexp(-0.5 * jnp.sum((v - 2.0) ** 2),
                             -0.5 * jnp.sum((v + 2.0) ** 2))
    pt = pt_sharded(jnp.zeros(2), bimodal,
                    mcmc_tpu.PTSettings(n_burnin_draws=100, n_keep_draws=500,
                                        n_temps=4, max_temp=50.0,
                                        inner="hmc", step_size=0.25,
                                        n_leap_steps=5),
                    mesh=make_mesh(4), key=jax.random.PRNGKey(0))
    out["pt_swap"] = np.asarray(
        pt.diagnostics["swap_accept_rate"]).tolist()
    return out


def _run_all(d):
    """Both jobs and the kill-and-resume sequence, started together in
    threads while this thread makes the JAX references."""
    import concurrent.futures as cf
    import shutil
    _write_data(d)
    crash = d / "crash"
    crash.mkdir(exist_ok=True)
    shutil.copy(d / "data.npz", crash / "data.npz")

    def kill_resume():
        try:
            launch_local(2, [WORKER, "crash:2", str(crash), "run"],
                         timeout_s=300)
            killed = None
        except RuntimeError as e:
            killed = str(e)[:200]
        # a copy resumes in this process without a mesh: another mesh size
        shutil.copytree(crash / "run", crash / "single")
        import torch
        import mcmc_tpu_torch as mt
        single = mt.nuts(torch.zeros(3), lambda v: -0.5 * (v * v).sum(-1),
                         mt.NUTSSettings(n_burnin_draws=50, n_keep_draws=100,
                                         n_adapt_draws=50),
                         n_chains=8, key=30, device="cpu",
                         checkpoint_dir=str(crash / "single"),
                         checkpoint_every=25).draws
        resumed = launch_local(2, [WORKER, "crash:0", str(crash), "run"],
                               timeout_s=300)
        clean = launch_local(2, [WORKER, "crash:0", str(crash), "clean"],
                             timeout_s=300)
        return {"killed": killed, "resumed": resumed, "clean": clean,
                "single": {"draws": single.tolist(),
                           "finite": bool(torch.isfinite(single).all())}}

    with cf.ThreadPoolExecutor(3) as pool:
        futs = {"job2": pool.submit(launch_local, 2, [WORKER, "2", str(d)],
                                    timeout_s=600),
                "job4": pool.submit(launch_local, 4, [WORKER, "4", str(d)],
                                    timeout_s=600),
                "kill": pool.submit(kill_resume)}
        out = {"jax": _jax_references(d)}
        out.update({k: f.result() for k, f in futs.items()})
    return out


@pytest.fixture(scope="module")
def results():
    return _shared("results", _run_all)


@pytest.fixture(scope="module")
def job2(results):
    return results["job2"]


@pytest.fixture(scope="module")
def job4(results):
    return results["job4"]


def _close(port, ref, what, k=5.0):
    """Means within ``k`` combined standard errors."""
    se = math.hypot(port["se"], ref["se"])
    assert abs(port["mean"] - ref["mean"]) < k * se, (what, port, ref)


def _jax_stats(d):
    d = np.asarray(d, np.float64)
    b = d.reshape(20, -1).mean(1)
    return {"mean": float(d.mean()), "se": float(b.std(ddof=1)
                                                 / math.sqrt(20))}


@pytest.mark.parametrize("n", [2, 4])
def test_ranks_report_identical_global_statistics(n, job2, job4):
    ranks = job2 if n == 2 else job4
    assert len(ranks) == n
    drop = ("rank", "seconds", "collectives")
    first = {k: v for k, v in ranks[0].items() if k not in drop}
    for r in ranks[1:]:
        assert {k: v for k, v in r.items() if k not in drop} == first


@pytest.mark.parametrize("n", [2, 4])
def test_fed_sharded_sweeps_bit_equal(n, job2, job4):
    """Sharded DE and stretch sweeps fed the unsharded sweeps' draws row for
    row equal them bit for bit (three generations, a DE jump among them)."""
    r = (job2 if n == 2 else job4)[0]
    assert r["de_fed_equal"] and r["stretch_fed_equal"]


def _unsharded_value_and_grad():
    """The worker's kernel on the whole dataset in this process."""
    data = np.load(_cache_dir() / "data.npz")
    X, y = torch.from_numpy(data["dp_X"]), torch.from_numpy(data["dp_y"])
    b = torch.from_numpy(data["dp_betas"]).requires_grad_(True)
    eta = b @ X.T
    v = (y * eta - torch.nn.functional.softplus(eta)).sum(-1) \
        - 0.5 * (b * b).sum(-1) - 0.5 * b.shape[-1] * math.log(2 * math.pi)
    (g,) = torch.autograd.grad(v.sum(), b)
    return v.detach().numpy(), g.numpy()


@pytest.mark.parametrize("n", [2, 4])
def test_data_parallel_value_and_grad(n, job2, job4, results):
    """The (1, 2) and (2, 2) grids' value and gradient (the prior counted
    once) against JAX's and the port's unsharded kernel, rtol 2e-5."""
    r = (job2 if n == 2 else job4)[0]
    v, g = _unsharded_value_and_grad()
    for ref_v, ref_g in ((results["jax"]["dp_value"],
                          results["jax"]["dp_grad"]), (v, g)):
        np.testing.assert_allclose(r["dp_value"], ref_v, rtol=2e-5)
        np.testing.assert_allclose(r["dp_grad"], ref_g, rtol=2e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_data_parallel_check_catches_a_prior_per_rank(n, job2, job4):
    """The check above has teeth: the same all-reduced sum without the
    prior's correction (each of the two data ranks keeping its prior)
    misses the unsharded value and gradient by more than ten times rtol
    2e-5."""
    r = (job2 if n == 2 else job4)[0]
    v, g = _unsharded_value_and_grad()
    bad_v = np.asarray(r["dp_prior_per_rank_value"])
    bad_g = np.asarray(r["dp_prior_per_rank_grad"])
    assert (np.abs(bad_v - v) > 10 * 2e-5 * np.abs(v)).all()
    assert (np.abs(bad_g - g) > 10 * 2e-5 * np.abs(g)).any(axis=1).all()


def test_chain_sharded_hmc(job2):
    """``tests/test_multiprocess.py:249``'s case: N(1.5, 1), 32 chains over
    two ranks, at that test's bounds."""
    r = job2[0]["hmc"]
    assert r["shape"] == [300, 32, 3]
    assert abs(r["mean"] - 1.5) < 0.1 and abs(r["var"] - 1.0) < 0.3
    assert 0.3 < r["acc"] < 1.0


def test_pooled_nuts_identical_on_every_rank(job2):
    """Pooled dual averaging and mass adaptation over two ranks: every
    chain on every rank ends with the same step size and inverse mass."""
    r = job2[0]["nuts"]
    assert len(set(r["step_size"])) == 1
    assert all(m == r["inv_mass"][0] for m in r["inv_mass"])
    assert abs(r["mean"] - 1.5) < 5 * r["se"] + 0.05


def test_population_sharded_de(job2, results):
    """``tests/test_rmhmc_de_aees.py:122``'s case against JAX's sharded run."""
    r = job2[0]["de"]
    ref, ref_rate = results["jax"]["de"], results["jax"]["de_rate"]
    assert r["shape"] == [400, 64, 1]
    _close(r, ref, "de")
    assert 0.05 < r["rate"] < 0.95 and abs(r["rate"] - ref_rate) < 0.1


def test_walker_sharded_stretch(job2, results):
    """``tests/test_stretch.py:142``'s case against JAX's sharded run."""
    r = job2[0]["stretch"]
    ref, ref_acc = results["jax"]["stretch"], results["jax"]["stretch_acc"]
    assert r["shape"] == [400, 64, 1]
    _close(r, ref, "stretch")
    assert 0.3 < r["acc"] < 0.95 and abs(r["acc"] - ref_acc) < 0.05


def test_particle_sharded_smc(job2, results):
    """``tests/test_smc.py:140``'s case: the whole cloud's moments and log Z
    against the exact values at that test's bounds, and against JAX's
    sharded run within the particles' standard error."""
    r = job2[0]["smc"]
    mean, log_z = results["jax"]["smc_mean"], results["jax"]["smc_log_z"]
    exact = 0.5 * 3 * np.log(2 * np.pi * 1.69)
    assert r["completed"]
    np.testing.assert_allclose(r["mean"], 1.0, atol=0.08)
    np.testing.assert_allclose(r["var"], 1.69, rtol=0.10)
    assert abs(r["log_z"] - exact) < 0.12
    np.testing.assert_allclose(r["mean"], mean,
                               atol=5 * math.sqrt(2 * 1.69 / 4096))
    assert abs(r["log_z"] - log_z) < 0.12


def test_two_rung_ladders(job2):
    """``tests/test_multiprocess.py:181``'s ladders over two ranks: the
    cold chain of ladder-sharded PT and AEES visits both modes."""
    pt = job2[0]["pt_sharded"]
    assert pt["shape"] == [600, 2]
    assert 0.15 < pt["frac_hi"] < 0.85 and abs(pt["mean"]) < 1.2
    assert all(0.0 < r <= 1.0 for r in pt["swap"])
    ae = job2[0]["aees_sharded"]
    assert ae["shape"] == [800, 2]
    assert 0.1 < ae["frac_hi"] < 0.9 and abs(ae["mean"]) < 1.5


def test_four_rung_pt(job4, results):
    """``tests/test_pt.py:187``'s case on four rungs: mode balance, and the
    swap-acceptance profile against JAX's sharded ladder (that test's
    atol 0.12)."""
    r = job4[0]["pt_sharded"]
    assert 0.35 < r["frac"] < 0.65
    np.testing.assert_allclose(r["swap"], results["jax"]["pt_swap"],
                               atol=0.12)


@pytest.mark.parametrize("name", ["aees_sharded", "aees_capped"])
def test_four_rung_aees(name, job4):
    """``tests/test_rmhmc_de_aees.py:140`` and ``:240``'s cases on four
    rungs (full history, and a 256-slot reservoir): both modes, each mode's
    mean at those tests' atol 0.3."""
    r = job4[0][name]
    assert r["n_pos"] > 100 and r["n_neg"] > 100
    np.testing.assert_allclose(r["pos_mean"], [2.0, 2.0], atol=0.3)
    np.testing.assert_allclose(r["neg_mean"], [-2.0, -2.0], atol=0.3)


def test_aees_replicas_over_ranks(job4):
    """``tests/test_rmhmc_de_aees.py:268``: eight whole ladders over four
    ranks cover both modes."""
    r = job4[0]["aees_runs"]
    assert r["shape"] == [400, 8, 2]
    assert r["frac_hi"] > 0.1 and r["frac_lo"] > 0.1


def test_hmc_on_grid(job4):
    """``tests/test_data_parallel.py``: HMC on the (2, 2) grid runs, accepts
    and stays near the posterior mode."""
    r = job4[0]["hmc_grid"]
    assert 0.5 < r["acc"] <= 1.0
    assert all(np.isfinite(r["mean"])) and max(r["var"]) < 0.01


def test_pooled_chees_identical_on_every_rank(job4):
    r = job4[0]["chees"]
    assert r["step_size"] is None or all(
        len(set(row)) == 1 for row in r["step_size"])
    assert abs(r["mean"]) < 5 * r["se"] + 0.05


@pytest.mark.parametrize("case,check", [
    # tests/test_mclmc.py:186
    ("mclmc", lambda r: (np.allclose(r["std"], [1.0, 2.0], rtol=0.08)
                         and np.allclose(r["mean"], 0.0, atol=0.15)
                         and r["rhat"] < 1.05)),
    # tests/test_gibbs.py:235 (N(0, I), distributional here)
    ("gibbs", lambda r: abs(r["mean"]) < 5 * r["se"] + 0.05
     and abs(r["var"] - 1.0) < 0.25),
    # tests/test_elliptical.py:158
    ("ellipse", lambda r: abs(r["mean"] - 0.5) < 0.05
     and abs(r["var"] - 0.5) < 0.075),
    # tests/test_thin.py:82
    ("mala_thin", lambda r: r["shape"] == [200, 16, 1]
     and abs(r["mean"] - 2.0) < 0.2),
    # tests/test_demcz.py:206
    ("demcz", lambda r: r["shape"] == [1000, 48, 1]
     and abs(r["mean"] - 2.0) < 0.1),
])
def test_chain_sharded_samplers(case, check, job2):
    assert check(job2[0][case]), job2[0][case]


def test_sharded_library_pt_and_evidence(job2):
    """PT's pooled ladder adaptation and the evidence ladder's pooled step
    sizes over two ranks: one descending ladder ending at T = 1; log Z of a
    N(0, I) prior with a N(1, I) likelihood in two dimensions (exact
    log(1/2) - 1/2) within 5 standard errors plus 0.1."""
    r = job2[0]
    assert r["pt_ladders"]["shape"] == [200, 8, 2]
    t = r["pt_ladders"]["temperatures"]
    assert t[-1] == 1.0 and all(a > b for a, b in zip(t, t[1:]))
    exact = math.log(0.5) - 0.5
    ev = r["evidence"]
    assert abs(ev["log_z"] - exact) < 5 * ev["se"] + 0.1


def _sghmc_variance(eta, alpha):
    """Exact stationary Var(x) of full-batch SGHMC on N(0, 1): the discrete
    Lyapunov equation of ``tests/test_sgld.py::_lyapunov_var_x``, solved
    directly."""
    A = np.array([[1.0 - eta, 1.0 - alpha], [-eta, 1.0 - alpha]])
    Q = 2.0 * alpha * eta * np.ones((2, 2))
    return np.linalg.solve(np.eye(4) - np.kron(A, A), Q.ravel())[0]


@pytest.mark.parametrize("name", ["ghmc", "mams", "rwmh", "rmhmc",
                                  "barker", "mmala", "slice_sampler",
                                  "sghmc"])
def test_other_entry_points_over_two_ranks(name, job2):
    """The chain entry points the cases above do not run, over two ranks
    (pooled adaptation on where they have it): the global shape, finite
    draws, the mean within 5 standard errors (batch means) plus 0.05 of
    the target's and the variance within 0.25; a pooled adapted parameter
    (preconditioner, slice width) is the same on all eight chains, so both ranks' blocks were reduced
    together (each rank's own pool would give two values), and every rank
    reports the same draws' moments and adapted parameters."""
    r = job2[0]["entry_points"][name]
    assert r["shape"] == ([400, 8, 1] if name == "sghmc" else [400, 8, 2])
    assert r["finite"]
    assert abs(r["mean"]) < 5 * r["se"] + 0.05, r
    var = _sghmc_variance(0.3, 0.8) if name == "sghmc" else 1.0
    assert abs(r["var"] - var) < 0.25, r
    # pooled_adaptation pools the preconditioner and the slice width; the
    # step sizes adapt per chain, as in the JAX package
    pooled = {"rwmh": ["proposal_var"], "barker": ["precond_var"],
              "slice_sampler": ["adapted_w"]}.get(name, [])
    for k in pooled:
        assert all(v == r["adapted"][k][0] for v in r["adapted"][k]), k
    for k, v in r["adapted"].items():
        assert np.isfinite(v).all() and (np.asarray(v) > 0).all(), k
    assert all(other["entry_points"][name] == r for other in job2[1:])


def test_fit_over_two_ranks(job2):
    """``fit`` forwards ``mesh=`` to its sampler: NUTS on N(1.5, 1) with 4
    chains a rank, within 5 standard errors (batch means) of 1.5."""
    r = job2[0]["fit"]
    assert r["shape"] == [60, 8, 3]
    assert abs(r["mean"] - 1.5) < 5 * r["se"] + 0.05


def test_shared_minibatch_sgld(job2):
    r = job2[0]["sgld"]
    assert r["shape"] == [300, 8, 1] and r["acc"] == 1.0
    assert abs(r["mean"] - 2.0) < 0.3


def test_checkpointed_mesh_run_equals_in_memory(job2):
    assert job2[0]["ckpt_equal"]


def test_dryrun_paths_on_two_ranks(job2):
    """``entry.dryrun_multichip``'s rank body ran all eleven paths."""
    assert job2[0]["dryrun"] == sorted(
        ["nuts", "de", "aees_sharded", "chees", "pt_sharded", "smc",
         "stretch", "hmc_grid", "mclmc", "evidence", "gibbs"])


def test_killed_two_rank_run_resumes_bit_equal(results):
    """``tests/test_checkpoint_runtime.py:301``'s gate on two ranks: a
    checkpointed NUTS run whose ranks die after two durable chunks resumes
    to draws bit-identical to an uninterrupted two-rank run; a copy of the
    killed run's directory resumes in one process without a mesh."""
    k = results["kill"]
    assert k["killed"] is not None and "exited with 17" in k["killed"]
    a = np.asarray(k["resumed"][0]["draws"])
    assert a.shape == (100, 8, 3)
    np.testing.assert_array_equal(a, np.asarray(k["clean"][0]["draws"]))
    np.testing.assert_array_equal(a, np.asarray(k["resumed"][1]["draws"]))
    # resumed on another mesh size (one process, no mesh): the 50 kept
    # draws made durable before the kill are the two-rank run's, the rest
    # drawn afresh from the run's seed and progress
    s = np.asarray(k["single"]["draws"])
    assert s.shape == (100, 8, 3) and k["single"]["finite"]
    np.testing.assert_array_equal(s[:50], a[:50])
    assert not np.array_equal(s[50:], a[50:])
    assert abs(s[50:].mean()) < 0.5
