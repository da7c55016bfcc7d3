"""The ported slice as a whole: the port's ``fused_glm_hmc`` on the CPU
against the JAX package's ``fused_glm_hmc`` (Pallas in interpret mode),
with the settings of tests/test_fused_logreg.py:313-328, on the same numpy
data; the device rule of the port's entry points; and the port's imports.
(``fused_gaussian_hmc`` is held against the JAX package in
tests/test_torch_fused_gaussian.py.)"""

import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import mcmc_tpu_torch
import mcmc_tpu_torch.entry
from mcmc_tpu.ops import fused_glm_hmc as jax_fused_glm_hmc
from mcmc_tpu_torch import convert
from mcmc_tpu_torch.models import make_logistic_regression_data


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for every test here: the tests run in several
    worker processes at once, and torch's default of a thread per core
    oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


D, N = 10, 64
SETTINGS = dict(step_size=0.08, n_leap=5, n_chains=16, n_burnin_draws=300,
                n_keep_draws=400, block_chains=8)


def _data():
    X, y, _ = make_logistic_regression_data(2, N, D, device="cpu")
    return X.numpy(), y.numpy()


def test_fused_glm_hmc_matches_jax():
    """Shape, acceptance and posterior mean. The generators differ, so the
    mean check is distributional: atol 0.3 as in the JAX package's own
    test, which bounds the Monte-Carlo error of two 16-chain runs here."""
    X, y = _data()
    ref = jax_fused_glm_hmc(X, y, key=jax.random.PRNGKey(3), interpret=True,
                            **SETTINGS)
    out = mcmc_tpu_torch.fused_glm_hmc(*convert.glm_data(X, y, "cpu"), key=3,
                                       **SETTINGS)
    assert out.draws.shape == (400, 16, D)
    assert torch.isfinite(out.draws).all()
    rate = float(out.diagnostics["accept_rate_per_chain"].mean())
    assert 0.5 < rate <= 1.0
    torch.testing.assert_close(out.accept_rate,
                               out.diagnostics["accept_rate_per_chain"])
    np.testing.assert_allclose(out.draws.mean(dim=(0, 1)).numpy(),
                               np.asarray(ref.draws).mean(axis=(0, 1)),
                               atol=0.3)


def test_fused_glm_hmc_same_seed_same_draws():
    """The port's RNG contract: the same seed on the same device gives
    bit-identical draws; another seed does not."""
    X, y = convert.glm_data(*_data(), "cpu")
    kw = dict(SETTINGS, n_burnin_draws=20, n_keep_draws=30)
    a = mcmc_tpu_torch.fused_glm_hmc(X, y, key=7, **kw)
    b = mcmc_tpu_torch.fused_glm_hmc(X, y, key=torch.Generator().manual_seed(7),
                                     **kw)
    c = mcmc_tpu_torch.fused_glm_hmc(X, y, key=8, **kw)
    assert torch.equal(a.draws, b.draws)
    assert torch.equal(a.n_accept_draws, b.n_accept_draws)
    assert not torch.equal(a.draws, c.draws)


def _np_data():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((N, D)).astype(np.float32),
            (rng.uniform(size=N) < 0.5).astype(np.float32))


# every entry point that makes its own tensors, called with numpy inputs
# and no device=
NO_DEVICE_CALLS = {
    "fused_glm_hmc": lambda X, y: mcmc_tpu_torch.fused_glm_hmc(
        X, y, n_chains=8, n_burnin_draws=1, n_keep_draws=1, block_chains=8),
    "fused_gaussian_hmc": lambda X, y: mcmc_tpu_torch.fused_gaussian_hmc(
        np.ones(4, np.float32), n_chains=8, n_burnin_draws=1, n_keep_draws=1,
        block_chains=8),
    "hmc": lambda X, y: mcmc_tpu_torch.hmc(
        np.zeros(D, np.float32), lambda b: -0.5 * (b * b).sum(dim=-1),
        mcmc_tpu_torch.HMCSettings(n_burnin_draws=1, n_keep_draws=1)),
    "make_fused_trajectory": lambda X, y: mcmc_tpu_torch.ops
    .make_fused_trajectory(X, y, 10.0, 0.05, 3),
    "make_fused_hmc_step": lambda X, y: mcmc_tpu_torch.ops
    .make_fused_hmc_step(X, y),
    "make_fused_trajectory_rt": lambda X, y: mcmc_tpu_torch.ops
    .make_fused_trajectory_rt(X, y, 10.0, 3),
    "make_fused_gaussian_trajectory": lambda X, y: mcmc_tpu_torch.ops
    .make_fused_gaussian_trajectory(np.ones(4, np.float32)),
    "make_fused_gaussian_hmc_step": lambda X, y: mcmc_tpu_torch.ops
    .make_fused_gaussian_hmc_step(np.ones(4, np.float32)),
    "make_logistic_regression_data": lambda X, y: mcmc_tpu_torch.models
    .make_logistic_regression_data(0, N, D),
    "ill_conditioned_gaussian": lambda X, y: mcmc_tpu_torch.models
    .ill_conditioned_gaussian(10),
    "convert.glm_data": lambda X, y: convert.glm_data(X, y),
    "nuts": lambda X, y: mcmc_tpu_torch.nuts(
        np.zeros(D, np.float32), lambda b: -0.5 * (b * b).sum(dim=-1),
        mcmc_tpu_torch.NUTSSettings(n_burnin_draws=1, n_keep_draws=1)),
    "chees": lambda X, y: mcmc_tpu_torch.chees(
        np.zeros(D, np.float32), lambda b: -0.5 * (b * b).sum(dim=-1),
        mcmc_tpu_torch.ChEESSettings(n_burnin_draws=1, n_keep_draws=1),
        n_chains=4),
    "ghmc": lambda X, y: mcmc_tpu_torch.ghmc(
        np.zeros(D, np.float32), lambda b: -0.5 * (b * b).sum(dim=-1),
        mcmc_tpu_torch.GHMCSettings(n_burnin_draws=1, n_keep_draws=1)),
    "mclmc": lambda X, y: mcmc_tpu_torch.mclmc(
        np.zeros(D, np.float32), lambda b: -0.5 * (b * b).sum(dim=-1),
        mcmc_tpu_torch.MCLMCSettings(n_burnin_draws=1, n_keep_draws=1),
        n_chains=4),
    "mams": lambda X, y: mcmc_tpu_torch.mams(
        np.zeros(D, np.float32), lambda b: -0.5 * (b * b).sum(dim=-1),
        mcmc_tpu_torch.MAMSSettings(n_burnin_draws=1, n_keep_draws=1),
        n_chains=4),
    "eight_schools_model": lambda X, y: mcmc_tpu_torch.models
    .eight_schools_model(),
    "gaussian_mean_scale_model": lambda X, y: mcmc_tpu_torch.models
    .gaussian_mean_scale_model(X[:, 0]),
    "moments_init": lambda X, y: mcmc_tpu_torch.diagnostics
    .moments_init(4, D),
    "pt": lambda X, y: mcmc_tpu_torch.pt(
        np.zeros(D, np.float32), lambda b: -0.5 * (b * b).sum(dim=-1),
        mcmc_tpu_torch.PTSettings(n_burnin_draws=1, n_keep_draws=1),
        n_chains=2),
    "aees": lambda X, y: mcmc_tpu_torch.aees(
        np.zeros(D, np.float32), lambda b: -0.5 * (b * b).sum(dim=-1),
        mcmc_tpu_torch.AEESSettings(n_initial_draws=1, n_burnin_draws=1,
                                    n_keep_draws=1)),
    "smc": lambda X, y: mcmc_tpu_torch.smc(
        np.zeros(D, np.float32), lambda b: -0.5 * (b * b).sum(dim=-1),
        mcmc_tpu_torch.SMCSettings(n_particles=16)),
    "stretch": lambda X, y: mcmc_tpu_torch.stretch(
        np.zeros(D, np.float32), lambda b: -0.5 * (b * b).sum(dim=-1),
        mcmc_tpu_torch.StretchSettings(n_walkers=2 * D, n_burnin_draws=1,
                                       n_keep_draws=1)),
    "demcz": lambda X, y: mcmc_tpu_torch.demcz(
        np.zeros(D, np.float32), lambda b: -0.5 * (b * b).sum(dim=-1),
        mcmc_tpu_torch.DEMCZSettings(n_burnin_draws=1, n_keep_draws=1)),
    "slice_sampler": lambda X, y: mcmc_tpu_torch.slice_sampler(
        np.zeros(D, np.float32), lambda b: -0.5 * (b * b).sum(dim=-1),
        mcmc_tpu_torch.SliceSettings(n_burnin_draws=1, n_keep_draws=1)),
    "elliptical_slice": lambda X, y: mcmc_tpu_torch.elliptical_slice(
        np.zeros(D, np.float32), lambda b: -0.5 * (b * b).sum(dim=-1),
        mcmc_tpu_torch.EllipticalSettings(n_burnin_draws=1, n_keep_draws=1)),
    "barker": lambda X, y: mcmc_tpu_torch.barker(
        np.zeros(D, np.float32), lambda b: -0.5 * (b * b).sum(dim=-1),
        mcmc_tpu_torch.BarkerSettings(n_burnin_draws=1, n_keep_draws=1)),
    "mmala": lambda X, y: mcmc_tpu_torch.mmala(
        np.zeros(D, np.float32), lambda b: -0.5 * (b * b).sum(dim=-1),
        lambda b: torch.eye(D).expand(b.shape[0], D, D),
        mcmc_tpu_torch.MMALASettings(n_burnin_draws=1, n_keep_draws=1)),
    "sgld": lambda X, y: mcmc_tpu_torch.sgld(
        np.zeros(D, np.float32), lambda b: -0.5 * (b * b).sum(dim=-1),
        lambda b, batch: (batch[0] @ b[:, :, None]).sum(dim=(1, 2)), (X, y),
        mcmc_tpu_torch.SGLDSettings(batch_size=4, n_burnin_draws=1,
                                    n_keep_draws=1)),
    "sghmc": lambda X, y: mcmc_tpu_torch.sghmc(
        np.zeros(D, np.float32), lambda b: -0.5 * (b * b).sum(dim=-1),
        lambda b, batch: (batch[0] @ b[:, :, None]).sum(dim=(1, 2)), (X, y),
        mcmc_tpu_torch.SGHMCSettings(batch_size=4, n_burnin_draws=1,
                                     n_keep_draws=1)),
    "gibbs": lambda X, y: mcmc_tpu_torch.gibbs(
        np.zeros(D, np.float32), lambda b: -0.5 * (b * b).sum(dim=-1),
        mcmc_tpu_torch.GibbsSettings(n_burnin_draws=1, n_keep_draws=1),
        blocks=[(list(range(D)), "rwmh")]),
    "entry": lambda X, y: mcmc_tpu_torch.entry.entry(n_chains=4),
    "rbf_kernel": lambda X, y: mcmc_tpu_torch.models.rbf_kernel(X[:, 0]),
    "poisson_regression_model": lambda X, y: mcmc_tpu_torch.models
    .poisson_regression_model(X, y),
    "fit": lambda X, y: mcmc_tpu_torch.fit(
        np.zeros(D, np.float32), lambda b: -0.5 * (b * b).sum(dim=-1),
        algorithm="chees", n_chains=4, n_warmup=1, n_draws=1),
    "sample": lambda X, y: mcmc_tpu_torch.sample(
        "hmc", np.zeros(D, np.float32), lambda b: -0.5 * (b * b).sum(dim=-1),
        mcmc_tpu_torch.HMCSettings(n_burnin_draws=1, n_keep_draws=1)),
    "map_laplace": lambda X, y: mcmc_tpu_torch.map_laplace(
        np.zeros(D, np.float32), lambda b: -0.5 * (b * b).sum(dim=-1),
        n_steps=1),
    "pathfinder": lambda X, y: mcmc_tpu_torch.pathfinder(
        np.zeros(D, np.float32), lambda b: -0.5 * (b * b).sum(dim=-1),
        n_paths=2, n_draws=10, max_iters=2),
    "ravel_model": lambda X, y: mcmc_tpu_torch.ravel_model(
        {"b": np.zeros(D, np.float32)}),
    "pointwise_log_lik": lambda X, y: mcmc_tpu_torch.pointwise_log_lik(
        X[:, :D], lambda b: b),
    "psis_loo": lambda X, y: mcmc_tpu_torch.psis_loo(X),
    "waic": lambda X, y: mcmc_tpu_torch.waic(X),
    "posterior_predictive": lambda X, y: mcmc_tpu_torch.posterior_predictive(
        X[:, :D], lambda g, b: b, 0),
    "sbc": lambda X, y: mcmc_tpu_torch.sbc(
        0, lambda g: np.zeros(1), lambda g, th: th, lambda g, d: d,
        n_sims=1, n_rank_draws=7, n_bins=8),
}


@pytest.mark.parametrize("name", list(NO_DEVICE_CALLS))
def test_no_device_means_the_card(name):
    """With numpy inputs and no ``device=`` an entry point puts its tensors
    on ``cuda``: on a machine without a card it raises torch's own error
    and does not run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the rule is checked by "
                    "chip_smoke.py there")
    X, y = _np_data()
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        NO_DEVICE_CALLS[name](X, y)


def test_resolve_device_rule():
    """Explicit device first, then the first tensor argument, then cuda."""
    from mcmc_tpu_torch.samplers._resolve import resolve_device
    t = torch.zeros(2)
    assert resolve_device("cpu", None) == torch.device("cpu")
    assert resolve_device(None, np.zeros(2), t) == torch.device("cpu")
    assert resolve_device(None, np.zeros(2)) == torch.device("cuda")
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cuda:1", t) == torch.device("cuda:1")


def test_port_imports_no_jax():
    """Importing the port and every module of it loads neither JAX nor the
    JAX package, and needs no CUDA; the tempering and ensemble entry points
    the self-tuning, latent-Gaussian, minibatch and blocked samplers
    (slice, elliptical slice, Barker, mMALA, SGLD, SGHMC, Gibbs), the
    workflow, and the evidence and approximate-inference entry points are
    among its names, and ``observability``, ``checkpoint`` and ``runtime``
    among its modules."""
    code = (
        "import sys, pkgutil, importlib, mcmc_tpu_torch\n"
        "for m in pkgutil.walk_packages(mcmc_tpu_torch.__path__, "
        "'mcmc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "for n in ('pt', 'aees', 'smc', 'stretch', 'demcz', "
        "'slice_sampler', 'elliptical_slice', 'barker', 'mmala', 'sgld', "
        "'sghmc', 'gibbs', 'fit', 'sample', 'map_laplace', 'pathfinder', "
        "'pointwise_log_lik', 'waic', 'psis_loo', 'compare', "
        "'generated_quantities', 'posterior_predictive', 'sbc', "
        "'ravel_model', 'unravel_draws', 'bounds_like', "
        "'thermo_evidence', 'EvidenceResult', 'nested_sampling', "
        "'NestedResult', 'advi', 'ADVIResult', 'svgd', 'SVGDResult'):\n"
    "    assert callable(getattr(mcmc_tpu_torch, n)), n\n"
        "for n in ('observability', 'checkpoint', 'runtime'):\n"
        "    assert hasattr(mcmc_tpu_torch, n), n\n"
    "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'mcmc_tpu' or m.startswith('mcmc_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_entry_one_flagship_transition_on_the_cpu():
    """``mcmc_tpu_torch.entry.entry``, the counterpart of the JAX package's
    driver hook: one batched HMC transition of the 100-d flagship
    posterior at 1,024 chains, here on the CPU: positions ``(1024, 100)``
    finite, accept decisions ``(1024,)``, mostly accepted at step 0.01;
    the same generator state gives the same transition."""
    from mcmc_tpu_torch.entry import (ENTRY_CHAINS, FLAGSHIP_DIM, entry)
    fn, (gen, state) = entry(device="cpu")
    snap = gen.get_state()
    pos, acc = fn(gen, state)
    assert pos.shape == (ENTRY_CHAINS, FLAGSHIP_DIM) == (1024, 100)
    assert acc.shape == (1024,) and acc.dtype == torch.bool
    assert bool(torch.isfinite(pos).all()) and float(acc.float().mean()) > 0.9
    gen.set_state(snap)
    pos2, acc2 = fn(gen, state)
    assert torch.equal(pos, pos2) and torch.equal(acc, acc2)
