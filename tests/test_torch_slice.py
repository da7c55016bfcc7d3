"""The ported slice as a whole: the port's ``fused_glm_hmc`` on the CPU
against the JAX package's ``fused_glm_hmc`` (Pallas in interpret mode),
with the settings of tests/test_fused_logreg.py:313-328, on the same numpy
data; and the port's imports."""

import subprocess
import sys

import jax
import numpy as np
import torch

import mcmc_tpu_torch
from mcmc_tpu.ops import fused_glm_hmc as jax_fused_glm_hmc
from mcmc_tpu_torch import convert
from mcmc_tpu_torch.models import make_logistic_regression_data

D, N = 10, 64
SETTINGS = dict(step_size=0.08, n_leap=5, n_chains=16, n_burnin_draws=300,
                n_keep_draws=400, block_chains=8)


def _data():
    X, y, _ = make_logistic_regression_data(2, N, D)
    return X.numpy(), y.numpy()


def test_fused_glm_hmc_matches_jax():
    """Shape, acceptance and posterior mean. The generators differ, so the
    mean check is distributional: atol 0.3 as in the JAX package's own
    test, which bounds the Monte-Carlo error of two 16-chain runs here."""
    X, y = _data()
    ref = jax_fused_glm_hmc(X, y, key=jax.random.PRNGKey(3), interpret=True,
                            **SETTINGS)
    out = mcmc_tpu_torch.fused_glm_hmc(*convert.glm_data(X, y), key=3,
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
    X, y = convert.glm_data(*_data())
    kw = dict(SETTINGS, n_burnin_draws=20, n_keep_draws=30)
    a = mcmc_tpu_torch.fused_glm_hmc(X, y, key=7, **kw)
    b = mcmc_tpu_torch.fused_glm_hmc(X, y, key=torch.Generator().manual_seed(7),
                                     **kw)
    c = mcmc_tpu_torch.fused_glm_hmc(X, y, key=8, **kw)
    assert torch.equal(a.draws, b.draws)
    assert torch.equal(a.n_accept_draws, b.n_accept_draws)
    assert not torch.equal(a.draws, c.draws)


def test_port_imports_no_jax():
    """Importing the port and every module of it loads neither JAX nor the
    JAX package, and needs no CUDA."""
    code = (
        "import sys, pkgutil, importlib, mcmc_tpu_torch\n"
        "for m in pkgutil.walk_packages(mcmc_tpu_torch.__path__, "
        "'mcmc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'mcmc_tpu' or m.startswith('mcmc_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
