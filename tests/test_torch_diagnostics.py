"""The PyTorch port's R-hat and ESS diagnostics against the JAX package's on
the same numpy draws.

Tolerance rtol 1e-4: both sides compute in f32 by the same formulas; the
FFT implementations and summation orders differ in the last bits, and the
Geyer truncation is a sign test on sums that sit well away from zero for
these draws."""

import numpy as np
import pytest
import torch

from mcmc_tpu import diagnostics as jd
from mcmc_tpu_torch import diagnostics as td


def _draws(seed=0, n=200, m=4, dim=3):
    """AR(1) chains with per-dimension correlation and offset, plus one
    chain shifted so that R-hat is away from 1."""
    rng = np.random.default_rng(seed)
    phi = np.array([0.2, 0.6, 0.9])
    x = np.zeros((n, m, dim))
    x[0] = rng.standard_normal((m, dim))
    for t in range(1, n):
        x[t] = phi * x[t - 1] + np.sqrt(1 - phi ** 2) * rng.standard_normal((m, dim))
    x[:, 0] += 0.3
    return x.astype(np.float32)


CASES = {
    "split_rhat": lambda d, x: d.split_rhat(x),
    "ess": lambda d, x: d.ess(x),
    "ess_chain_chunk": lambda d, x: d.ess(x, chain_chunk=2),
    "rank_normalized_rhat": lambda d, x: d.rank_normalized_rhat(x),
    "bulk_ess": lambda d, x: d.bulk_ess(x),
    "tail_ess": lambda d, x: d.tail_ess(x),
    "single_chain_ess": lambda d, x: d.ess(x[:, 0, :]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_diagnostic_matches_jax(name):
    x = _draws()
    want = np.asarray(CASES[name](jd, x))
    got = CASES[name](td, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)


def test_chain_chunk_must_divide():
    with pytest.raises(ValueError, match="divide"):
        td.ess(torch.from_numpy(_draws()), chain_chunk=3)
