"""The PyTorch port's diagnostics (R-hat and ESS, streaming moments, HDI
and ``summary``) against the JAX package's on the same numpy draws.

Tolerance rtol 1e-4: both sides compute in f32 by the same formulas; the
FFT implementations and summation orders differ in the last bits, and the
Geyer truncation is a sign test on sums that sit well away from zero for
these draws."""

import numpy as np
import pytest
import torch

from mcmc_tpu import diagnostics as jd
from mcmc_tpu_torch import diagnostics as td


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for every test here: the tests run in several
    worker processes at once, and torch's default of a thread per core
    oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    "hdi": lambda d, x: d.hdi(x),
    "hdi_50": lambda d, x: d.hdi(x, prob=0.5),
    "moments_mean": lambda d, x: d.moments_finalize(_fold(d, x))[0],
    "moments_var": lambda d, x: d.moments_finalize(_fold(d, x))[1],
    "moments_rhat": lambda d, x: d.moments_rhat(_fold(d, x)),
}


def _fold(d, x):
    """Fold every draw of ``x`` into ``d``'s streaming moments."""
    kw = {"device": "cpu"} if d is td else {}
    m = d.moments_init(x.shape[1], x.shape[2], **kw)
    for t in range(x.shape[0]):
        m = d.moments_update(m, x[t])
    return m


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


SUMMARY_KEYS = ["mean", "sd", "mcse", "rhat", "ess", "rhat_rank", "ess_bulk",
                "ess_tail", "hdi_low", "hdi_high", "q5", "q50", "q95"]


@pytest.mark.parametrize("key", SUMMARY_KEYS)
def test_summary_matches_jax(key):
    """Every key of ``summary``, with the JAX package's names."""
    x = _draws()
    want = jd.summary(x)
    got = td.summary(torch.from_numpy(x))
    assert sorted(got) == sorted(want) == sorted(SUMMARY_KEYS)
    np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                               rtol=1e-4)
