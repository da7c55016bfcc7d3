"""The ``rmhmc_fisher`` row's distance from its closed-form mean, from the
JAX package on the CPU.

The suite's ``rmhmc_fisher`` row (``benchmarks/suite.py:317-330``) runs
RM-HMC with the Fisher metric on the (mu, sigma) Gaussian posterior: 1,024
chains from (2.5, 2.5), 1,500 burn-in and 4,000 kept draws, step 0.15,
3 leapfrogs and 3 fixed-point iterations of the generalized leapfrog. The
port's run of that row on the card (``chip_smoke.py`` phase 14) sits 4.6-6.0
of its MC standard errors from the posterior's closed-form mean. This
script runs the JAX package's ``rmhmc`` at the same settings on the same
data (the port's, ``2 + 2 N(0, 1)`` over 1,000 points from
``numpy.random.default_rng(0)``), once with ``n_fp_steps=3`` (the suite's)
and once with ``n_fp_steps=5`` (``RMHMCSettings``' default), and prints one
JSON line per run: each coordinate's mean, its MC standard error (sd over
sqrt(ESS)) and its distance from the closed form in those errors; also the
MC standard error from the spread of the independent chains' means (sd of
the chain means over sqrt(chains)), which does not lean on the ESS
estimator, and the distance in those.
``--float64`` runs the same in double precision (data, log-kernel and
sampler), which separates float32 rounding from the integrator's own error.
``--leap 1`` runs one leapfrog a transition, where the reference's
generalized leapfrog is reversible (its quirk, keeping the trajectory
start's tensor, acts only from the second leapfrog on); ``--keep`` sets
the kept draws, which one leapfrog needs more of for the same MC error.

The closed form, under the model's flat prior: mu's mean is the data's
mean; sigma's is E[sigma] = sqrt(S / 2) G(a - 1/2) / G(a), S the sum of
squared deviations and a = (n - 2) / 2 (the data rounded to float32 first,
as both packages hold it). From the repository root, with JAX (about a
minute a run on 8 cores):

    JAX_PLATFORMS=cpu python3 scripts/jax_rmhmc_fisher_bias.py \
        [--chains N] [--fp 3 5] [--float64] [--leap L] [--keep K]
"""

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import mcmc_tpu  # noqa: E402
from mcmc_tpu import diagnostics, models  # noqa: E402

N_DATA = 1000
ROW = {"chains": 1024, "warm": 1500, "keep": 4000, "step": 0.15, "leap": 3,
       "start": 2.5, "key": 9}


def data():
    """The (mu, sigma) rows' data as the port's card runs draw it."""
    return 2.0 + 2.0 * np.random.default_rng(0).standard_normal(N_DATA)


def exact_mean(x, dtype=jnp.float32):
    """The closed-form posterior mean of (mu, sigma) under a flat prior, on
    the data as the run holds it (rounded to ``dtype``)."""
    x = x.astype(dtype).astype(np.float64)
    S, a = float(((x - x.mean()) ** 2).sum()), (len(x) - 2) / 2.0
    e_sigma = math.sqrt(S / 2.0) * math.exp(math.lgamma(a - 0.5)
                                            - math.lgamma(a))
    return np.array([x.mean(), e_sigma])


def run(x, n_fp, chains, dtype=jnp.float32, leap=ROW["leap"],
        keep=ROW["keep"]):
    s = mcmc_tpu.RMHMCSettings(n_burnin_draws=ROW["warm"],
                               n_keep_draws=keep,
                               step_size=ROW["step"],
                               n_leap_steps=leap, n_fp_steps=n_fp)
    t0 = time.perf_counter()
    out = mcmc_tpu.rmhmc(jnp.full((2,), ROW["start"], dtype),
                         models.gaussian_mean_scale_model(
                             jnp.asarray(x, dtype)),
                         models.normal_fisher_metric(N_DATA), s,
                         n_chains=chains, key=jax.random.PRNGKey(ROW["key"]),
                         dtype=dtype)
    # float64: numpy sums a float32 (keep, chains) reduction without
    # pairwise blocking, and 4 million float32 terms of about 2 lose
    # several percent
    d = np.asarray(out.draws).astype(np.float64)
    seconds = time.perf_counter() - t0
    ess = np.asarray(diagnostics.ess(out.draws)).astype(np.float64)
    mean = d.mean(axis=(0, 1))
    mcse = d.std(axis=(0, 1)) / np.sqrt(ess)
    exact = exact_mean(x, dtype)
    z = (mean - exact) / mcse
    chain_means = d.mean(axis=0)
    mcse_chains = chain_means.std(axis=0, ddof=1) / np.sqrt(chains)
    return {"dtype": jnp.dtype(dtype).name, "n_fp_steps": n_fp,
            "chains": chains, "burnin": ROW["warm"],
            "keep": keep, "step": ROW["step"], "leap": leap,
            "mean": mean.tolist(), "exact_mean": exact.tolist(),
            "mcse": mcse.tolist(), "ess": ess.tolist(),
            "z": z.tolist(), "max_abs_z": float(np.abs(z).max()),
            "mcse_chain_means": mcse_chains.tolist(),
            "z_chain_means": ((mean - exact) / mcse_chains).tolist(),
            "accept_rate": float(np.asarray(out.n_accept_draws).mean()
                                 / keep),
            "max_rank_rhat": float(np.asarray(
                diagnostics.rank_normalized_rhat(out.draws)).max()),
            "seconds": seconds}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=ROW["chains"])
    ap.add_argument("--fp", type=int, nargs="+", default=[3, 5])
    ap.add_argument("--float64", action="store_true")
    ap.add_argument("--leap", type=int, default=ROW["leap"])
    ap.add_argument("--keep", type=int, default=ROW["keep"])
    args = ap.parse_args()
    dtype = jnp.float32
    if args.float64:
        jax.config.update("jax_enable_x64", True)
        dtype = jnp.float64
    x = data()
    for n_fp in args.fp:
        print(json.dumps({"rmhmc_fisher_jax_cpu": run(
            x, n_fp, args.chains, dtype, args.leap, args.keep)}),
              flush=True)


if __name__ == "__main__":
    main()
