"""The SGLD line's tolerance, from the JAX package on the CPU.

``chip_smoke.py`` phase 16 runs the port's ``sgld`` (shared and per-chain
minibatches) and ``sghmc`` (shared) with ``examples/sgld_logreg.py``'s
settings on a numpy-seeded tall logistic regression and gates each line's
max |posterior mean - a full-data HMC reference's mean| over the 16
coefficients. This script runs the JAX package's ``sgld`` and ``sghmc`` on
the same numpy data and settings, and its adapted ``hmc`` on the full data
as the reference (the port's line takes the same: ``SGLD_REF``), and prints
each line's max |mean difference| and the tolerance taken from them
(``TOL_FACTOR`` times the largest, rounded up to two significant
digits). From the repository root, with JAX (it runs on the
CPU; a few minutes):

    JAX_PLATFORMS=cpu python3 scripts/jax_sgld_tolerance.py
"""

import json
import math
import os
import sys

sys.path.insert(0, os.getcwd())

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import mcmc_tpu  # noqa: E402

# chip_smoke.py's SGLD_ROW and sgld_data (the same numbers)
SGLD_ROW = {"n_data": 65536, "dim": 16, "batch": 512, "step": 2e-5,
            "decay_gamma": 0.33, "decay_b": 1000.0, "chains": 32,
            "warm": 2000, "keep": 4000, "seed": 0}
REF = {"chains": 32, "warm": 500, "keep": 1000, "step": 0.005, "leap": 8}
TOL_FACTOR = 3.0


def sgld_data(seed, n_data, dim):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n_data, dim)).astype(np.float32)
    beta = (0.5 * rng.standard_normal(dim)).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-(X.astype(np.float64) @ beta)))
    y = (rng.uniform(size=n_data) < p).astype(np.float32)
    return X, y, beta


def main():
    r = SGLD_ROW
    X, y, beta = sgld_data(r["seed"], r["n_data"], r["dim"])
    Xj, yj = jnp.asarray(X), jnp.asarray(y)
    log_prior = lambda b: -0.5 * jnp.sum(b ** 2) / 100.0

    def log_lik(b, batch):
        Xb, yb = batch
        eta = Xb @ b
        return jnp.sum(yb * eta - jax.nn.softplus(eta))

    def full(b):
        eta = Xj @ b
        return jnp.sum(yj * eta - jax.nn.softplus(eta)) + log_prior(b)

    ref = mcmc_tpu.hmc(jnp.zeros(r["dim"]), full, mcmc_tpu.HMCSettings(
        n_burnin_draws=REF["warm"], n_keep_draws=REF["keep"],
        step_size=REF["step"], n_leap_steps=REF["leap"]),
        n_chains=REF["chains"], key=jax.random.PRNGKey(3),
        adapt_step_size=True, adapt_mass_matrix=True)
    ref_mean = np.asarray(ref.draws).reshape(-1, r["dim"]).mean(axis=0)
    out = {"ref_mean_minus_truth_max_abs":
           float(np.abs(ref_mean - beta).max()),
           "ref_max_split_rhat": float(np.asarray(
               mcmc_tpu.diagnostics.split_rhat(ref.draws)).max())}
    s = mcmc_tpu.SGLDSettings(
        step_size=r["step"], batch_size=r["batch"],
        n_burnin_draws=r["warm"], n_keep_draws=r["keep"],
        decay_gamma=r["decay_gamma"], decay_b=r["decay_b"])
    runs = {f"sgld_{mb}": lambda mb=mb: mcmc_tpu.sgld(
        jnp.zeros(r["dim"]), log_prior, log_lik, (Xj, yj), s,
        n_chains=r["chains"], key=jax.random.PRNGKey(1), minibatch=mb)
        for mb in ("shared", "per-chain")}
    runs["sghmc_shared"] = lambda: mcmc_tpu.sghmc(
        jnp.zeros(r["dim"]), log_prior, log_lik, (Xj, yj),
        mcmc_tpu.SGHMCSettings(batch_size=r["batch"]), n_chains=r["chains"],
        key=jax.random.PRNGKey(2), minibatch="shared")
    for name, run in runs.items():
        o = run()
        d = np.asarray(o.draws).reshape(-1, r["dim"])
        out[name] = {"max_abs_mean_diff": float(np.abs(d.mean(0)
                                                       - ref_mean).max()),
                     "finite_update_rate": float(np.asarray(
                         o.accept_rate).mean())}
    worst = max(v["max_abs_mean_diff"] for v in out.values()
                if isinstance(v, dict))
    tol = TOL_FACTOR * worst
    digits = 1 - int(math.floor(math.log10(tol)))
    out["tolerance"] = math.ceil(tol * 10 ** digits) / 10 ** digits
    print(json.dumps(out))


if __name__ == "__main__":
    main()
