"""The workflow phase's bounds, from the JAX package on the CPU.

``chip_smoke.py`` phase 17 runs the port's ``map_laplace`` (its defaults)
on the flagship posterior (logistic regression, 100 dims, 1,000 rows, prior
N(0, 10^2), the port's numpy-seeded data: ``make_logistic_regression_data(0,
1000, 100)``) and gates its ``grad_norm`` and max |mode - posterior mean| /
posterior sd against phase 9's ``hmc`` reference; and it gates |elpd_loo -
elpd_waic| on 19,200 posterior draws; and ``compare`` of the full model
against the reduced one (the first 50 columns). This script runs the JAX
package on the same numpy data: ``map_laplace`` at its defaults, an
adapted ``hmc`` as the posterior reference (32 chains, 500 + 600 draws of 8
leapfrogs), ``psis_loo`` and ``waic`` on the reference's 19,200 draws, and
the same for the reduced model, at ``COMPARE_KEYS`` reference seeds. It
prints each measured number and the bound taken from it (``TOL_FACTOR``
times it, rounded up to two significant digits; for the reduced model's
elpd_diff, its mean over the seeds and ``TOL_FACTOR`` times its largest
distance from that mean, at least one nat). From the repository root,
with JAX (it runs on the CPU; about ten minutes):

    JAX_PLATFORMS=cpu python3 scripts/jax_workflow_tolerance.py
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

N_DATA, DIM, PRIOR_SCALE, SEED = 1000, 100, 10.0, 0
REF = {"chains": 32, "warm": 500, "keep": 600, "step": 0.05, "leap": 8}
TOL_FACTOR = 3.0
REDUCED_COLS = 50
COMPARE_KEYS = (3, 4, 5)


def flagship_data():
    """``mcmc_tpu_torch.models.make_logistic_regression_data(0, 1000, 100)``
    in numpy (the same numbers, float32)."""
    rng = np.random.default_rng(SEED)
    X = rng.standard_normal((N_DATA, DIM)) / np.sqrt(DIM)
    beta_true = rng.standard_normal(DIM)
    y = rng.uniform(size=N_DATA) < 1.0 / (1.0 + np.exp(-(X @ beta_true)))
    return X.astype(np.float32), y.astype(np.float32)


def bound(x):
    tol = TOL_FACTOR * x
    digits = 1 - int(math.floor(math.log10(tol)))
    return math.ceil(tol * 10 ** digits) / 10 ** digits


def model(X, y, cols):
    """The pointwise log-likelihood and log-posterior of the logistic
    regression on the first ``cols`` columns."""
    Xj, yj = jnp.asarray(X[:, :cols]), jnp.asarray(y)

    def pointwise(b):
        eta = Xj @ b
        return yj * eta - jax.nn.softplus(eta)

    def log_post(b):
        return jnp.sum(pointwise(b)) - 0.5 * jnp.sum(b ** 2) / PRIOR_SCALE ** 2
    return pointwise, log_post


def reference(log_post, cols, seed):
    ref = mcmc_tpu.hmc(jnp.zeros(cols), log_post, mcmc_tpu.HMCSettings(
        n_burnin_draws=REF["warm"], n_keep_draws=REF["keep"],
        step_size=REF["step"], n_leap_steps=REF["leap"]),
        n_chains=REF["chains"], key=jax.random.PRNGKey(seed),
        adapt_step_size=True, adapt_mass_matrix=True)
    return ref, np.asarray(ref.draws).reshape(-1, cols)


def main():
    X, y = flagship_data()
    pointwise, log_post = model(X, y, DIM)
    lap = mcmc_tpu.map_laplace(jnp.zeros(DIM), log_post,
                               key=jax.random.PRNGKey(1))
    ref, draws = reference(log_post, DIM, COMPARE_KEYS[0])
    mean, sd = draws.mean(axis=0), draws.std(axis=0)
    mode_dev = float((np.abs(np.asarray(lap.mode) - mean) / sd).max())
    loo_of = lambda pw, d: jax.jit(mcmc_tpu.psis_loo)(
        jax.jit(jax.vmap(pw))(jnp.asarray(d)))
    ll = jax.jit(jax.vmap(pointwise))(jnp.asarray(draws))
    loo = jax.jit(mcmc_tpu.psis_loo)(ll)
    waic = jax.jit(mcmc_tpu.waic)(ll)
    loo_waic = abs(float(loo["elpd"]) - float(waic["elpd"]))
    pw_red, lp_red = model(X, y, REDUCED_COLS)
    ranks = []
    for seed in COMPARE_KEYS:
        full = loo if seed == COMPARE_KEYS[0] else loo_of(
            pointwise, reference(log_post, DIM, seed)[1])
        red = loo_of(pw_red, reference(lp_red, REDUCED_COLS, seed)[1])
        ranks.append(mcmc_tpu.compare({"full": full, "reduced": red}))
    diffs = [r[1]["elpd_diff"] for r in ranks]
    diff_mean = float(np.mean(diffs))
    diff_tol = max(bound(max(abs(v - diff_mean) for v in diffs)), 1.0)
    out = {
        "reference": {
            "draws": int(draws.shape[0]),
            "max_split_rhat": float(np.asarray(
                mcmc_tpu.diagnostics.split_rhat(ref.draws)).max()),
            "min_ess": float(np.asarray(
                mcmc_tpu.diagnostics.ess(ref.draws)).min())},
        "laplace_grad_norm": float(lap.grad_norm),
        "laplace_log_post": float(lap.log_post),
        "laplace_max_mode_dev_sd": mode_dev,
        "elpd_loo": float(loo["elpd"]), "elpd_waic": float(waic["elpd"]),
        "abs_loo_minus_waic": loo_waic,
        "max_pareto_k": float(np.asarray(loo["pareto_k"]).max()),
        "reduced_first": [r[0]["name"] for r in ranks],
        "reduced_elpd_diff": diffs,
        "reduced_se_diff": [r[1]["se_diff"] for r in ranks],
        "bounds": {"laplace_grad_norm": bound(float(lap.grad_norm)),
                   "laplace_max_mode_dev_sd": bound(mode_dev),
                   "abs_loo_minus_waic": bound(loo_waic),
                   "reduced_elpd_diff": [diff_mean, diff_tol]},
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
