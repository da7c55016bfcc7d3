"""The evidence-and-durability phase's JAX-based bounds, from the JAX
package on the CPU.

``chip_smoke.py`` phase 18 runs the port's ``thermo_evidence`` on the
flagship posterior (logistic regression, 100 dims, 1,000 rows, the port's
numpy-seeded data ``make_logistic_regression_data(0, 1000, 100)``) split
into the normalised N(0, 10^2) prior and the Bernoulli likelihood, with
``EV_FLAGSHIP``'s ladders and draws, and gates its stepping-stone log Z
within 5 combined standard errors of the JAX package's on the same data
and settings; it runs ``advi`` (mean-field and full-rank) and ``svgd``
(256 particles) at their defaults and gates each max |mean - posterior
mean| / posterior sd against its reference. This script runs the JAX
package on the same data and settings and prints, as one JSON line:
stepping-stone and TI with their standard errors, the per-rung accept and
swap rates' minima, ADVI's and SVGD's final ELBO and max |mean -
reference mean| / reference sd against an adapted ``hmc`` reference
(``scripts/jax_workflow_tolerance.py``'s), and the bound taken from each
(``TOL_FACTOR`` times it, rounded up to two significant digits). Also the
two closed-form models of ``examples/evidence_bayes_factor.py`` (its data
drawn with numpy) with their exact log Z beside the JAX estimates. From
the repository root, with JAX (it runs on the CPU, several minutes):

    JAX_PLATFORMS=cpu python3 scripts/jax_evidence_tolerance.py
"""

import json
import math
import os
import sys

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.join(os.getcwd(), "scripts"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import mcmc_tpu  # noqa: E402
from jax_workflow_tolerance import (DIM, PRIOR_SCALE, bound,  # noqa: E402
                                    flagship_data, model, reference)

# phase 18's settings: 16 ladders of 24 rungs (EvidenceSettings' default
# ladder) with the burn-in and kept draws cut from 1000 + 1000 to 500 + 500
EV_FLAGSHIP = {"chains": 16, "n_temps": 24, "burnin": 500, "keep": 500,
               "key": 7}
# the closed-form models: 16 ladders, 24 rungs, 250 + 250 draws (phase 18
# cuts them from 800 + 800)
EV_POLY = {"chains": 16, "n_temps": 24, "burnin": 250, "keep": 250, "key": 1}
POLY_N, POLY_SIG2, POLY_PRIOR_VAR = 60, 0.25, 4.0
SVGD_PARTICLES = 256


def split_model(X, y):
    """The flagship posterior as (normalised log prior, log likelihood)."""
    Xj, yj = jnp.asarray(X), jnp.asarray(y)
    c = 0.5 * DIM * math.log(2 * math.pi * PRIOR_SCALE ** 2)

    def log_prior(b):
        return -0.5 * jnp.sum(b ** 2) / PRIOR_SCALE ** 2 - c

    def log_lik(b):
        eta = Xj @ b
        return jnp.sum(yj * eta - jax.nn.softplus(eta))
    return log_prior, log_lik


def poly_data():
    """``examples/evidence_bayes_factor.py``'s data, drawn with numpy: n 60,
    y = 0.5 + 1.2 x + 0.8 x^2 + 0.5 N(0, 1)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(POLY_N)
    y = 0.5 + 1.2 * x + 0.8 * x ** 2 + 0.5 * rng.standard_normal(POLY_N)
    return x.astype(np.float32), y.astype(np.float32)


def poly_exact_log_z(x, y, degree):
    """y ~ N(0, sig2 I + prior_var F F^T), F the powers of x."""
    F = np.stack([x.astype(np.float64) ** p for p in range(degree + 1)], 1)
    cov = POLY_SIG2 * np.eye(len(x)) + POLY_PRIOR_VAR * F @ F.T
    _, logdet = np.linalg.slogdet(cov)
    yv = y.astype(np.float64)
    return float(-0.5 * (len(x) * math.log(2 * math.pi) + logdet
                         + yv @ np.linalg.solve(cov, yv)))


def evidence(d, log_prior, log_lik, cfg):
    s = mcmc_tpu.AlgoSettings(evidence_settings=mcmc_tpu.EvidenceSettings(
        n_burnin_draws=cfg["burnin"], n_keep_draws=cfg["keep"],
        n_temps=cfg["n_temps"]))
    r = mcmc_tpu.thermo_evidence(jnp.zeros(d), log_prior, log_lik, s,
                                 n_chains=cfg["chains"],
                                 key=jax.random.PRNGKey(cfg["key"]))
    return {"ss": float(r.log_z), "ss_se": float(r.log_z_se),
            "ti": float(r.log_z_ti), "ti_se": float(r.log_z_ti_se),
            "min_accept": float(np.asarray(r.accept_rate).min()),
            "min_swap": float(np.asarray(r.swap_accept_rate).min())}


def main():
    X, y = flagship_data()
    pointwise, log_post = model(X, y, DIM)
    log_prior, log_lik = split_model(X, y)
    ev = evidence(DIM, log_prior, log_lik, EV_FLAGSHIP)
    print(json.dumps({"flagship_evidence": ev}), flush=True)

    ref, _draws = reference(log_post, DIM, 3)
    ref_mean = np.asarray(ref.draws).mean(axis=(0, 1))
    ref_sd = np.asarray(ref.draws).std(axis=(0, 1))
    dev = lambda m: float(np.max(np.abs(np.asarray(m) - ref_mean) / ref_sd))
    approx = {}
    for name, full_rank in (("advi_mean_field", False),
                            ("advi_full_rank", True)):
        r = mcmc_tpu.advi(jnp.zeros(DIM), log_post, full_rank=full_rank,
                          key=jax.random.PRNGKey(11))
        approx[name] = {"elbo": float(r.elbo), "max_mean_dev_sd":
                        dev(r.mean)}
    r = mcmc_tpu.svgd(jnp.zeros(DIM), log_post, n_particles=SVGD_PARTICLES,
                      key=jax.random.PRNGKey(12))
    approx["svgd"] = {"max_mean_dev_sd": dev(np.asarray(r.particles).mean(0))}
    for v in approx.values():
        v["bound"] = bound(v["max_mean_dev_sd"])
    print(json.dumps({"approx": approx}), flush=True)

    x, yp = poly_data()
    poly = {}
    for name, degree in (("linear", 1), ("quadratic", 2)):
        F = jnp.asarray(np.stack([x ** p for p in range(degree + 1)], 1))
        ypj = jnp.asarray(yp)
        lp = lambda th: jnp.sum(-0.5 * th ** 2 / POLY_PRIOR_VAR - 0.5 * jnp.log(
            2 * jnp.pi * POLY_PRIOR_VAR))
        ll = lambda th, F=F: jnp.sum(-0.5 * (ypj - F @ th) ** 2 / POLY_SIG2
                                     - 0.5 * jnp.log(2 * jnp.pi * POLY_SIG2))
        poly[name] = {"exact": poly_exact_log_z(x, yp, degree),
                      **evidence(degree + 1, lp, ll, EV_POLY)}
    print(json.dumps({"poly": poly, "settings": {
        "flagship": EV_FLAGSHIP, "poly": EV_POLY}}), flush=True)


if __name__ == "__main__":
    main()
