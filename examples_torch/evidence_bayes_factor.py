"""Bayes factors by power-posterior path sampling: estimate log marginal
likelihoods for two competing models with ``thermo_evidence``, cross-check
the stepping-stone headline against corrected TI, SMC's particle estimate,
nested sampling and the Laplace shortcut, then report the Bayes factor;
the port's rendition of ``examples/evidence_bayes_factor.py``.

No counterpart in the reference: MCMCLib cannot produce log Z at all. The
replica ladder runs as one (K, d) batch per chain with DEO even/odd swaps,
and the independent ladders supply the cross-chain standard error. The data
come from the quadratic model (n = 60, known noise variance 0.25, prior
N(0, 2^2) iid); both models are linear-Gaussian, so their exact log Z is
printed beside the estimates. 16 ladders of 24 rungs, 800 + 800 draws;
Laplace 600 steps; SMC 2048 particles; nested sampling 512 live points.

--quick: 4 ladders of 8 rungs, 100 + 100 draws; Laplace 200 steps; SMC 256
particles; nested sampling 64 live points.
"""

import math

from _common import emit, setup

args = setup(__doc__)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import mcmc_tpu_torch as mt  # noqa: E402
from mcmc_tpu_torch import AlgoSettings, EvidenceSettings, \
    SMCSettings  # noqa: E402

q = args.quick
# data generated from the quadratic model; model A = linear (misspecified),
# model B = quadratic
rng = np.random.default_rng(0)
n = 60
x_np = rng.standard_normal(n).astype(np.float32)
y_np = (0.5 + 1.2 * x_np + 0.8 * x_np ** 2
        + 0.5 * rng.standard_normal(n)).astype(np.float32)
x = torch.as_tensor(x_np, device=args.device)
y = torch.as_tensor(y_np, device=args.device)
SIG2 = 0.25      # known noise variance
PRIOR_VAR = 4.0


def make_model(degree):
    feats = torch.stack([x ** p for p in range(degree + 1)], dim=1)  # (n, d)
    d = degree + 1

    def log_prior(th):  # N(0, 2^2) iid: normalised
        return (-0.5 * th ** 2 / PRIOR_VAR
                - 0.5 * math.log(2 * math.pi * PRIOR_VAR)).sum(-1)

    def log_lik(th):
        r = y - th @ feats.T
        return (-0.5 * r ** 2 / SIG2
                - 0.5 * math.log(2 * math.pi * SIG2)).sum(-1)

    return d, log_prior, log_lik


def exact_log_z(degree):
    """y ~ N(0, SIG2 I + PRIOR_VAR F F^T), F the powers of x."""
    F = np.stack([x_np.astype(np.float64) ** p for p in range(degree + 1)], 1)
    C = SIG2 * np.eye(n) + PRIOR_VAR * F @ F.T
    _, logdet = np.linalg.slogdet(C)
    yy = y_np.astype(np.float64)
    return float(-0.5 * (n * math.log(2 * math.pi) + logdet
                         + yy @ np.linalg.solve(C, yy)))


s = AlgoSettings()
s.evidence_settings = EvidenceSettings(
    n_burnin_draws=100 if q else 800, n_keep_draws=100 if q else 800,
    n_temps=8 if q else 24)

log_zs, figures = {}, {}
for name, degree in [("linear", 1), ("quadratic", 2)]:
    d, log_prior, log_lik = make_model(degree)
    joint = lambda th: log_prior(th) + log_lik(th)  # noqa: E731
    res = mt.thermo_evidence(np.zeros(d), log_prior, log_lik, s,
                             n_chains=4 if q else 16, key=1,
                             device=args.device)
    log_zs[name] = float(res.log_z)

    # independent estimators on the same model
    lap = mt.map_laplace(np.zeros(d), joint, n_steps=200 if q else 600,
                         learning_rate=0.1, key=2, device=args.device)
    smc_s = AlgoSettings()
    smc_s.smc_settings = SMCSettings(n_particles=256 if q else 2048,
                                     init_scale=2.0)
    smc_res = mt.smc(np.zeros(d), joint, smc_s, key=3, device=args.device)

    # nested sampling over the same model through the unit-cube transform
    ns = mt.nested_sampling(
        lambda u: 2.0 * torch.special.ndtri(u),     # the N(0, 2^2) prior
        log_lik, d, n_live=64 if q else 512, key=4, device=args.device)

    exact = exact_log_z(degree)
    print(f"{name:10s} log Z: stepping-stone {float(res.log_z):9.2f} "
          f"+- {float(res.log_z_se):.3f} | corrected TI "
          f"{float(res.log_z_ti):9.2f} +- {float(res.log_z_ti_se):.3f} | "
          f"Laplace {float(lap.log_evidence):9.2f} | SMC "
          f"{float(smc_res.diagnostics['log_z']):9.2f} | nested "
          f"{float(ns.log_z):9.2f} +- {float(ns.log_z_err):.2f} | exact "
          f"{exact:9.2f}")
    print(f"{'':10s} per-rung accept in "
          f"[{float(res.accept_rate.min()):.2f}, "
          f"{float(res.accept_rate.max()):.2f}], min swap rate "
          f"{float(res.swap_accept_rate.min()):.2f}")
    figures[name] = {
        "exact": exact, "ss": res.log_z, "ss_se": res.log_z_se,
        "ti": res.log_z_ti, "ti_se": res.log_z_ti_se,
        "laplace": lap.log_evidence, "smc": smc_res.diagnostics["log_z"],
        "nested": ns.log_z, "nested_err": ns.log_z_err,
        "min_accept": res.accept_rate.min(),
        "max_accept": res.accept_rate.max(),
        "min_swap": res.swap_accept_rate.min()}

log_bf = log_zs["quadratic"] - log_zs["linear"]
exact_bf = figures["quadratic"]["exact"] - figures["linear"]["exact"]
print(f"\nlog Bayes factor (quadratic vs linear) = {log_bf:.1f} "
      f"({'decisive for quadratic' if log_bf > 4.6 else 'inconclusive'}; "
      f"exact {exact_bf:.1f})")
emit(log_bayes_factor=log_bf, exact_log_bayes_factor=exact_bf, **figures)
