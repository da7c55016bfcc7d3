"""AEES on a bimodal Gaussian mixture: the port's rendition of
``examples/aees_mixture.py`` (reference examples/eigen/aees_mixture.cpp):
ladder (60, 9) + T=1, 11 energy rings, ee_prob 0.05, 1000 initial, 1000
burn-in and 20000 kept draws; prints sign-filtered mode means as the
reference does (truth: (2, 2) and (-2, -2)). Then the same run with the
ladder built by the sampler from its hottest rung alone.

--quick: 200 initial, 200 burn-in, 1000 kept draws.
"""

from _common import emit, setup

args = setup(__doc__)
import numpy as np  # noqa: E402

import mcmc_tpu_torch as mt  # noqa: E402
from mcmc_tpu_torch import models  # noqa: E402

init_n, burn, keep = (200, 200, 1000) if args.quick else (1000, 1000, 20000)
mu = np.array([[-2.0, -2.0], [2.0, 2.0]])
log_kernel = models.gaussian_mixture_model(
    mu, sig_sq=np.array([0.1, 0.1]), weights=np.array([0.5, 0.5]),
    device=args.device)

settings = mt.AlgoSettings(rng_seed_value=2)
settings.aees_settings.n_initial_draws = init_n
settings.aees_settings.n_burnin_draws = burn
settings.aees_settings.n_keep_draws = keep
settings.aees_settings.n_rings = 11
settings.aees_settings.ee_prob_par = 0.05
settings.aees_settings.temper_vec = np.array([60.0, 9.0])
settings.aees_settings.par_scale = 1.0
settings.aees_settings.cov_mat = 0.35 * np.eye(2)

out = mt.aees(mu[0], log_kernel, settings, device=args.device)
d = out.draws.double().cpu().numpy()
pos, neg = d[d[:, 0] > 0.1].mean(axis=0), d[d[:, 0] < -0.1].mean(axis=0)
print("posterior mean for > 0.1:", pos)
print("posterior mean for < -0.1:", neg)

# Beyond the reference: let the sampler BUILD the ladder. A pilot measures
# the log-kernel spread across inverse temperatures and places rungs at
# dbeta = spacing / sigma_val(beta), so only the hottest temperature needs
# choosing.
settings.aees_settings.temper_vec = np.array([60.0])
out2 = mt.aees(mu[0], log_kernel, settings, adapt_ladder=True, key=3,
               device=args.device)
temps = out2.diagnostics["temperatures"].cpu().numpy()
ee = out2.diagnostics["ee_accept_rate"].cpu().numpy()
print("auto ladder:", temps.round(2))
print("per-rung EE accept:", ee.round(3))
d2 = out2.draws.double().cpu().numpy()
emit(mean_pos=pos, mean_neg=neg, mode_share=float((d[:, 0] > 0).mean()),
     accept_rate=out.accept_rate, auto_ladder=temps, auto_ee_accept=ee,
     auto_mode_share=float((d2[:, 0] > 0).mean()))
