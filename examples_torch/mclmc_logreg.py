"""Microcanonical samplers on Bayesian logistic regression: the port's
rendition of ``examples/mclmc_logreg.py`` (no reference analog; Robnik et
al. 2022 + the Metropolis-adjusted variant). 500 rows of 25 features, 256
chains, 500 + 1000 draws each, the mass adapted; MCLMC thinned by 4.

``mclmc`` is the framework's highest-throughput sampler: one gradient per
draw, no accept/reject, lockstep across the chain batch, at the cost of an
O(step_size^2) stationary bias held at the ``desired_energy_var``
operating point (about 1% on this posterior's moments). ``mams`` is the
exact Metropolis-adjusted variant; running both and comparing moments is
the built-in bias audit shown here.

--quick: 32 chains, 100 + 100 draws each.
"""

from _common import emit, setup

args = setup(__doc__)
import numpy as np  # noqa: E402

import mcmc_tpu_torch as mt  # noqa: E402
from mcmc_tpu_torch import diagnostics, models  # noqa: E402

chains, burn, keep = (32, 100, 100) if args.quick else (256, 500, 1000)
X, y, beta_true = models.make_logistic_regression_data(0, 500, 25,
                                                        device=args.device)
log_kernel = models.logistic_regression_model(X, y)

out_u = mt.mclmc(
    np.zeros(25), log_kernel,
    mt.MCLMCSettings(n_burnin_draws=burn, n_keep_draws=keep),
    n_chains=chains, key=1, adapt_mass=True, thin=4, device=args.device)
out_x = mt.mams(
    np.zeros(25), log_kernel,
    mt.MAMSSettings(n_burnin_draws=burn, n_keep_draws=keep),
    n_chains=chains, key=2, adapt_mass=True, device=args.device)

du = out_u.draws.reshape(-1, 25).double().cpu().numpy()
dx = out_x.draws.reshape(-1, 25).double().cpu().numpy()
truth = beta_true.double().cpu().numpy()
dmean = float(np.abs(du.mean(0) - dx.mean(0)).max())
dstd = float(np.abs(du.std(0) / dx.std(0) - 1).max())
step = float(out_u.diagnostics["adapted_step_size"].reshape(-1)[0])
L = float(out_u.diagnostics["adapted_L"])
acc = float(out_x.accept_rate.mean())
n_leap = float(out_x.diagnostics["n_leap"].float().mean())
rhat_u = float(diagnostics.split_rhat(out_u.draws).max())
rhat_x = float(diagnostics.split_rhat(out_x.draws).max())
print("posterior mean vs truth (first 5):")
print("  mclmc:", du.mean(axis=0)[:5].round(2))
print("  mams :", dx.mean(axis=0)[:5].round(2))
print("  true :", truth[:5].round(2))
print("bias audit (unadjusted vs exact): max |dmean| =", round(dmean, 4),
      " max |dstd|/std =", round(dstd, 4))
print("mclmc adapted step:", step, " L:", L)
print("mams accept rate:", acc, " mean leapfrogs/draw:", n_leap)
print("max split R-hat: mclmc", rhat_u, " mams", rhat_x)
emit(mclmc_corr_with_truth=np.corrcoef(du.mean(0), truth)[0, 1],
     mams_corr_with_truth=np.corrcoef(dx.mean(0), truth)[0, 1],
     bias_max_dmean=dmean, bias_max_dstd=dstd, mclmc_step=step, mclmc_L=L,
     mams_accept_rate=acc, mams_mean_leapfrogs_per_draw=n_leap,
     mclmc_max_split_rhat=rhat_u, mams_max_split_rhat=rhat_x,
     posterior_sd_max=dx.std(0).max())
