"""ChEES-HMC on Bayesian logistic regression: the port's rendition of
``examples/chees_logreg.py``, the accelerator-native alternative to NUTS
(no reference analog; Hoffman, Radul & Sountsov 2021). 500 rows of 25
features, 128 chains, 500 + 1000 draws, the mass matrix adapted.

Run many chains: the trajectory-length criterion pools expectations across
the chain batch, so more chains = better adaptation AND more throughput.

--quick: 32 chains, 100 + 100 draws.
"""

from _common import emit, setup

args = setup(__doc__)
import numpy as np  # noqa: E402

import mcmc_tpu_torch as mt  # noqa: E402
from mcmc_tpu_torch import diagnostics, models  # noqa: E402

chains, burn, keep = (32, 100, 100) if args.quick else (128, 500, 1000)
X, y, beta_true = models.make_logistic_regression_data(0, 500, 25,
                                                        device=args.device)
log_kernel = models.logistic_regression_model(X, y)

out = mt.chees(
    np.zeros(25), log_kernel,
    mt.ChEESSettings(n_burnin_draws=burn, n_keep_draws=keep),
    n_chains=chains, key=1, adapt_mass_matrix=True, device=args.device)

est = out.draws.reshape(-1, 25).double().mean(0).cpu().numpy()
truth = beta_true.double().cpu().numpy()
traj = float(out.diagnostics["adapted_trajectory_length"].reshape(-1)[0])
n_leap = float(out.diagnostics["n_leap"].float().mean())
rhat = float(diagnostics.split_rhat(out.draws).max())
print("posterior mean vs truth (first 5):")
print("  est :", est[:5].round(2))
print("  true:", truth[:5].round(2))
print("adapted trajectory length:", traj)
print("mean leapfrogs/draw:", n_leap)
print("max split R-hat:", rhat)
emit(corr_with_truth=np.corrcoef(est, truth)[0, 1],
     adapted_trajectory_length=traj, mean_leapfrogs_per_draw=n_leap,
     max_split_rhat=rhat, accept_rate=out.accept_rate.mean(),
     min_ess_per_draw=diagnostics.ess(out.draws).min() / (keep * chains))
