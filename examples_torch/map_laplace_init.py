"""MAP + Laplace initialization: find the posterior mode with the batched
Adam optimizer, then start overdispersed chains from the Laplace Gaussian;
the port's rendition of ``examples/map_laplace_init.py``. 500 rows of 10
features, 600 Adam steps over 4 restarts, then ChEES through ``fit`` with
16 chains, 500 warmup + 500 draws.

No counterpart in the reference: MCMCLib ships no optimizer, and its
examples hardcode ``initial_vals`` (e.g. examples/eigen/
rwmh_normal_mean.cpp).

--quick: 150 Adam steps; 8 chains, 100 + 100 draws.
"""

from _common import emit, setup

args = setup(__doc__)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import mcmc_tpu_torch as mt  # noqa: E402
from mcmc_tpu_torch import models  # noqa: E402

steps, chains, n = (150, 8, 100) if args.quick else (600, 16, 500)
X, y, beta_true = models.make_logistic_regression_data(0, 500, 10,
                                                        device=args.device)
log_kernel = models.logistic_regression_model(X, y)

# MAP search: 4 jittered restarts as one batched Adam loop
lap = mt.map_laplace(np.zeros(10), log_kernel, n_steps=steps, key=1,
                     device=args.device)
sd = torch.sqrt(torch.diagonal(lap.cov))
print("MAP:", lap.mode.cpu().numpy())
print("grad norm at mode:", float(lap.grad_norm))
print("Laplace sd:", sd.cpu().numpy())

# start chains from overdispersed Laplace draws (or: fit(init="laplace"))
inits = lap.draw_init(2, n_chains=chains)
out = mt.fit(inits, log_kernel, n_chains=chains, algorithm="chees",
             n_warmup=n, n_draws=n, key=3, device=args.device)
s = out.diagnostics["summary"]
rhat = float(s["rhat_rank"].max())
print("posterior mean:", s["mean"].cpu().numpy())
print("94% HDI:", s["hdi_low"].cpu().numpy(), s["hdi_high"].cpu().numpy())
print("max rank R-hat:", rhat)
emit(map=lap.mode, grad_norm=lap.grad_norm, laplace_sd=sd, mean=s["mean"],
     max_abs_mean_minus_map_over_sd=((s["mean"] - lap.mode).abs()
                                     / sd).max(),
     corr_with_truth=np.corrcoef(s["mean"].cpu().numpy(),
                                 beta_true.cpu().numpy())[0, 1],
     max_rank_rhat=rhat)
