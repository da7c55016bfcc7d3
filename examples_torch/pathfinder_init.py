"""Pathfinder initialization: follow an L-BFGS path toward the posterior,
score every iterate's inverse-Hessian Gaussian by ELBO, and start chains
from PSIS-resampled draws of the winners (Stan's modern default
initializer, here with all iterates scored in one batched pass); the port's
rendition of ``examples/pathfinder_init.py``. 8 paths and 1000 draws on the
10-d logistic regression, then ChEES through ``fit`` (16 chains,
500 + 500); then 8 paths of at most 40 iterations on an 8-d funnel.

No counterpart in the reference: MCMCLib's examples hardcode
``initial_vals``. The funnel below is the case where mode-seeking
initialization (MAP/Laplace) fails: the joint mode sits at z = 0 with v
driven far negative (v* = -9(d-1)/2 for this parameterization: finite, but
dozens of standard deviations below the v ~ N(0, 3^2) typical set), while
Pathfinder's ELBO picks an iterate in the typical set.

--quick: 4 paths, 200 draws; 8 chains, 100 + 100 draws; the funnel's 4
paths, 200 draws.
"""

from _common import emit, setup

args = setup(__doc__)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import mcmc_tpu_torch as mt  # noqa: E402
from mcmc_tpu_torch import models  # noqa: E402

paths, n_pf, chains, n = (4, 200, 8, 100) if args.quick else \
    (8, 1000, 16, 500)
# --- flagship posterior: 10-d logistic regression --------------------
X, y, beta_true = models.make_logistic_regression_data(0, 500, 10,
                                                        device=args.device)
log_kernel = models.logistic_regression_model(X, y)

pf = mt.pathfinder(np.zeros(10), log_kernel, n_paths=paths, n_draws=n_pf,
                   key=1, device=args.device)
print("best ELBO per path:", pf.elbo.cpu().numpy())
print("winning L-BFGS iterates:", pf.best_iter.cpu().numpy())
print("pooled pareto-k:", float(pf.pareto_k),
      "(< 0.7: draws usable as a rough posterior)")
print("draw mean:", pf.draws.mean(0).cpu().numpy())

out = mt.fit(np.zeros(10), log_kernel, n_chains=chains, algorithm="chees",
             n_warmup=n, n_draws=n, init="pathfinder", key=2,
             device=args.device)
s = out.diagnostics["summary"]
rhat = float(s["rhat_rank"].max())
print("posterior mean:", s["mean"].cpu().numpy())
print("max rank R-hat:", rhat)

# --- the funnel: where the mode is a lie ------------------------------


def funnel(x):
    v, z = x[..., 0], x[..., 1:]
    return (-0.5 * (v / 3.0) ** 2
            - 0.5 * (z ** 2).sum(-1) * torch.exp(-v)
            - 0.5 * (x.shape[-1] - 1) * v)


pf_f = mt.pathfinder(np.zeros(8), funnel, n_paths=paths, n_draws=n_pf // 2,
                     max_iters=40, key=3, device=args.device)
v = pf_f.draws[:, 0].double()
print("\nfunnel: winning iterates", pf_f.best_iter.cpu().numpy(),
      "(max_iters=40: none at the path end: the ELBO rejects the "
      "collapsing mode)")
print("funnel v-draws mean/sd:", float(v.mean()), float(v.std()))
emit(pareto_k=pf.pareto_k, elbo=pf.elbo,
     draw_mean_minus_fit_mean_max=(pf.draws.mean(0) - s["mean"]).abs().max(),
     fit_mean=s["mean"],
     corr_with_truth=np.corrcoef(s["mean"].cpu().numpy(),
                                 beta_true.cpu().numpy())[0, 1],
     max_rank_rhat=rhat, funnel_best_iter=pf_f.best_iter,
     funnel_v_mean=v.mean(), funnel_v_sd=v.std())
