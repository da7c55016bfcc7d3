"""RM-HMC on the (mu, sigma) Gaussian model with the analytic Fisher
metric: the port's rendition of ``examples/rmhmc_normal.py`` (reference
examples/eigen/rmhmc_normal.cpp): step 0.2, 1000 + 1000 draws. The metric's
derivative cube is taken by ``torch.func`` forward mode inside the sampler
(``models.normal_fisher_metric`` is built to be jvp-differentiable), where
the reference hand-codes it. Prints each coordinate's distance from the
closed-form posterior mean in MC standard errors.

--quick: 100 + 100 draws.
"""

from _common import emit, mean_and_mcse, normal_scale_exact_mean, setup

args = setup(__doc__)
import numpy as np  # noqa: E402

import mcmc_tpu_torch as mt  # noqa: E402
from mcmc_tpu_torch import models  # noqa: E402

n_draws = 100 if args.quick else 1000
n_data = 1000
x_data = 2.0 + 2.0 * np.random.default_rng(6).standard_normal(n_data)
log_kernel = models.gaussian_mean_scale_model(x_data, device=args.device)
metric_fn = models.normal_fisher_metric(n_data)

settings = mt.AlgoSettings(rng_seed_value=13)
settings.rmhmc_settings.step_size = 0.2
settings.rmhmc_settings.n_burnin_draws = n_draws
settings.rmhmc_settings.n_keep_draws = n_draws

out = mt.rmhmc(np.array([3.0, 3.0]), log_kernel, metric_fn, settings,
               device=args.device)
mean, mcse = mean_and_mcse(out.draws)
exact = normal_scale_exact_mean(x_data)
z = (mean.numpy() - exact) / mcse.numpy()
print("rmhmc mean:", out.mean.cpu().numpy())
print("acceptance rate:", float(out.accept_rate))
print("distance from the closed-form mean (MC standard errors):",
      z.round(2))
emit(mean=mean, mcse=mcse, exact_mean=exact, z=z,
     accept_rate=out.accept_rate)
