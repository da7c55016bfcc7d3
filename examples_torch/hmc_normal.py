"""HMC on the (mu, sigma) Gaussian model: the port's rendition of
``examples/hmc_normal.py`` (reference examples/eigen/hmc_normal.cpp): step
0.08, 2000 + 2000 draws; the closed-form posterior mean is printed beside
the estimate.

--quick: 300 + 300 draws.
"""

from _common import emit, mean_and_mcse, normal_scale_exact_mean, setup

args = setup(__doc__)
import numpy as np  # noqa: E402

import mcmc_tpu_torch as mt  # noqa: E402
from mcmc_tpu_torch import models  # noqa: E402

n_draws = 300 if args.quick else 2000
x_data = 2.0 + 2.0 * np.random.default_rng(3).standard_normal(1000)
log_kernel = models.gaussian_mean_scale_model(x_data, device=args.device)

settings = mt.AlgoSettings(rng_seed_value=5)
settings.hmc_settings.step_size = 0.08
settings.hmc_settings.n_burnin_draws = n_draws
settings.hmc_settings.n_keep_draws = n_draws

out = mt.hmc(np.array([3.0, 3.0]), log_kernel, settings, device=args.device)
mean, mcse = mean_and_mcse(out.draws)
print("hmc mean:", out.mean.cpu().numpy())
print("acceptance rate:", float(out.accept_rate))
emit(mean=mean, mcse=mcse, exact_mean=normal_scale_exact_mean(x_data),
     accept_rate=out.accept_rate)
