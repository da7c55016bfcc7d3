"""NUTS on the (mu, sigma) Gaussian model: the port's rendition of
``examples/nuts_normal.py`` (reference examples/eigen/nuts_normal.cpp):
default dual-averaging settings (target accept 0.55), 2000 adapted burn-in
+ 2000 kept draws; the closed-form posterior mean is printed beside the
estimate.

--quick: 150 + 150 draws (150 adapted).
"""

from _common import emit, mean_and_mcse, normal_scale_exact_mean, setup

args = setup(__doc__)
import numpy as np  # noqa: E402

import mcmc_tpu_torch as mt  # noqa: E402
from mcmc_tpu_torch import models  # noqa: E402

n_draws = 150 if args.quick else 2000
x_data = 2.0 + 2.0 * np.random.default_rng(5).standard_normal(1000)
log_kernel = models.gaussian_mean_scale_model(x_data, device=args.device)

settings = mt.AlgoSettings(rng_seed_value=11)
settings.nuts_settings.n_burnin_draws = n_draws
settings.nuts_settings.n_keep_draws = n_draws
settings.nuts_settings.n_adapt_draws = n_draws

out = mt.nuts(np.array([3.0, 3.0]), log_kernel, settings, device=args.device)
mean, mcse = mean_and_mcse(out.draws)
depth = float(out.diagnostics["tree_depth"].float().mean())
step = float(out.diagnostics["step_size"][-1])
print("nuts mean:", out.mean.cpu().numpy())
print("acceptance rate:", float(out.accept_rate))
print("mean tree depth:", depth)
print("adapted step size:", step)
emit(mean=mean, mcse=mcse, exact_mean=normal_scale_exact_mean(x_data),
     accept_rate=out.accept_rate, mean_tree_depth=depth,
     adapted_step_size=step)
