"""Sampling the posterior mean of a Gaussian with RWMH.

The port's rendition of ``examples/rwmh_normal_mean.py`` (reference
examples/eigen/rwmh_normal_mean.cpp): N(mu, 1) likelihood over 100 points,
N(1, 2^2) prior, par_scale 0.4, 2000 + 2000 draws. The posterior is
conjugate, so its exact mean is printed beside the estimate.

--quick: 500 + 500 draws.
"""

from _common import emit, mean_and_mcse, setup

args = setup(__doc__)
import numpy as np  # noqa: E402

import mcmc_tpu_torch as mt  # noqa: E402
from mcmc_tpu_torch import models  # noqa: E402

n_draws = 500 if args.quick else 2000
mu_true = 2.0
x_data = mu_true + np.random.default_rng(1).standard_normal(100)

log_kernel = models.gaussian_mean_model(x_data, sigma=1.0, mu_0=1.0,
                                        sigma_0=2.0, device=args.device)

settings = mt.AlgoSettings(rng_seed_value=42)
settings.rwmh_settings.par_scale = 0.4
settings.rwmh_settings.n_burnin_draws = n_draws
settings.rwmh_settings.n_keep_draws = n_draws

out = mt.rwmh(np.array([1.0]), log_kernel, settings, device=args.device)

# conjugate posterior: precision n / sigma^2 + 1 / sigma_0^2
x32 = x_data.astype(np.float32).astype(np.float64)
prec = len(x32) + 1.0 / 4.0
exact = (x32.sum() + 1.0 / 4.0) / prec
mean, mcse = mean_and_mcse(out.draws)
print("rwmh mean:", out.mean.cpu().numpy())
print("acceptance rate:", float(out.accept_rate))
print("exact posterior mean:", round(exact, 4), " posterior sd:",
      round(prec ** -0.5, 4))
emit(mean=mean, mcse=mcse, exact_mean=[exact], truth=[mu_true],
     accept_rate=out.accept_rate)
