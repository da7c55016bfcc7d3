"""DE-MCMC on the Gaussian-mean posterior: the port's rendition of
``examples/de_normal_mean.py`` (reference examples/eigen/
de_normal_mean.cpp): a population of 100, 1000 + 1000 generations.
Acceptance is reported over n_keep * n_pop as in the reference example; the
conjugate posterior's exact mean is printed beside the estimate.

--quick: 100 + 100 generations.
"""

from _common import emit, mean_and_mcse, setup

args = setup(__doc__)
import numpy as np  # noqa: E402

import mcmc_tpu_torch as mt  # noqa: E402
from mcmc_tpu_torch import models  # noqa: E402

n_gen = 100 if args.quick else 1000
x_data = 2.0 + np.random.default_rng(7).standard_normal(100)
log_kernel = models.gaussian_mean_model(x_data, sigma=1.0,
                                        device=args.device)

settings = mt.AlgoSettings(rng_seed_value=17)
settings.de_settings.n_pop = 100
settings.de_settings.n_burnin_draws = n_gen
settings.de_settings.n_keep_draws = n_gen

out = mt.de(np.array([1.0]), log_kernel, settings, device=args.device)
n_keep, n_pop = out.draws.shape[0], out.draws.shape[1]
accept = int(out.n_accept_draws) / (n_keep * n_pop)
# conjugate posterior: N(mu, 1) likelihood, N(1, 2^2) prior
x32 = x_data.astype(np.float32).astype(np.float64)
prec = len(x32) + 0.25
exact = (x32.sum() + 0.25) / prec
mean, mcse = mean_and_mcse(out.draws)
print("de mean:", float(out.draws.mean()))
print("acceptance rate:", accept)
print("exact posterior mean:", round(exact, 4))
# mcse treats the population's members as chains (they are coupled)
emit(mean=mean, mcse=mcse, exact_mean=[exact],
     posterior_sd=prec ** -0.5, truth=[2.0], accept_rate=accept)
