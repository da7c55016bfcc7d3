"""Tempered SMC on an unequal-weight bimodal mixture: the port's rendition
of ``examples/smc_mixture.py``, the population-native take on the AEES
example's target (reference examples/eigen/aees_mixture.cpp), plus the one
thing no MCMC sampler here can return: the model evidence.

A 0.3/0.7 mixture at (-2,-2)/(+2,+2) (variance 0.25) is annealed from a
broad Gaussian cloud by 8192 particles with 5 mutation steps a stage; the
adaptive temperature ladder, mutation acceptance, mode masses and log Z are
printed. The weights are normalised densities, so the exact log Z is 0 and
the mode mass at +2 is 0.7.

--quick: 1024 particles.
"""

from _common import emit, setup

args = setup(__doc__)
import numpy as np  # noqa: E402

import mcmc_tpu_torch as mt  # noqa: E402
from mcmc_tpu_torch import models  # noqa: E402

mu = np.array([[-2.0, -2.0], [2.0, 2.0]])
log_kernel = models.gaussian_mixture_model(
    mu, sig_sq=np.array([0.25, 0.25]), weights=np.array([0.3, 0.7]),
    device=args.device)

settings = mt.SMCSettings(
    n_particles=1024 if args.quick else 8192, init_scale=4.0,
    n_mcmc_steps=5, ess_target=0.5,
)

out = mt.smc(np.zeros(2), log_kernel, settings, key=2, device=args.device)
d = out.draws.double().cpu().numpy()
pos = d[:, 0] > 0
log_z = float(out.diagnostics["log_z"])
lambdas = out.diagnostics["lambdas"].cpu().numpy()
acc = out.diagnostics["mutation_accept_rate"].cpu().numpy()
print("mode mass at +2 (true 0.7):", round(float(pos.mean()), 3))
print("posterior mean (+) :", d[pos].mean(axis=0).round(3))
print("posterior mean (-) :", d[~pos].mean(axis=0).round(3))
print("stages:", int(out.diagnostics["n_stages"]),
      " lambdas:", lambdas.round(3))
print("mutation acceptance:", acc.round(3))
print("log Z:", round(log_z, 3),
      " (weights are normalized densities: exact log Z = 0)")
emit(mode_mass_pos=float(pos.mean()), mean_pos=d[pos].mean(axis=0),
     mean_neg=d[~pos].mean(axis=0), n_stages=int(out.diagnostics["n_stages"]),
     lambdas=lambdas, mutation_accept_rate=acc, log_z=log_z,
     n_particles=len(d))
