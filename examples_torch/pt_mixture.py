"""Parallel tempering on the bimodal Gaussian mixture (the AEES example's
target, reference examples/eigen/aees_mixture.cpp): the port's rendition of
``examples/pt_mixture.py``, the exact-swap alternative to AEES's equi-energy
jumps. An adaptive geometric ladder of 6 temperatures up to 60 with HMC
inner moves (step 0.12, 5 leapfrogs); 16 independent ladders, 1000 + 2000
draws. Prints sign-filtered mode means like the reference example (truth:
(2, 2) and (-2, -2), balance 0.5), plus the adapted ladder and per-pair
swap acceptance.

--quick: 8 ladders, 150 + 300 draws.
"""

from _common import emit, setup

args = setup(__doc__)
import numpy as np  # noqa: E402

import mcmc_tpu_torch as mt  # noqa: E402
from mcmc_tpu_torch import models  # noqa: E402

chains, burn, keep = (8, 150, 300) if args.quick else (16, 1000, 2000)
mu = np.array([[-2.0, -2.0], [2.0, 2.0]])
log_kernel = models.gaussian_mixture_model(
    mu, sig_sq=np.array([0.1, 0.1]), weights=np.array([0.5, 0.5]),
    device=args.device)

settings = mt.PTSettings(
    n_burnin_draws=burn, n_keep_draws=keep,
    n_temps=6, max_temp=60.0, adapt_temps=True,
    inner="hmc", step_size=0.12, n_leap_steps=5,
)

out = mt.pt(mu[0], log_kernel, settings, n_chains=chains, key=2,
            device=args.device)
d = out.draws.double().cpu().numpy().reshape(-1, 2)
pos, neg = d[d[:, 0] > 0.1].mean(axis=0), d[d[:, 0] < -0.1].mean(axis=0)
balance = float((d[:, 0] > 0).mean())
temps = out.diagnostics["temperatures"].cpu().numpy()
swap = out.diagnostics["swap_accept_rate"].cpu().numpy().mean(axis=0)
print("posterior mean for > 0.1:", pos)
print("posterior mean for < -0.1:", neg)
print("mode balance:", balance)
print("adapted ladder:", temps.round(2))
print("swap acceptance:", swap.round(3))
emit(mean_pos=pos, mean_neg=neg, mode_balance=balance,
     adapted_ladder=temps, swap_accept_rate=swap,
     accept_rate=out.accept_rate.mean())
