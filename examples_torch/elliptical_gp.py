"""Elliptical slice sampling of a latent Gaussian-process field under a
Poisson count likelihood, the model class the reference cannot touch; the
port's rendition of ``examples/elliptical_gp.py``.

A log-Gaussian Cox-style model on a 1-d grid: counts y_i ~ Poisson(exp(f_i))
with f ~ GP(0, RBF) over 64 points in [0, 4], length scale 0.5. The
64-dimensional correlated prior would force RWMH to a tiny step size and
HMC to a carefully tuned mass matrix; elliptical slice sampling has nothing
to tune: the prior covariance itself steers every proposal along its own
ellipse, and every draw moves. 16 chains, 1000 + 3000 draws.

Prints the posterior latent mean against the true field and the average
number of likelihood evaluations per draw (the only cost knob).

--quick: 4 chains, 100 + 300 draws.
"""

from _common import emit, setup

args = setup(__doc__)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import mcmc_tpu_torch as mt  # noqa: E402
from mcmc_tpu_torch import models  # noqa: E402

chains, burn, keep = (4, 100, 300) if args.quick else (16, 1000, 3000)
# --- synthetic data: smooth rate field, Poisson counts -------------------
# rbf_kernel applies f32-sized diagonal jitter (1e-4 * amplitude^2): a
# hand-rolled 1e-6 jitter leaves this Gram matrix indefinite at f32 and
# the Cholesky fails (models/targets.py rbf_kernel docstring)
n = 64
xs = np.linspace(0.0, 4.0, n)
K = models.rbf_kernel(xs, length_scale=0.5, device=args.device)

rng = np.random.default_rng(0)
L = torch.linalg.cholesky(K.double()).cpu().numpy()
f_true = L @ rng.standard_normal(n)
y = torch.as_tensor(rng.poisson(np.exp(f_true)), dtype=torch.float32,
                    device=args.device)


def log_lik(f):
    # Poisson log-likelihood with log link (constant terms dropped)
    return (y * f - torch.exp(f)).sum(-1)


settings = mt.EllipticalSettings(n_burnin_draws=burn, n_keep_draws=keep)
out = mt.elliptical_slice(np.zeros(n), log_lik, settings, prior_cov=K,
                          n_chains=chains, key=2, device=args.device)

f_hat = out.draws.reshape(-1, n).double().mean(0).cpu().numpy()
rmse = float(np.sqrt(np.mean((f_hat - f_true) ** 2)))
acc = float(out.accept_rate.mean())
evals = float(out.diagnostics["mean_shrink_steps"].float().mean())
print("latent-field RMSE vs truth:", round(rmse, 3),
      " (prior sd ~1.0 -> big reduction)")
print("accept rate (slice sampler, expect 1.0):", round(acc, 3))
print("likelihood evals per draw:", round(evals, 2))
print("f_hat[:6] :", f_hat[:6].round(2))
print("f_true[:6]:", f_true[:6].round(2))
emit(rmse=rmse, accept_rate=acc, likelihood_evals_per_draw=evals,
     corr_with_truth=np.corrcoef(f_hat, f_true)[0, 1],
     max_rank_rhat=mt.diagnostics.rank_normalized_rhat(out.draws).max())
