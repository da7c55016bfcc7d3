"""Stochastic-gradient Langevin dynamics on a tall logistic regression:
minibatch gradients, no full-data pass per draw (the tall-data companion to
``data_parallel_hmc.py``); the port's rendition of
``examples/sgld_logreg.py``. 65,536 rows of 16 features, minibatches of
512, step 2e-5 with Welling-Teh polynomial decay (gamma 0.33, b 1000), 32
chains, 2000 + 4000 draws, one minibatch shared by the chains each draw.

No counterpart in the reference: all of MCMCLib's samplers consume a
full-data log-kernel callback each draw.

--quick: 8 chains, 200 + 400 draws.
"""

from _common import emit, setup

args = setup(__doc__)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import mcmc_tpu_torch as mt  # noqa: E402

chains, burn, keep = (8, 200, 400) if args.quick else (32, 2000, 4000)
N, D = 65536, 16
rng = np.random.default_rng(0)
X = rng.standard_normal((N, D)).astype(np.float32)
beta_true = 0.5 * rng.standard_normal(D)
y = (rng.uniform(size=N) < 1.0 / (1.0 + np.exp(-(X @ beta_true)))
     ).astype(np.float32)


def log_prior(b):
    return -0.5 * (b ** 2).sum(-1) / 100.0


def log_lik(beta, batch):
    """``(c, D)`` with a batch whose leaves lead with the chain axis."""
    Xb, yb = batch
    eta = (Xb @ beta[:, :, None])[..., 0]
    return (yb * eta - torch.nn.functional.softplus(eta)).sum(-1)


s = mt.SGLDSettings(
    step_size=2e-5, batch_size=512,
    n_burnin_draws=burn, n_keep_draws=keep,
    decay_gamma=0.33, decay_b=1000.0,     # Welling-Teh polynomial decay
)
out = mt.sgld(np.zeros(D), log_prior, log_lik, (X, y), s, n_chains=chains,
              key=1, minibatch="shared", device=args.device)

err = float((out.mean.double().cpu() - torch.as_tensor(beta_true)).abs()
            .max())
rate = float(out.accept_rate.mean())
print("finite-update rate:", rate)  # 1.0 = healthy
print("max |posterior mean - truth|:", err)
emit(finite_update_rate=rate, max_abs_mean_minus_truth=err,
     corr_with_truth=np.corrcoef(out.mean.double().cpu().numpy(),
                                 beta_true)[0, 1])
