"""Fused-trajectory GLM HMC: probit regression and Student-t robust
regression, the port's rendition of ``examples/fused_glm_probit.py``.

The fused path runs the whole leapfrog trajectory of every chain in one
hand-written CUDA kernel (the design matrix resident on the chip, bf16
tensor-core products, an f32 accept; ``mcmc_tpu_torch/ops/fused_logreg.py``).
Beyond the canonical links (logistic: reference examples/autodiff/
hmc_normal_autodiff.cpp is the closest analog), the link slot takes
non-canonical families: probit (built in; erf by the A&S 7.1.26
polynomial) and Student-t robust regression (``studentt_link(nu)``), or
any elementwise torch callable ``link(eta, y) -> (mu_eff, ll_terms)``.
512 chains in blocks of 256, n = 500 rows of d = 25 features (128 padded
columns), 8 leapfrogs, 500 + 1000 draws per link. On the card every
trajectory is one launch of the kernel; the script counts them.

--quick: 32 chains in blocks of 8, 50 + 100 draws.
"""

import math

from _common import emit, setup

args = setup(__doc__)
import numpy as np  # noqa: E402
import torch  # noqa: E402

from mcmc_tpu_torch import diagnostics  # noqa: E402
from mcmc_tpu_torch.ops import fused_glm_hmc, fused_logreg, \
    studentt_link  # noqa: E402

if args.quick:
    kw = dict(n_chains=32, block_chains=8, n_burnin_draws=50,
              n_keep_draws=100)
else:
    kw = dict(n_chains=512, block_chains=256, n_burnin_draws=500,
              n_keep_draws=1000)
K1 = fused_logreg.fused_trajectory_cuda


def run(X, y, link, step_size, key):
    """One fused run and the number of K1 launches it made."""
    before = K1.launches
    out = fused_glm_hmc(X, y, link=link, step_size=step_size, n_leap=8,
                        key=key, device=args.device, **kw)
    return out, K1.launches - before


# --- probit regression -----------------------------------------------------
rng = np.random.default_rng(0)
n, d = 500, 25
X = rng.standard_normal((n, d)) * 0.5
beta_true = rng.standard_normal(d) * 0.8
ndtr = np.vectorize(lambda e: 0.5 * (1.0 + math.erf(e / math.sqrt(2.0))))
y = (rng.uniform(size=n) < ndtr(X @ beta_true)).astype(np.float32)
Xt = torch.as_tensor(X, dtype=torch.float32, device=args.device)

out, k1_probit = run(Xt, y, "probit", 0.06, 1)
est = out.draws.reshape(-1, d).double().mean(0).cpu().numpy()
corr = float(np.corrcoef(est, beta_true)[0, 1])
acc = float(out.diagnostics["accept_rate_per_chain"].mean())
rhat = float(diagnostics.rank_normalized_rhat(out.draws).max())
print("probit: corr(posterior mean, truth) =", round(corr, 3))
print("        accept rate =", round(acc, 3),
      " max rank R-hat =", round(rhat, 4))

# --- Student-t robust regression (nu = 4, heavy-tailed noise) ---------------
rng_t = np.random.default_rng(10)
y_t = (X @ beta_true + 0.5 * rng_t.standard_t(4.0, n)).astype(np.float32)
out_t, k1_t = run(Xt, y_t, studentt_link(4.0), 0.05, 11)
est_t = out_t.draws.reshape(-1, d).double().mean(0).cpu().numpy()
corr_t = float(np.corrcoef(est_t, beta_true)[0, 1])
acc_t = float(out_t.diagnostics["accept_rate_per_chain"].mean())
rhat_t = float(diagnostics.rank_normalized_rhat(out_t.draws).max())
print("student-t: corr(posterior mean, truth) =", round(corr_t, 3))
print("           accept rate =", round(acc_t, 3))
print("K1 launches: probit", k1_probit, " student-t", k1_t)
emit(probit_corr=corr, probit_accept_rate=acc, probit_max_rank_rhat=rhat,
     studentt_corr=corr_t, studentt_accept_rate=acc_t,
     studentt_max_rank_rhat=rhat_t,
     k1_launches={"probit": k1_probit, "studentt": k1_t},
     transitions_per_link=kw["n_burnin_draws"] + kw["n_keep_draws"],
     n_chains=kw["n_chains"])
