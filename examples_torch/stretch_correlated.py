"""Affine-invariant ensemble (stretch move) on a strongly correlated
Gaussian: the port's rendition of ``examples/stretch_correlated.py``. No
preconditioner, mass matrix or scale tuning anywhere: the stretch proposal
is invariant under linear reparameterizations, so the rho = 0.95
correlation that would cripple an untuned random walk costs nothing.
Gradient-free, like the reference's DE-MCMC (reference examples/eigen/
de_normal_mean.cpp), but with zero tunable scales. 64 walkers,
1000 + 2000 sweeps.

--quick: 200 + 400 sweeps.
"""

from _common import emit, setup

args = setup(__doc__)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import mcmc_tpu_torch as mt  # noqa: E402

burn, keep = (200, 400) if args.quick else (1000, 2000)
rho = 0.95
cov = np.array([[1.0, rho], [rho, 1.0]])
prec = torch.as_tensor(np.linalg.inv(cov), dtype=torch.float32,
                       device=args.device)


def log_kernel(v):
    return -0.5 * (v * (v @ prec)).sum(-1)


settings = mt.StretchSettings(n_walkers=64, n_burnin_draws=burn,
                              n_keep_draws=keep)
out = mt.stretch(np.zeros(2), log_kernel, settings, key=0,
                 device=args.device)

d = out.draws.reshape(-1, 2).double().cpu().numpy()
emp = np.cov(d.T)
acc = float(out.diagnostics["accept_rate_per_walker"].mean())
print("empirical covariance:", [round(float(v), 3) for v in emp.ravel()])
print("true covariance:     ", [round(float(v), 3) for v in cov.ravel()])
print("mean accept/walker:  ", round(acc, 3))
emit(cov=emp.ravel(), true_cov=cov.ravel(), mean=d.mean(0),
     accept_rate=acc)
