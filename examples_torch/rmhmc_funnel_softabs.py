"""RM-HMC with the SoftAbs metric on Neal's funnel: the port's rendition of
``examples/rmhmc_funnel_softabs.py`` (no reference analog: the reference's
RM-HMC needs a hand-derived metric and derivative cube, examples/eigen/
rmhmc_normal.cpp:78-111; SoftAbs (Betancourt 2013) builds it from the
Hessian of any target). The funnel's neck (v << 0) defeats any fixed mass
matrix; the position-dependent metric walks down it. 16 chains, 500 + 2000
draws, step 0.5, 4 leapfrogs, 5 fixed-point iterations.

--quick: 4 chains, 10 + 20 draws.
"""

from _common import emit, setup

args = setup(__doc__)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import mcmc_tpu_torch as mt  # noqa: E402
from mcmc_tpu_torch import diagnostics, models  # noqa: E402

chains, burn, keep = (4, 10, 20) if args.quick else (16, 500, 2000)
log_kernel = models.neals_funnel(dim=3, scale=3.0)
metric_fn = mt.softabs_metric(log_kernel, alpha=1.0)

out = mt.rmhmc(
    np.zeros(3), log_kernel, metric_fn,
    mt.RMHMCSettings(n_burnin_draws=burn, n_keep_draws=keep,
                     step_size=0.5, n_leap_steps=4, n_fp_steps=5),
    n_chains=chains, key=0, device=args.device)

v = out.draws[..., 0].reshape(-1).double().cpu().numpy()
accept = float(out.n_accept_draws.sum()) / v.size
print("draws:", tuple(out.draws.shape))
print("accept:", accept)
print("v mean / std (truth 0 / 3):", round(v.mean(), 3), round(v.std(), 3))
print("deepest neck visited (v min):", round(float(v.min()), 2))
emit(accept_rate=accept, v_mean=v.mean(), v_std=v.std(), v_min=v.min(),
     finite=bool(torch.isfinite(out.draws).all()),
     max_rank_rhat=diagnostics.rank_normalized_rhat(out.draws).max(),
     v_ess=diagnostics.ess(out.draws)[0])
