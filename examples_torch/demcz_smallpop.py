"""DE-MC(Z) in the regime plain DE cannot reach: the port's rendition of
``examples/demcz_smallpop.py`` (no reference analog; ter Braak & Vrugt
2008): 8 walkers sampling a 20-d strongly correlated Gaussian (rho 0.8),
4000 + 6000 sweeps. Difference proposals come from the archive of past
states, and about 10% of moves are snooker (line) moves, so the tiny
population inherits the archive's geometry instead of being rank-limited
by its own size.

--quick: 500 + 1000 sweeps.
"""

from _common import emit, setup

args = setup(__doc__)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import mcmc_tpu_torch as mt  # noqa: E402

burn, keep = (500, 1000) if args.quick else (4000, 6000)
d = 20
rho = 0.8
cov = rho * np.ones((d, d)) + (1 - rho) * np.eye(d)
P = torch.as_tensor(np.linalg.inv(cov), dtype=torch.float32,
                    device=args.device)


def log_kernel(x):
    return -0.5 * (x * (x @ P)).sum(-1)


out = mt.demcz(
    np.zeros(d), log_kernel,
    mt.DEMCZSettings(n_pop=8, n_burnin_draws=burn, n_keep_draws=keep),
    key=0, device=args.device)

pooled = out.draws.reshape(-1, d).double().cpu().numpy()
accept = float(out.n_accept_draws) / (keep * 8)
var = float(pooled.var(0).mean())
corr = float(np.corrcoef(pooled[:, 0], pooled[:, 1])[0, 1])
rhat = float(mt.diagnostics.split_rhat(out.draws).max())
print("draws:", tuple(out.draws.shape))     # (6000, 8, 20)
print("accept rate:", accept)
print("marginal var (truth 1.0):", var)
print("corr[0,1] (truth 0.8):", corr)
print("max split R-hat:", rhat)
emit(accept_rate=accept, marginal_var=var, corr01=corr, max_split_rhat=rhat)
