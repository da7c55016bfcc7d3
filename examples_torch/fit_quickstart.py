"""The one-call API: automatic warmup (pooled step-size and mass-matrix
adaptation) and a full diagnostic summary; the port's rendition of
``examples/fit_quickstart.py``. No counterpart in the reference, whose
settings are all fixed by the caller. Eight schools (non-centred), 8
chains, 1000 warmup + 1000 draws of NUTS.

--quick: 4 chains, 100 + 100 draws.
"""

from _common import emit, setup

args = setup(__doc__)
import numpy as np  # noqa: E402

import mcmc_tpu_torch as mt  # noqa: E402
from mcmc_tpu_torch import models  # noqa: E402

chains, warm, draws = (4, 100, 100) if args.quick else (8, 1000, 1000)
log_kernel = models.eight_schools_model(device=args.device)

out = mt.fit(np.zeros(10), log_kernel, n_chains=chains, n_warmup=warm,
             n_draws=draws, key=0, device=args.device)

s = out.diagnostics["summary"]
print("posterior mean:", s["mean"].cpu().numpy())
print("mcse:", s["mcse"].cpu().numpy())
print("split R-hat:", s["rhat"].cpu().numpy())
print("ESS:", s["ess"].cpu().numpy())
emit(mean=s["mean"], mcse=s["mcse"], max_split_rhat=s["rhat"].max(),
     min_ess_per_draw=s["ess"].min() / (chains * draws))
