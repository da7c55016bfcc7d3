"""Model comparison with PSIS-LOO: fit two regression models to the same
data, score their pointwise predictive densities over the posterior draws,
and rank them by elpd with paired standard errors; the port's rendition of
``examples/model_comparison.py``.

No counterpart in the reference: MCMCLib returns draws and stops; here the
draws flow straight into cross-validated model assessment (Vehtari, Gelman
& Gabry 2017). Data: y = 0.8 + 1.5 x + 0.7 N(0, 1) over 80 points; model A
linear, model B intercept-only (misspecified); each fit by NUTS through
``fit``, 8 chains, 500 warmup + 1000 draws.

--quick: 4 chains, 100 + 100 draws.
"""

import math

from _common import emit, setup

args = setup(__doc__)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import mcmc_tpu_torch as mt  # noqa: E402

chains, warm, draws = (4, 100, 100) if args.quick else (8, 500, 1000)
rng = np.random.default_rng(0)
n = 80
x_np = rng.standard_normal(n)
y_np = 0.8 + 1.5 * x_np + 0.7 * rng.standard_normal(n)
x = torch.as_tensor(x_np, dtype=torch.float32, device=args.device)
y = torch.as_tensor(y_np, dtype=torch.float32, device=args.device)


def loglik_linear(th):
    """``(B, 3) -> (B, n)`` pointwise log-likelihood."""
    mu = th[:, :1] + th[:, 1:2] * x
    sig2 = torch.exp(th[:, 2:3]) ** 2
    return -0.5 * (torch.log(2 * math.pi * sig2) + (y - mu) ** 2 / sig2)


def loglik_const(th):
    sig2 = torch.exp(th[:, 1:2]) ** 2
    return -0.5 * (torch.log(2 * math.pi * sig2) + (y - th[:, :1]) ** 2
                   / sig2)


def posterior(loglik_fn, dim):
    def log_kernel(th):
        return loglik_fn(th).sum(-1) - 0.5 * (th ** 2).sum(-1) / 100.0
    return mt.fit(np.zeros(dim), log_kernel, n_chains=chains,
                  n_warmup=warm, n_draws=draws, key=1, device=args.device)


out_a = posterior(loglik_linear, 3)
out_b = posterior(loglik_const, 2)

loo_a = mt.psis_loo(mt.pointwise_log_lik(out_a.draws, loglik_linear))
loo_b = mt.psis_loo(mt.pointwise_log_lik(out_b.draws, loglik_const))

for name, loo in (("linear:   ", loo_a), ("intercept:", loo_b)):
    print(f"{name} elpd = {float(loo['elpd']):8.1f} +- "
          f"{float(loo['se']):.1f}  p_eff = {float(loo['p_eff']):.1f}  "
          f"max pareto_k = {float(loo['pareto_k'].max()):.2f}")

ranking = mt.compare({"linear": loo_a, "intercept-only": loo_b})
for r in ranking:
    print(f"rank {r['rank']}: {r['name']:15s} elpd_diff = "
          f"{float(r['elpd_diff']):6.1f} +- {float(r['se_diff']):.1f}")
emit(elpd={"linear": loo_a["elpd"], "intercept": loo_b["elpd"]},
     p_eff={"linear": loo_a["p_eff"], "intercept": loo_b["p_eff"]},
     max_pareto_k={"linear": loo_a["pareto_k"].max(),
                   "intercept": loo_b["pareto_k"].max()},
     ranking=[r["name"] for r in ranking],
     elpd_diff=ranking[1]["elpd_diff"], se_diff=ranking[1]["se_diff"],
     linear_mean=out_a.diagnostics["summary"]["mean"])
