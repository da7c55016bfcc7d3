"""The full Bayesian workflow in one script: fit with convergence gates,
posterior summary, posterior-predictive check, model comparison by
PSIS-LOO, and simulation-based calibration of the sampler itself; the
port's rendition of ``examples/bayesian_workflow.py`` (no reference analog:
MCMCLib stops at the draw matrix).

Model: y_i ~ N(beta . x_i, sigma^2) linear regression (n = 200, p = 3,
beta (1.5, -2, 0.7), sigma 0.5) with a misspecified alternative (drop a
covariate) to give the comparison something to rank. The fit: NUTS, 8
chains, 800 warmup + 1000 draws, gated on R-hat 1.01 and ESS 400; SBC: 16
simulations, each a 4-chain fit of 400 + 256 draws, 31 rank draws thinned
by 8 into 8 bins.

--quick: fits of 4 chains, 100 + 100 draws (no gates); SBC 4 simulations of
2-chain fits, 50 + 32 draws, 7 rank draws thinned by 8 into 4 bins.
"""

import math

from _common import emit, setup

args = setup(__doc__)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import mcmc_tpu_torch as mt  # noqa: E402

q = args.quick
dev = args.device
# ---- data -----------------------------------------------------------------
n, p = 200, 3
X_np = np.random.default_rng(0).standard_normal((n, p)).astype(np.float32)
beta_true = np.array([1.5, -2.0, 0.7])
sigma_true = 0.5
y_np = (X_np @ beta_true + sigma_true
        * np.random.default_rng(1).standard_normal(n)).astype(np.float32)
X = torch.as_tensor(X_np, device=dev)
y = torch.as_tensor(y_np, device=dev)


def make_model(Xd, yd=None):
    def log_kernel(params):     # params = (beta..., log_sigma), batched
        beta, log_s = params[:, :-1], params[:, -1]
        s2 = torch.exp(2.0 * log_s)
        resid = (y if yd is None else yd) - beta @ Xd.T
        return (-0.5 * (resid ** 2).sum(-1) / s2 - n * log_s
                - 0.5 * (beta ** 2).sum(-1) / 10.0 - 0.5 * log_s ** 2 / 4.0)
    return log_kernel


fit_kw = dict(n_chains=4, n_warmup=100, n_draws=100) if q else \
    dict(n_chains=8, n_warmup=800, n_draws=1000)
# ---- 1. fit with convergence gates -----------------------------------------
fit = mt.fit(np.zeros(p + 1), make_model(X), key=2, device=dev,
             **({} if q else dict(rhat_target=1.01, min_ess=400)), **fit_kw)
summ = fit.diagnostics["summary"]
print("converged:", fit.diagnostics.get("converged"),
      "in", fit.diagnostics.get("n_rounds"), "round(s)")
print("beta posterior means:", summ["mean"][:p].cpu().numpy().round(3),
      "(truth", beta_true.round(3), ")")


# ---- 2. posterior predictive check ------------------------------------------
def predictive(gen, par):
    return par[:, :-1] @ X.T + torch.exp(par[:, -1:]) * torch.randn(
        (par.shape[0], n), generator=gen, device=par.device)


pp = mt.posterior_predictive(fit, predictive, key=3)
y_rep = pp.reshape(-1, n).double()
stat_obs = float(y.double().std(unbiased=False))
stat_rep = y_rep.std(dim=1, unbiased=False)
ppp = float((stat_rep > stat_obs).double().mean())
print("posterior predictive p-value for sd(y):", round(ppp, 3),
      "(calibrated ~ 0.5)")


# ---- 3. model comparison: full model vs one dropped covariate ---------------
def loglik_fn(Xd):
    return lambda par: (-0.5 * (y - par[:, :-1] @ Xd.T) ** 2
                        / torch.exp(2.0 * par[:, -1:])
                        - par[:, -1:] - 0.5 * math.log(2.0 * math.pi))


fit_red = mt.fit(np.zeros(p), make_model(X[:, :2]), key=4, device=dev,
                 **fit_kw)
loo_full = mt.psis_loo(mt.pointwise_log_lik(fit.draws, loglik_fn(X)))
loo_red = mt.psis_loo(mt.pointwise_log_lik(fit_red.draws,
                                           loglik_fn(X[:, :2])))
rank = mt.compare({"full": loo_full, "reduced": loo_red})
print("PSIS-LOO ranking:", [(r["name"], round(float(r["elpd_diff"]), 1))
                            for r in rank])


# ---- 4. calibrate the sampler itself (SBC) ----------------------------------
def prior(gen):
    return torch.cat([
        math.sqrt(10.0) * torch.randn(p, generator=gen, device=dev),
        2.0 * torch.randn(1, generator=gen, device=dev)])


def sim(gen, th):
    return X @ th[:p] + torch.exp(th[p]) * torch.randn(n, generator=gen,
                                                        device=dev)


sbc_fit = dict(n_chains=2, n_warmup=50, n_draws=32) if q else \
    dict(n_chains=4, n_warmup=400, n_draws=256)


def post(gen, data):
    return mt.fit(np.zeros(p + 1), make_model(X, data), key=gen,
                  device=dev, **sbc_fit).draws


# 16 sims: each is a full sequential fit(), so this phase dominates the
# wall clock; 16 keeps the uniformity check meaningful (chi-squared over 8
# bins); raise n_sims for a publication-grade calibration
sbc_kw = dict(n_sims=4, n_rank_draws=7, thin=8, n_bins=4) if q else \
    dict(n_sims=16, n_rank_draws=31, thin=8, n_bins=8)
r = mt.sbc(5, prior, sim, post, device=dev, **sbc_kw)
pv = r["p_value"]
print("SBC uniformity p-values per dim:",
      torch.as_tensor(pv).cpu().numpy().round(3), "(all should be >> 0.01)")
emit(converged=fit.diagnostics.get("converged"),
     n_rounds=fit.diagnostics.get("n_rounds"), beta_mean=summ["mean"][:p],
     beta_true=beta_true, beta_sd=summ["sd"][:p],
     max_rank_rhat=summ["rhat_rank"].max(), min_ess=summ["ess"].min(),
     ppp_sd=ppp, loo_ranking=[r_["name"] for r_ in rank],
     elpd_diff=rank[1]["elpd_diff"], se_diff=rank[1]["se_diff"],
     sbc_p_values=pv, sbc_min_p=torch.as_tensor(pv).min())
