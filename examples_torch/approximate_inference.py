"""The approximate-inference family on one model: Laplace, Pathfinder,
ADVI (mean-field and full-rank) and SVGD, cross-checked against the exact
conjugate posterior and a ChEES run; the port's rendition of
``examples/approximate_inference.py``.

No counterpart in the reference: MCMCLib samples or nothing. Model:
Bayesian linear regression with known noise (sd 0.5), n = 200, d = 8,
prior N(0, I), whose posterior is exactly Gaussian, so every method's error
is measurable. Laplace 800 Adam steps; Pathfinder 4 paths, 4000 draws;
ADVI 2000 (mean-field) and 3000 (full-rank) steps; SVGD 512 particles,
1500 steps; ChEES through ``fit``, 16 chains, 500 + 500.

--quick: Laplace 200 steps; Pathfinder 1000 draws; ADVI 300 and 300
steps; SVGD 128 particles, 150 steps; ChEES 8 chains, 100 + 100.
"""

from _common import emit, setup

args = setup(__doc__)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import mcmc_tpu_torch as mt  # noqa: E402

q = args.quick
rng = np.random.default_rng(0)
n, d, sig = 200, 8, 0.5
X_np = rng.standard_normal((n, d)).astype(np.float32)
w_true = np.linspace(-1.0, 1.0, d)
y_np = (X_np @ w_true + sig * rng.standard_normal(n)).astype(np.float32)
X = torch.as_tensor(X_np, device=args.device)
y = torch.as_tensor(y_np, device=args.device)

# prior N(0, I); exact posterior N(mu_n, S_n)
X64, y64 = X_np.astype(np.float64), y_np.astype(np.float64)
S_n = np.linalg.inv(np.eye(d) + X64.T @ X64 / sig ** 2)
mu_n = S_n @ (X64.T @ y64) / sig ** 2


def log_kernel(w):
    r = y - w @ X.T
    return -0.5 * (r ** 2).sum(-1) / sig ** 2 - 0.5 * (w ** 2).sum(-1)


def err(mean, cov):
    mean = mean.double().cpu().numpy() if torch.is_tensor(mean) else mean
    cov = cov.double().cpu().numpy() if torch.is_tensor(cov) else cov
    return (float(np.abs(mean - mu_n).max()), float(np.abs(cov - S_n).max()))


errors = {}
lap = mt.map_laplace(np.zeros(d), log_kernel, n_steps=200 if q else 800,
                     key=1, device=args.device)
e = errors["laplace"] = err(lap.mode, lap.cov)
print(f"laplace          mean err {e[0]:.4f}  cov err {e[1]:.4f}")

pf = mt.pathfinder(np.zeros(d), log_kernel, n_paths=4,
                   n_draws=1000 if q else 4000, key=2, device=args.device)
P = pf.draws.double().cpu().numpy()
e = errors["pathfinder"] = err(P.mean(0), np.cov(P.T))
print(f"pathfinder       mean err {e[0]:.4f}  cov err {e[1]:.4f}  "
      f"pareto-k {float(pf.pareto_k):.2f}")

mf = mt.advi(np.zeros(d), log_kernel, n_steps=300 if q else 2000, key=3,
             device=args.device)
e = errors["advi_mean_field"] = err(mf.mean, torch.diag(mf.sd_z ** 2))
print(f"advi mean-field  mean err {e[0]:.4f}  cov err {e[1]:.4f}  "
      f"(diagonal only: correlation-blind by construction)")

fr = mt.advi(np.zeros(d), log_kernel, full_rank=True,
             n_steps=300 if q else 3000, key=4, device=args.device)
L = fr.chol.double()
e = errors["advi_full_rank"] = err(fr.mean, L @ L.T)
print(f"advi full-rank   mean err {e[0]:.4f}  cov err {e[1]:.4f}  "
      f"elbo {float(fr.elbo):.2f}")

sv = mt.svgd(np.zeros(d), log_kernel, n_particles=128 if q else 512,
             n_steps=150 if q else 1500, key=5, device=args.device)
P = sv.particles.double().cpu().numpy()
e = errors["svgd"] = err(P.mean(0), np.cov(P.T))
print(f"svgd             mean err {e[0]:.4f}  cov err {e[1]:.4f}")

out = mt.fit(np.zeros(d), log_kernel, algorithm="chees",
             n_chains=8 if q else 16, n_warmup=100 if q else 500,
             n_draws=100 if q else 500, key=6, device=args.device)
D = out.draws.reshape(-1, d).double().cpu().numpy()
e = errors["chees"] = err(D.mean(0), np.cov(D.T))
print(f"chees (exact)    mean err {e[0]:.4f}  cov err {e[1]:.4f}")
emit(mean_err={k: v[0] for k, v in errors.items()},
     cov_err={k: v[1] for k, v in errors.items()},
     posterior_sd_min=float(np.sqrt(np.diag(S_n)).min()),
     pathfinder_pareto_k=pf.pareto_k, advi_full_rank_elbo=fr.elbo)
