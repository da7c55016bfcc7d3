"""Compositional block-Gibbs on a semi-conjugate hierarchical model; the
port's rendition of ``examples/gibbs_semi_conjugate.py``.

Sixteen-groups random-effects model (a hierarchical normal):

    theta_j | mu, tau ~ N(mu, tau^2)        j = 1..16  (group effects)
    y_j | theta_j     ~ N(theta_j, s_j^2)              (observed)
    mu ~ N(0, 5^2),  tau ~ half-N(0, 8^2)

The theta_j conditionals are exactly Gaussian (conjugate), so the Gibbs
sweep draws them exactly (zero rejections, zero tuning) while the
non-conjugate (mu, log tau) block runs an HMC kernel (step 0.1, 8
leapfrogs) on its conditional. 64 chains, 2000 + 4000 sweeps. This mixed
exact/HMC composition is the classic pattern no monolithic sampler
(reference or otherwise) can express.

(The group count/noise here keep tau identified away from zero; a
weakly-identified tau, the eight-schools funnel, mixes slowly under any
centered-parameterization Gibbs sweep, which is a property of the
posterior, not of the composition.)

--quick: 16 chains, 200 + 400 sweeps.

Run: python examples_torch/gibbs_semi_conjugate.py
"""

import _common

args = _common.setup(__doc__)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import mcmc_tpu_torch as mt  # noqa: E402

chains, burn, keep = (16, 200, 400) if args.quick else (64, 2000, 4000)
dev = args.device
# synthetic data: 16 groups, true mu = 4, tau = 6, obs noise s_j = 4
J = 16
rng = np.random.default_rng(42)
sigma = torch.full((J,), 4.0, device=dev)
theta_true = 4.0 + 6.0 * rng.standard_normal(J)
y = torch.as_tensor(theta_true + 4.0 * rng.standard_normal(J),
                    dtype=torch.float32, device=dev)

# parameter vector: [theta_1..theta_J, mu, log_tau]
IDX_THETA = list(range(J))
IDX_HYPER = [J, J + 1]


def log_kernel(v):
    theta, mu, log_tau = v[:, :J], v[:, J], v[:, J + 1]
    tau = torch.exp(log_tau)
    lp = -0.5 * ((y - theta) ** 2 / sigma ** 2).sum(-1)
    lp = lp - 0.5 * ((theta - mu[:, None]) ** 2).sum(-1) / tau ** 2 \
        - J * log_tau
    lp = lp - 0.5 * mu ** 2 / 25.0
    return lp - 0.5 * tau ** 2 / 64.0 + log_tau  # half-normal + Jacobian


def cond_theta(gen, full):
    """Exact conjugate conditional: theta_j | mu, tau, y_j is Gaussian with
    precision 1/s_j^2 + 1/tau^2."""
    mu, tau = full[:, J:J + 1], torch.exp(full[:, J + 1:J + 2])
    prec = 1.0 / sigma ** 2 + 1.0 / tau ** 2
    mean = (y / sigma ** 2 + mu / tau ** 2) / prec
    return mean + torch.randn(mean.shape, generator=gen, dtype=full.dtype,
                              device=full.device) / torch.sqrt(prec)


def main():
    out = mt.gibbs(
        np.zeros(J + 2), log_kernel,
        mt.GibbsSettings(n_burnin_draws=burn, n_keep_draws=keep),
        blocks=[
            (IDX_THETA, cond_theta),                       # exact draws
            (IDX_HYPER, "hmc", {"step_size": 0.1, "n_leap_steps": 8}),
        ],
        n_chains=chains, key=0, device=dev)
    # note: the centered parameterization couples theta and tau (the
    # eight-schools funnel), so tau mixes slowest: more sweeps, not a
    # different block kernel, is the lever here

    d = out.draws.reshape(-1, J + 2).double().cpu().numpy()
    rate = out.diagnostics["block_accept_rate"].double().mean(0).cpu()
    print(f"block methods      : {out.diagnostics['block_methods']}")
    print(f"block accept rates : theta(exact)={float(rate[0]):.3f} "
          f"hyper(hmc)={float(rate[1]):.3f}")
    print(f"posterior mu       : {d[:, J].mean():6.2f} "
          f"+- {d[:, J].std():.2f}")
    print(f"posterior tau      : {np.exp(d[:, J + 1]).mean():6.2f}")
    print(f"theta_1 (shrunk)   : {d[:, 0].mean():6.2f}  "
          f"(raw y_1 = {float(y[0]):.1f})")
    summ = mt.diagnostics.summary(out.draws[:, :, [J, J + 1]])
    print("hyper R-hat        :", summ["rhat"].cpu().numpy().round(3))
    _common.emit(block_accept_rate=rate, mu_mean=d[:, J].mean(),
                 mu_sd=d[:, J].std(), tau_mean=np.exp(d[:, J + 1]).mean(),
                 theta1_mean=d[:, 0].mean(), y1=y[0],
                 hyper_split_rhat=summ["rhat"],
                 hyper_rank_rhat=summ["rhat_rank"])


if __name__ == "__main__":
    main()
