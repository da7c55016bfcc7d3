"""The 'autodiff' example: the port's rendition of
``examples/hmc_normal_autodiff.py`` (reference examples/autodiff/
hmc_normal_autodiff.cpp, which used an external forward-mode autodiff C++
library to avoid hand-deriving gradients). In the port every gradient
sampler differentiates the user's batched torch log-kernel with autograd,
so the 'plain' and 'autodiff' versions are the same program. This script
makes the equivalence explicit: ``torch.func.grad`` of the log-kernel at
(2, 2) beside the hand-derived gradient, then HMC at step 0.08,
2000 + 2000 draws.

--quick: 300 + 300 draws.
"""

import math

from _common import emit, mean_and_mcse, normal_scale_exact_mean, setup

args = setup(__doc__)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import mcmc_tpu_torch as mt  # noqa: E402

n_draws = 300 if args.quick else 2000
x_np = 2.0 + 2.0 * np.random.default_rng(4).standard_normal(1000)
x_data = torch.as_tensor(x_np, dtype=torch.float32, device=args.device)


def log_kernel(params):
    """Written with no hand-coded gradient anywhere: autograd supplies it.
    Batched: ``(n_chains, 2) -> (n_chains,)``."""
    mu, sigma = params[..., 0], params[..., 1]
    n = x_data.shape[0]
    return -n * (0.5 * math.log(2 * math.pi) + torch.log(sigma)) \
        - ((x_data - mu[..., None]) ** 2).sum(-1) / (2 * sigma ** 2)


at = torch.tensor([2.0, 2.0], device=args.device)
g = torch.func.grad(lambda p: log_kernel(p[None])[0])(at)
print("autodiff gradient at (2, 2):", g.cpu().numpy())
# by hand: d/dmu = sum(x - mu) / s^2, d/ds = -n / s + sum((x - mu)^2) / s^3
x64 = x_data.double().cpu().numpy()
g_hand = np.array([(x64 - 2.0).sum() / 4.0,
                   -len(x64) / 2.0 + ((x64 - 2.0) ** 2).sum() / 8.0])
print("hand-derived gradient      :", g_hand)

out = mt.hmc(
    np.array([3.0, 3.0]), log_kernel,
    mt.HMCSettings(step_size=0.08, n_burnin_draws=n_draws,
                   n_keep_draws=n_draws),
    device=args.device)
mean, mcse = mean_and_mcse(out.draws)
print("hmc (autodiff) mean:", out.mean.cpu().numpy())
print("acceptance rate:", float(out.accept_rate))
emit(grad=g, grad_by_hand=g_hand, mean=mean, mcse=mcse,
     exact_mean=normal_scale_exact_mean(x_np), accept_rate=out.accept_rate)
