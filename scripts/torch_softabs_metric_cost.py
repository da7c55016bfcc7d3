"""What a SoftAbs metric evaluation costs on the card, by its two routes.

RM-HMC with ``softabs_metric`` (``examples_torch/rmhmc_funnel_softabs.py``:
Neal's funnel in 3 dimensions, 16 chains, 4 leapfrogs, 5 fixed-point
iterations) evaluates the metric ``n_leap (n_fp + 1)`` times a transition
and its derivative cube ``n_leap`` times. This script times, at those
shapes:

- ``metric_fn(x)`` and one ``torch.func.jvp`` of it (the route every
  metric has: nested ``torch.func`` transforms dispatched from the host),
  and ``torch.linalg.eigh`` of the (16, 3, 3) batch alone;
- ``metric_fn.tensor(x)`` and ``metric_fn.tensor_and_derivative(x)`` (the
  fast path: the Hessian and its cube replayed from CUDA graphs, one
  ``eigh``);
- 25 draws (5 + 20) of ``rmhmc`` through each route: the metric as given,
  and wrapped in a plain function that hides the fast path.

Each time is the mean of ``--reps`` calls after one warm call, CUDA
synchronised before the clock starts and stops. Prints one JSON line with
the card's name and power limit. From the repository root, on a machine
with the card:

    python3 scripts/torch_softabs_metric_cost.py [--reps 50]
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import mcmc_tpu_torch as mt  # noqa: E402
from mcmc_tpu_torch import models  # noqa: E402


def ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def run_seconds(metric_fn, lk, dev):
    """Seconds of 5 + 20 draws of the example's RM-HMC through
    ``metric_fn``, after one such run that captures what it captures."""
    s = mt.RMHMCSettings(n_burnin_draws=5, n_keep_draws=20, step_size=0.5,
                         n_leap_steps=4, n_fp_steps=5)
    call = lambda: mt.rmhmc(np.zeros(3), lk, metric_fn, s, n_chains=16,
                            key=0, device=dev)
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    lk = models.neals_funnel(dim=3, scale=3.0)
    m = mt.softabs_metric(lk, 1.0)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(16, 3, device=dev, generator=gen)
    e0 = torch.eye(3, device=dev)[0].expand_as(x)
    H = torch.randn(16, 3, 3, device=dev, generator=gen)
    H = H + H.transpose(-1, -2)
    out = {
        "card": card.strip(),
        "metric_ms": ms(lambda: m(x), args.reps),
        "metric_jvp_ms": ms(lambda: torch.func.jvp(m, (x,), (e0,)),
                            args.reps),
        "eigh_ms": ms(lambda: torch.linalg.eigh(H), args.reps),
        "fast_tensor_ms": ms(lambda: m.tensor(x), args.reps),
        "fast_tensor_and_derivative_ms": ms(
            lambda: m.tensor_and_derivative(x), args.reps),
        "rmhmc_25_draws_s_jvp_route": run_seconds(lambda z: m(z), lk, dev),
        "rmhmc_25_draws_s_fast_path": run_seconds(m, lk, dev),
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
