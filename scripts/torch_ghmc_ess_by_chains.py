"""GHMC's ESS per kept draw by chain count, on an NVIDIA GPU and its host.

Runs the bench's GHMC protocol on the flagship posterior (``chip_smoke.py``
phase 12: step 0.05, persistence 0.98, 3 leapfrogs, thin 4, per-chain dual
averaging to 0.95 over the first 1000 transitions, 1000 warmup sweeps and
1000 kept draws) at 4096 and 512 chains on the card, at 128 on the CPU, and
at 4096 without jitter; prints each run's min and median ESS per kept draw
(on the card and, from the same draws, on the host), those of its first 512
chains, acceptance, adapted step sizes and lag-1 autocorrelations. From the
repository root, with a card:

    python3 scripts/torch_ghmc_ess_by_chains.py
"""

import os
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mcmc_tpu_torch import diagnostics as td, integrators as ti  # noqa: E402
from mcmc_tpu_torch.models import (logistic_regression_model,  # noqa: E402
                                   make_logistic_regression_data)
from mcmc_tpu_torch.samplers import common as tc  # noqa: E402
from mcmc_tpu_torch.samplers.ghmc import build_ghmc_kernel  # noqa: E402


def ess_per_draw(draws, keep, chains):
    chunk = 256 if chains > 256 else None
    e = td.ess(draws, chain_chunk=chunk).cpu().numpy() / (keep * chains)
    return e.min(), np.median(e)


def run(dev, chains, seed=51, warm=1000, keep=1000, jitter=0.2):
    X, y, _ = make_logistic_regression_data(0, 1000, 100, device=dev)
    lk = logistic_regression_model(X, y, 10.0)
    init, step = build_ghmc_kernel(
        lk, ti.grad_of(lk), tc.make_spd(None, 100, torch.float32, dev), 0.05,
        0.98, 3, jitter, {"n_burnin": warm, "target": 0.95})
    gen = torch.Generator(device=dev).manual_seed(seed)
    st = init(0.05 * torch.randn((chains, 100), generator=gen, device=dev))
    t0 = time.time()
    st, draws, infos = tc.run_sampler_loop(gen, st, step, warm, keep,
                                           lambda s: s.position, thin=4)
    if dev == "cuda":
        torch.cuda.synchronize()
    secs = time.time() - t0
    e_min, e_med = ess_per_draw(draws, keep, chains)
    h_min, h_med = ess_per_draw(draws.cpu(), keep, chains)
    eps = torch.exp(st.da.log_eps_bar).cpu()
    accept = float(infos["accepted"].float().mean()) / 4
    print(f"{dev} {chains} chains jitter {jitter}: {secs:.1f} s; ESS/draw min "
          f"{e_min:.3f} median {e_med:.3f} (on the host: {h_min:.3f} "
          f"{h_med:.3f}); accept {accept:.4f}; step min {float(eps.min()):.3f}"
          f" median {float(eps.median()):.3f} max {float(eps.max()):.3f}; "
          f"mean {float(draws.mean()):.5f}; split rhat "
          f"{float(td.split_rhat(draws).max()):.4f}", flush=True)
    if chains >= 512:
        s_min, s_med = ess_per_draw(draws[:, :512], keep, 512)
        print(f"   first 512 chains: ESS/draw min {s_min:.3f} median "
              f"{s_med:.3f}", flush=True)
    x1 = draws[1:].double() - draws[1:].double().mean((0, 1))
    x0 = draws[:-1].double() - draws[:-1].double().mean((0, 1))
    r1 = ((x1 * x0).mean((0, 1)) / (x0 * x0).mean((0, 1))).cpu().numpy()
    print(f"   lag-1 autocorrelation per dim: min {r1.min():.3f} median "
          f"{np.median(r1):.3f} max {r1.max():.3f}", flush=True)


def main():
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    run("cuda", 4096)
    run("cuda", 512)
    run("cpu", 128)
    run("cuda", 4096, jitter=0.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
