#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. device: a CUDA card is required; prints its name and power limit;
2. build: compiles the fused trajectory kernel from
   ``mcmc_tpu_torch/csrc`` (nvcc, sm_90a) and prints the build time;
3. kernel against its plain PyTorch version at the flagship shapes (16384
   chains, 100 dims, 1000 observations, 4 leapfrogs at step 0.01) for each
   built-in link: max errors against the stated tolerances, padded columns
   exactly zero, and the median time of each;
4. the fused main path: ``fused_glm_hmc`` at 16384 chains for 600
   transitions, with the kernel's launch count, acceptance, leapfrog
   steps/s, max split R-hat and min ESS;
5. the generic ``hmc`` at 1024 chains over the same transitions, whose
   posterior mean must agree with the fused run's within 0.3.

The last two lines of output are the kernels' JSON record and the result
line ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_CHAINS = 16384
DIM = 100
N_DATA = 1000
N_LEAP = 4
STEP_SIZE = 0.01
PRIOR_SCALE = 10.0
LINKS = ("logistic", "poisson", "linear", "probit")
# kernel vs plain version: only the summation order differs, but at these
# shapes the two f32 sums round z to different bf16 neighbours at a few of
# the ~8M rounding points, and the chain where that happens then differs by
# one bf16 step of z times the curvature (largest for poisson). Errors are
# taken per chain relative to each output's scale (max|dz| / max(1,
# max|z|), likewise p; |dU| / max|U|): 99% of chains must agree to TOL_BULK
# (a wrong rounding point or a wrong link moves every chain), and every
# chain to TOL_MAX (the bound of those rare bf16 neighbours).
TOL_BULK = 1e-5
TOL_MAX = 1e-2
N_BURNIN, N_KEEP, STEPS_PER_DRAW = 100, 200, 2
HMC_CHAINS = 1024
MEAN_ATOL = 0.3


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fns, reps=10, calls=10):
    """Median over ``reps`` CUDA-event windows of ``calls`` back-to-back
    calls, per call, for each of ``fns`` after one warm call each; the
    windows run in turns (a, b, b, a, ...) so that drift hits both alike."""
    times = [[] for _ in fns]
    for f in fns:
        f()
    order = list(range(len(fns)))
    for r in range(reps):
        for i in (order if r % 2 == 0 else order[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fns[i]()
            end.record()
            end.synchronize()
            times[i].append(start.elapsed_time(end) / calls)
    return [float(np.median(t)) for t in times]


def link_data(name, X, beta, rng):
    """Responses of each family for the data ``X`` and coefficients
    ``beta`` (logistic uses the data's own)."""
    eta = X.cpu().double() @ beta.cpu().double()
    if name == "probit":
        y = rng.uniform(size=N_DATA) < torch.special.ndtr(eta).numpy()
    elif name == "poisson":
        y = rng.poisson(np.exp(eta.numpy()))
    else:
        y = eta.numpy() + 0.5 * rng.standard_normal(N_DATA)
    return torch.tensor(np.asarray(y, np.float64), dtype=torch.float32,
                        device=X.device)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mcmc_tpu_torch import diagnostics, fused_glm_hmc, hmc, HMCSettings
    from mcmc_tpu_torch.models import (logistic_regression_model,
                                       make_logistic_regression_data)
    from mcmc_tpu_torch.ops import _cuda
    from mcmc_tpu_torch.ops import fused_logreg as fl

    # f32 matmuls of the plain versions in full f32, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(card_line())
    print(f"device: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    # --- build
    t0 = time.perf_counter()
    _cuda.load()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_cuda.build_seconds and round(_cuda.build_seconds, 1)} s)")
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # --- kernel vs plain version, flagship shapes
    X, y, beta = make_logistic_regression_data(0, N_DATA, DIM, device=dev)
    rng = np.random.default_rng(1)
    gen = torch.Generator(device=dev).manual_seed(2)
    max_abs_err, max_scaled_err, timing = 0.0, 0.0, {}
    for name in LINKS:
        yl = y if name == "logistic" else link_data(name, X, beta, rng)
        traj = fl.make_fused_trajectory(X, yl, PRIOR_SCALE, STEP_SIZE, N_LEAP,
                                        link=name, device=dev)
        dp = traj.dim_padded
        z = torch.zeros((N_CHAINS, dp), device=dev)
        p = torch.zeros((N_CHAINS, dp), device=dev)
        z[:, :DIM] = beta + 0.3 * torch.randn((N_CHAINS, DIM), generator=gen,
                                              device=dev)
        p[:, :DIM] = torch.randn((N_CHAINS, DIM), generator=gen, device=dev)
        args = (traj.Xb, traj.y, traj.mask, traj.inv_pv, STEP_SIZE, N_LEAP,
                name)
        zk, pk, uk = fl.fused_trajectory_cuda(z, p, *args)
        zp, pp, up = fl._fused_trajectory_plain(z, p, *args)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(zk).all() and torch.isfinite(uk).all()),
              f"{name}: kernel output finite")
        abs_err = max(float((zk - zp).abs().max()),
                      float((pk - pp).abs().max()))
        per_chain = torch.stack([
            (zk - zp).abs().amax(dim=1) / zp.abs().max().clamp_min(1),
            (pk - pp).abs().amax(dim=1) / pp.abs().max().clamp_min(1),
            (uk - up).abs() / up.abs().max()]).amax(dim=0)
        err_q99 = float(torch.quantile(per_chain, 0.99))
        err_max = float(per_chain.max())
        n_off = int((per_chain > TOL_BULK).sum())
        pad_zero = bool((zk[:, DIM:] == 0).all() and (pk[:, DIM:] == 0).all())
        ms, plain_ms = median_ms([
            lambda: fl.fused_trajectory_cuda(z, p, *args),
            lambda: fl._fused_trajectory_plain(z, p, *args)])
        timing[name] = (ms, plain_ms)
        print(f"K1 {name}: max abs error of z, p {abs_err:.3e}; per-chain "
              f"scaled error: 99th percentile {err_q99:.3e} (tol "
              f"{TOL_BULK:g}), max {err_max:.3e} (tol {TOL_MAX:g}), "
              f"{n_off} of {N_CHAINS} chains above {TOL_BULK:g}; padded "
              f"columns zero: {pad_zero}; kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms per trajectory (median of 10 windows of "
              f"10 calls)")
        check(err_q99 <= TOL_BULK, f"{name}: 99% of chains within {TOL_BULK}")
        check(err_max <= TOL_MAX, f"{name}: every chain within {TOL_MAX}")
        check(pad_zero, f"{name}: padded columns exactly zero")
        max_abs_err = max(max_abs_err, abs_err)
        max_scaled_err = max(max_scaled_err, err_max)
        del z, p, zk, pk, uk, zp, pp, up

    # --- the fused main path at full width
    n_trans = (N_BURNIN + N_KEEP) * STEPS_PER_DRAW
    fl.fused_trajectory_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fused_glm_hmc(X, y, prior_scale=PRIOR_SCALE, step_size=STEP_SIZE,
                        n_leap=N_LEAP, n_chains=N_CHAINS,
                        n_burnin_draws=N_BURNIN, n_keep_draws=N_KEEP,
                        steps_per_draw=STEPS_PER_DRAW, key=11, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fl.fused_trajectory_cuda.launches
    check(launches == n_trans, f"{launches} kernel launches for {n_trans} "
          "transitions")
    check(tuple(out.draws.shape) == (N_KEEP, N_CHAINS, DIM), "draws shape")
    check(bool(torch.isfinite(out.draws).all()), "draws finite")
    accept = float(out.diagnostics["accept_rate_per_chain"].mean())
    check(0.5 < accept <= 1.0, f"accept rate {accept} in (0.5, 1]")
    rhat = float(diagnostics.split_rhat(out.draws).max())
    ess = float(diagnostics.ess(out.draws, chain_chunk=1024).min())
    rate = n_trans * N_LEAP * N_CHAINS / seconds
    print(f"fused_glm_hmc: {N_CHAINS} chains, {n_trans} transitions in "
          f"{seconds:.3f} s, {launches} kernel launches; accept {accept:.4f}; "
          f"{rate:.4e} leapfrog steps/s; max split R-hat {rhat:.4f}; "
          f"min ESS {ess:.1f} (of {N_KEEP * N_CHAINS} draws)")
    fused_mean = out.draws.mean(dim=(0, 1))
    del out

    # --- generic HMC over the same transitions, same start distribution
    gen = torch.Generator(device=dev).manual_seed(12)
    init = 0.05 * torch.randn((HMC_CHAINS, DIM), generator=gen, device=dev)
    settings = HMCSettings(n_burnin_draws=N_BURNIN * STEPS_PER_DRAW,
                           n_keep_draws=N_KEEP * STEPS_PER_DRAW,
                           step_size=STEP_SIZE, n_leap_steps=N_LEAP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = hmc(init, logistic_regression_model(X, y, PRIOR_SCALE), settings,
              key=13)
    torch.cuda.synchronize()
    diff = float((ref.draws.mean(dim=(0, 1)) - fused_mean).abs().max())
    print(f"hmc: {HMC_CHAINS} chains, {n_trans} transitions in "
          f"{time.perf_counter() - t0:.3f} s; accept "
          f"{float(ref.accept_rate.mean()):.4f}; max |mean - fused mean| "
          f"{diff:.4f} (tol {MEAN_ATOL})")
    check(diff <= MEAN_ATOL, f"hmc mean within {MEAN_ATOL} of the fused mean")

    ms, plain_ms = timing["logistic"]
    print(json.dumps({"kernels": [{
        "name": "fused_glm_trajectory", "route": "cuda",
        "source": "mcmc_tpu_torch/csrc/fused_glm_trajectory.cu",
        "replaces": "mcmc_tpu/ops/fused_logreg.py:163",
        "launches": launches, "max_abs_err": max_abs_err,
        "max_scaled_err": max_scaled_err, "ms": ms, "plain_ms": plain_ms,
        "ms_by_link": {k: v[0] for k, v in timing.items()},
        "plain_ms_by_link": {k: v[1] for k, v in timing.items()},
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
