"""How fast chip_smoke.py's wide Gaussian paths converge, in exact arithmetic.

Runs the transition of ``fused_gaussian_hmc`` (unit mass, one step size
jittered by ``G_JITTER`` and shared by the chains each transition, ``G_LEAP``
leapfrogs of ``G_STEP``, Metropolis on the total energy) in float64 on
``ill_conditioned_gaussian(dim, 1e4)``'s diagonal precision, from
``G_INIT_SCALE`` N(0, 1). HMC with unit mass is invariant under rotation,
so the dense rotations that the paths run behave as this diagonal does. It
prints, for each window of transitions, the acceptance and the ensemble's
mean of x^2 / variance minus 1 in bands of the marginal sd (0 at
convergence), and the acceptance from the stationary distribution: what
sets a path's burn-in and acceptance floor. The chip_smoke.py constants
are read from the script.

    python3 scripts/torch_gaussian_path_burnin.py --dim 2000 --chains 512 \\
        --transitions 750

(on the CPU about seven minutes at these settings; ``--device cuda`` on a
card).
"""

import argparse
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dim", type=int, default=2000)
    ap.add_argument("--chains", type=int, default=512)
    ap.add_argument("--transitions", type=int, default=750)
    ap.add_argument("--window", type=int, default=50)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    dev = torch.device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    f64 = dict(dtype=torch.float64, device=dev)
    var = torch.logspace(0.0, 4.0, args.dim, **f64)
    sd = var.sqrt()
    bands = [float(b) for b in (1, 2.5, 6.3, 15.8, 39.8, 100.01)]

    def transition(z, u_z):
        p = torch.randn((args.chains, args.dim), generator=gen, **f64)
        jitter = 2.0 * torch.rand((), generator=gen, **f64) - 1.0
        eps = cs.G_STEP * (1.0 + cs.G_JITTER * jitter)
        k0 = 0.5 * (p * p).sum(1)
        x = z.clone()
        g = -x / var
        for _ in range(cs.G_LEAP):
            p = p + 0.5 * eps * g
            x = x + eps * p
            g = -x / var
            p = p + 0.5 * eps * g
        u_x = 0.5 * (x * x / var).sum(1)
        log_a = torch.clamp((u_z + k0) - (u_x + 0.5 * (p * p).sum(1)), max=0)
        accept = torch.rand((args.chains,), generator=gen, **f64) < log_a.exp()
        return (torch.where(accept[:, None], x, z),
                torch.where(accept, u_x, u_z), float(accept.double().mean()))

    print(f"dim {args.dim}, {args.chains} chains, step {cs.G_STEP} jittered "
          f"by {cs.G_JITTER}, {cs.G_LEAP} leapfrogs, from {cs.G_INIT_SCALE} "
          "N(0, 1); per window: acceptance, then mean x^2 / variance - 1 by "
          "sd band " + ", ".join(f"[{a:g}, {b:g})" for a, b in
                                 zip(bands, bands[1:])))
    for start in ("path", "stationary"):
        scale = cs.G_INIT_SCALE if start == "path" else sd
        z = scale * torch.randn((args.chains, args.dim), generator=gen, **f64)
        u_z = 0.5 * (z * z / var).sum(1)
        acc, second = [], []
        for t in range(args.transitions):
            z, u_z, a = transition(z, u_z)
            acc.append(a)
            second.append((z * z / var).mean(0))
            if (t + 1) % args.window == 0:
                y = torch.stack(second)
                w = sum(acc) / len(acc)
                cols = " ".join(
                    f"{float(y[:, (sd >= a) & (sd < b)].mean() - 1):+.4f}"
                    for a, b in zip(bands, bands[1:]))
                print(f"{start} transitions {t + 2 - args.window}-{t + 1}: "
                      f"accept {w:.4f}; {cols}", flush=True)
                acc, second = [], []
            if start == "stationary" and t + 1 == 2 * args.window:
                break


if __name__ == "__main__":
    main()
