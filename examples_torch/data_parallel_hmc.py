"""Tall-data parallelism: shard the likelihood, not just the chains; the
port's rendition of ``examples/data_parallel_hmc.py``.

A (chains, data) grid mesh runs every log-density and gradient evaluation
across the data axis's ranks, with one all-reduce a call
(``parallel.data_parallel_kernel``): within-draw parallelism that the
reference's OpenMP-over-chains model cannot express (SURVEY.md §2d). A tall
logistic regression, 32,768 rows of 32 features, 8 chains of HMC (step
0.01, 16 leapfrogs, 300 + 500 draws). The grid follows the JAX example's
rule: of n ranks, n // 2 on the data axis and min(2, n // (n // 2)) on the
chains'.

Run as is, the script starts ``--nproc`` ranks (default 4: a (2, 2) grid)
on this machine that share its first card through a Gloo group; on
several cards, ``torchrun --nproc-per-node 4 data_parallel_hmc.py``.

--quick: 50 + 100 draws.
"""

from pathlib import Path

import _common

args = _common.setup(__doc__, add_args=lambda ap: _common.add_rank_args(
    ap, nproc=4))
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import mcmc_tpu_torch as mt  # noqa: E402
from mcmc_tpu_torch import parallel  # noqa: E402


def run():
    burn, keep = (50, 100) if args.quick else (300, 500)
    n_dev = dist.get_world_size() if dist.is_initialized() else 1
    n_data_dev = max(n_dev // 2, 1)
    mesh = parallel.make_grid_mesh(min(2, n_dev // n_data_dev), n_data_dev)
    rank = dist.get_rank()
    if rank == 0:
        print("mesh:", mesh)

    # tall synthetic logistic regression
    N, D = 32768, 32
    rng = np.random.default_rng(0)
    X_np = rng.standard_normal((N, D)).astype(np.float32)
    beta_true = rng.standard_normal(D) * 0.5
    y_np = (rng.uniform(size=N) < 1.0 / (1.0 + np.exp(-(X_np @ beta_true)))
            ).astype(np.float32)
    X = torch.as_tensor(X_np, device=args.device)
    y = torch.as_tensor(y_np, device=args.device)

    def log_kernel_of_data(beta, data):
        Xa, ya = data
        eta = beta @ Xa.T
        return (ya * eta - torch.nn.functional.softplus(eta)).sum(-1) \
            - 0.5 * (beta ** 2).sum(-1) / 100.0

    # observations split over the mesh's "data" axis; chains over "chains"
    log_kernel = parallel.data_parallel_kernel(log_kernel_of_data, (X, y),
                                               mesh)
    out = mt.hmc(
        np.zeros(D), log_kernel,
        mt.HMCSettings(step_size=0.01, n_leap_steps=16,
                       n_burnin_draws=burn, n_keep_draws=keep),
        n_chains=8, key=1, mesh=mesh, device=args.device)
    err = float((out.mean.double().cpu() - torch.as_tensor(beta_true))
                .abs().max())
    acc = float(out.accept_rate.mean())
    if rank == 0:
        print("accept:", acc)
        print("max |posterior mean - truth|:", err)
    return dict(rank=rank, world=n_dev, grid=[min(2, n_dev // n_data_dev),
                                              n_data_dev],
                accept_rate=acc, max_abs_mean_minus_truth=err,
                corr_with_truth=np.corrcoef(out.mean.double().cpu().numpy(),
                                            beta_true)[0, 1])


if _common.is_rank(args):
    _common.join(args)
    _common.emit(**run())
elif args.nproc > 1:
    ranks = _common.launch(args, Path(__file__).resolve())
    r0 = ranks[0]
    print(f"{args.nproc} ranks sharing {args.device}: grid {r0['grid']}")
    print("accept:", r0["accept_rate"])
    print("max |posterior mean - truth|:", r0["max_abs_mean_minus_truth"])
    agree = all({k: v for k, v in r.items() if k != "rank"}
                == {k: v for k, v in r0.items() if k != "rank"}
                for r in ranks)
    _common.emit(**{k: v for k, v in r0.items() if k != "rank"},
                 ranks_agree=agree)
else:
    _common.emit(**{k: v for k, v in run().items() if k != "rank"},
                 ranks_agree=True)
