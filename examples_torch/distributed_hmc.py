"""Multi-process chain-sharded HMC (the multi-host pattern); the port's
rendition of ``examples/distributed_hmc.py``. A 4-d Gaussian centred at 2,
16 chains per rank, HMC at step 0.5 with 4 leapfrogs, 500 + 1000 draws.

The port runs one process per device on ``torch.distributed``. Run the same
script once per process or host, each with its rank:

    python distributed_hmc.py --coordinator localhost:9876 --nproc 2 --pid 0 &
    python distributed_hmc.py --coordinator localhost:9876 --nproc 2 --pid 1

(on the CPU add ``--device cpu``; ranks that share one card add
``--backend gloo``). Or let the script start them on this machine, sharing
its first card through a Gloo group (``parallel.launch_local``):

    python distributed_hmc.py --nproc 2

On several cards, launch with torchrun (NCCL, a card a rank):

    torchrun --nproc-per-node 4 distributed_hmc.py

With no arguments it runs a world of one.

--quick: 100 + 200 draws.
"""

from pathlib import Path

import _common

args = _common.setup(__doc__, add_args=_common.add_rank_args)
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

import mcmc_tpu_torch as mt  # noqa: E402
from mcmc_tpu_torch.parallel import global_mesh  # noqa: E402


def run():
    burn, keep = (100, 200) if args.quick else (500, 1000)
    mesh = global_mesh()
    rank, world = dist.get_rank(), dist.get_world_size()
    print(f"process {rank}/{world}: device {args.device}")

    log_kernel = lambda v: -0.5 * ((v - 2.0) ** 2).sum(-1)  # noqa: E731
    out = mt.hmc(
        np.zeros(4), log_kernel,
        mt.HMCSettings(n_burnin_draws=burn, n_keep_draws=keep,
                       step_size=0.5, n_leap_steps=4),
        n_chains=16 * world, key=0, mesh=mesh, device=args.device)
    # every rank holds the global draws
    mean = float(out.draws.double().mean())
    acc = float(out.n_accept_draws.double().mean()) / keep
    print(f"process {rank}: posterior mean {mean:.3f} (truth 2.0), "
          f"accept {acc:.2f}")
    return dict(rank=rank, world=world, n_chains=16 * world, mean=mean,
                coord_means=out.mean, accept_rate=acc)


if _common.is_rank(args):
    _common.join(args)
    _common.emit(**run())
elif args.nproc > 1:
    ranks = _common.launch(args, Path(__file__).resolve())
    for r in ranks:
        print(f"process {r['rank']}: posterior mean {r['mean']:.3f} "
              f"(truth 2.0), accept {r['accept_rate']:.2f}")
    r0 = ranks[0]
    agree = all({k: v for k, v in r.items() if k != "rank"}
                == {k: v for k, v in r0.items() if k != "rank"}
                for r in ranks)
    _common.emit(**{k: v for k, v in r0.items() if k != "rank"},
                 ranks_agree=agree)
else:
    _common.emit(**{k: v for k, v in run().items() if k != "rank"},
                 ranks_agree=True)
