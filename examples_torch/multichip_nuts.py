"""Multi-device NUTS: chains sharded over a device mesh; the port's
rendition of ``examples/multichip_nuts.py``. A 16-d ill-conditioned
Gaussian (condition number 1e3), 64 chains per rank, 300 adapted burn-in +
300 kept draws.

The port runs one process per device on ``torch.distributed``. Run as is,
the script starts ``--nproc`` ranks (default 4) on this machine that share
its first card through a Gloo group (NCCL refuses two ranks on one device)
and prints the global figures every rank returns; ``--nproc 1`` runs a
world of one in this process. On several cards:

    torchrun --nproc-per-node 4 multichip_nuts.py    # NCCL, a card a rank

--quick: 16 chains per rank, 50 + 50 draws (50 adapted).
"""

from pathlib import Path

import _common

args = _common.setup(__doc__, add_args=lambda ap: _common.add_rank_args(
    ap, nproc=4))
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

import mcmc_tpu_torch as mt  # noqa: E402
from mcmc_tpu_torch import diagnostics, models  # noqa: E402
from mcmc_tpu_torch.parallel import make_mesh  # noqa: E402


def run():
    """This rank's share of the run; every rank returns the global
    figures."""
    per_rank, n = (16, 50) if args.quick else (64, 300)
    mesh = make_mesh()
    n_chains = per_rank * dist.get_world_size()
    rank = dist.get_rank()
    if rank == 0:
        print(f"mesh: {mesh}; running {n_chains} chains")
    log_kernel = models.ill_conditioned_gaussian(16, condition_number=1e3,
                                                 device=args.device)
    out = mt.nuts(
        np.zeros(16), log_kernel,
        mt.NUTSSettings(n_burnin_draws=n, n_keep_draws=n, n_adapt_draws=n),
        n_chains=n_chains, key=0, mesh=mesh, device=args.device)
    rhat = float(diagnostics.split_rhat(out.draws).max())
    ess = diagnostics.ess(out.draws)
    var = out.draws.double().reshape(-1, 16).var(0).cpu().numpy()
    rel = np.abs(var / log_kernel.variances.double().cpu().numpy() - 1)
    if rank == 0:
        print("draws:", tuple(out.draws.shape), "on", out.draws.device)
        print("max split R-hat:", rhat)
        print("min ESS:", float(ess.min()))
    return dict(rank=rank, world=dist.get_world_size(), n_chains=n_chains,
                draws_shape=list(out.draws.shape), max_split_rhat=rhat,
                min_ess=ess.min(),
                min_ess_per_draw=ess.min() / (n_chains * n),
                max_rel_var_err=rel.max(), accept_rate=out.accept_rate.mean())


if _common.is_rank(args):
    _common.join(args)
    _common.emit(**run())
elif args.nproc > 1:
    ranks = _common.launch(args, Path(__file__).resolve())
    r0 = ranks[0]
    print(f"{args.nproc} ranks sharing {args.device}: {r0['n_chains']} "
          f"chains, draws {tuple(r0['draws_shape'])}")
    print("max split R-hat:", r0["max_split_rhat"])
    print("min ESS:", r0["min_ess"])
    agree = all({k: v for k, v in r.items() if k != "rank"}
                == {k: v for k, v in r0.items() if k != "rank"}
                for r in ranks)
    _common.emit(**{k: v for k, v in r0.items() if k != "rank"},
                 ranks_agree=agree)
else:
    _common.emit(**{k: v for k, v in run().items() if k != "rank"},
                 ranks_agree=True)
