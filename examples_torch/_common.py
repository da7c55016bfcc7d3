"""Shared command line of the PyTorch examples.

Every script runs on the card. ``--device`` defaults to ``cuda`` and is
passed to every entry point; :func:`setup` touches the device at once, so on
a machine without a card a script raises torch's own error before it does
any work. There is no fallback to the CPU: ask for it with ``--device cpu``.
``--quick`` cuts draws and chains for the CPU tests (each script's docstring
states its cuts in one line); it never changes a model, its data shapes or a
step size.

The last line a script prints is one JSON object of its figures
(:func:`emit`).
"""

import argparse
import json
import math
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def setup(doc=None, argv=None, add_args=None):
    """Parse ``--device`` (default ``cuda``) and ``--quick`` (plus whatever
    ``add_args(parser)`` adds), allocate on the device once so a missing
    card raises here, and return the parsed arguments with ``device`` a
    ``torch.device``."""
    ap = argparse.ArgumentParser(description=doc,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device every entry point runs on "
                         "(default: cuda; no fallback)")
    ap.add_argument("--quick", action="store_true",
                    help="cut draws and chains (the CPU tests)")
    if add_args is not None:
        add_args(ap)
    args = ap.parse_args(argv)
    args.device = torch.device(args.device)
    torch.zeros(1, device=args.device)
    return args


def _plain(v):
    if torch.is_tensor(v):
        v = v.detach().cpu().numpy()
    if isinstance(v, np.ndarray):
        return [_plain(x) for x in v.tolist()] if v.ndim else _plain(v.item())
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _plain(x) for k, x in v.items()}
    if isinstance(v, (np.floating, float)):
        v = float(v)
        return v if math.isfinite(v) else str(v)
    if isinstance(v, (np.integer, np.bool_)):
        return v.item()
    return v


def emit(**figures):
    """Print ``figures`` as one JSON line (tensors and arrays as lists)."""
    print(json.dumps(_plain(figures)), flush=True)


def mean_and_mcse(draws):
    """Each coordinate's mean over ``draws`` ``(n_draws, n_chains, d)`` (or
    ``(n_draws, d)``) and its MC standard error, sd over sqrt(ESS), both
    on the CPU."""
    from mcmc_tpu_torch import diagnostics
    d = torch.as_tensor(draws).to(torch.float64)
    if d.ndim == 2:
        d = d[:, None, :]
    ess = diagnostics.ess(d).to(torch.float64)
    flat = d.reshape(-1, d.shape[-1])
    return flat.mean(0).cpu(), (flat.std(0) / torch.sqrt(ess)).cpu()


def normal_scale_exact_mean(x):
    """The closed-form posterior mean of the (mu, sigma) Gaussian model
    (``models.gaussian_mean_scale_model``, flat prior) on data ``x``: mu's
    is the data's mean; sigma's is sqrt(S / 2) G(a - 1/2) / G(a), S the sum
    of squared deviations and a = (n - 2) / 2. The data is rounded to
    float32 first, as the model holds it."""
    x = np.asarray(x, np.float32).astype(np.float64)
    S, a = float(((x - x.mean()) ** 2).sum()), (len(x) - 2) / 2.0
    return np.array([x.mean(), math.sqrt(S / 2.0)
                     * math.exp(math.lgamma(a - 0.5) - math.lgamma(a))])


def add_rank_args(ap, nproc=1):
    """The multi-process options: ``--nproc`` ranks (default ``nproc``),
    ``--pid`` this process's rank and ``--coordinator`` ``host:port`` (a
    rank started by hand), ``--backend`` of the process group (default:
    NCCL on the card, Gloo on the CPU; ranks that share one card take
    Gloo, as NCCL refuses two ranks on one device)."""
    ap.add_argument("--nproc", type=int, default=nproc,
                    help=f"number of ranks (default {nproc})")
    ap.add_argument("--pid", type=int, default=None, help="this rank")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0's process group")
    ap.add_argument("--backend", default=None,
                    help="process-group backend (nccl or gloo)")


def is_rank(args):
    """Whether this process is one rank of a job: started by a launcher
    (``launch_local``, ``torchrun``: ``RANK`` in the environment) or by
    hand with ``--pid``."""
    return args.pid is not None or "RANK" in os.environ


def join(args):
    """Join the job's process group (a rank's first step)."""
    from mcmc_tpu_torch.parallel import init_distributed
    backend = args.backend or ("gloo" if args.device.type == "cpu" else None)
    init_distributed(args.coordinator,
                     args.nproc if args.pid is not None else None, args.pid,
                     backend=backend, timeout_s=600)


def launch(args, script, timeout_s=900.0):
    """Run ``script`` as ``args.nproc`` local ranks that share this
    machine's first card (Gloo) and return each rank's last JSON line, in
    rank order (:func:`mcmc_tpu_torch.parallel.launch_local`)."""
    from mcmc_tpu_torch.parallel import launch_local
    argv = [str(script), "--device", str(args.device), "--nproc",
            str(args.nproc), "--backend", "gloo"]
    if args.quick:
        argv.append("--quick")
    return launch_local(args.nproc, argv, timeout_s=timeout_s)
