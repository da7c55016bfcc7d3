"""Multi-process execution (PyTorch port of
``mcmc_tpu.parallel.distributed``).

Every process calls :func:`init_distributed`, builds the same mesh
(:func:`global_mesh`, :func:`~mcmc_tpu_torch.parallel.make_mesh`) and calls
the same entry point with the same arguments and seed; each rank samples
its block of the chain axis on its own device and the collectives of
:mod:`mcmc_tpu_torch.parallel.mesh` join them. A launcher starts the
processes: ``torchrun --nproc-per-node N script.py`` (the script calls
``init_distributed()``, which reads ``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` from the environment), or
:func:`launch_local` on one machine.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from mcmc_tpu_torch.parallel.mesh import CHAIN_AXIS, make_mesh, \
    shard_chain_axis

__all__ = ["init_distributed", "global_mesh", "global_chain_array",
           "launch_local"]


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: Optional[str] = None,
                     timeout_s: float = 600.0) -> None:
    """Join the process group: ``init_process_group`` at
    ``tcp://{coordinator_address}`` (``host:port``) with ``num_processes``
    ranks as rank ``process_id``; each argument left ``None`` is read from
    the launcher's environment (``MASTER_ADDR:MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``). The backend is NCCL when the card is
    available, with ``torch.cuda.set_device`` to ``LOCAL_RANK`` (else the
    rank modulo the card count), and Gloo on the CPU; ``backend``
    overrides the choice (Gloo on the card runs several ranks on one card,
    which NCCL refuses). A collective that waits longer than ``timeout_s``
    raises, so a dead rank fails the others instead of hanging them."""
    env = os.environ
    if coordinator_address is None:
        coordinator_address = (f"{env.get('MASTER_ADDR', '127.0.0.1')}:"
                               f"{env['MASTER_PORT']}")
    world = int(env["WORLD_SIZE"] if num_processes is None
                else num_processes)
    rank = int(env["RANK"] if process_id is None else process_id)
    on_card = torch.cuda.is_available()
    if backend is None:
        backend = "nccl" if on_card else "gloo"
    if on_card:
        torch.cuda.set_device(int(env.get("LOCAL_RANK",
                                          rank % torch.cuda.device_count())))
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=float(timeout_s)))


def global_mesh(axis_name: str = CHAIN_AXIS):
    """1-D mesh over every rank of the process group (call after
    :func:`init_distributed`)."""
    return make_mesh(None, axis_name)


def global_chain_array(x, mesh, axis_name: str = CHAIN_AXIS):
    """This rank's rows of a host-replicated array (identical on every
    rank) along its leading chain axis, as a tensor."""
    return shard_chain_axis(torch.as_tensor(x), mesh, axis_name)


def _free_port() -> int:
    """A TCP port on ``localhost`` that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return int(s.getsockname()[1])


def launch_local(n: int, argv: Sequence[str], *, timeout_s: float = 600.0):
    """Run ``python argv...`` as ``n`` ranks on this machine and return
    each rank's last standard-output line parsed as JSON, in rank order.

    Each rank gets ``MASTER_ADDR``/``MASTER_PORT`` (a free local port),
    ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` (0: the ranks share this
    machine's first card, if any) for :func:`init_distributed`. When a rank
    exits non-zero the others are killed and ``RuntimeError`` carries the
    failed ranks' error output; past ``timeout_s`` every rank is killed and
    ``TimeoutError`` raised. No rank outlives the call."""
    port = _free_port()
    base = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    base["PYTHONPATH"] = root + (os.pathsep + base["PYTHONPATH"]
                                 if base.get("PYTHONPATH") else "")
    procs, logs = [], []
    try:
        for r in range(int(n)):
            e = dict(base, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                     WORLD_SIZE=str(n), RANK=str(r), LOCAL_RANK="0")
            # files, not pipes: a rank that writes much must not block
            logs.append((tempfile.TemporaryFile("w+"),
                         tempfile.TemporaryFile("w+")))
            procs.append(subprocess.Popen(
                [sys.executable, *argv], env=e,
                stdout=logs[-1][0], stderr=logs[-1][1], text=True))
        deadline = time.monotonic() + float(timeout_s)

        def read(f):
            f.seek(0)
            return f.read()

        while any(p.poll() is None for p in procs):
            for i, p in enumerate(procs):
                if p.poll() not in (None, 0):
                    raise RuntimeError(
                        f"rank {i} of {n} exited with {p.returncode}:\n"
                        + read(logs[i][1])[-4000:])
            if time.monotonic() > deadline:
                raise TimeoutError(f"{n} ranks of {list(argv)} ran past "
                                   f"{timeout_s} s")
            time.sleep(0.05)
        results = []
        for i, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError(f"rank {i} of {n} exited with "
                                   f"{p.returncode}:\n"
                                   + read(logs[i][1])[-4000:])
            lines = [ln for ln in read(logs[i][0]).splitlines()
                     if ln.strip()]
            if not lines:
                raise RuntimeError(f"rank {i} printed no result")
            results.append(json.loads(lines[-1]))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f_out, f_err in logs:
            f_out.close()
            f_err.close()
