"""Observability: phase timers, throughput counters, profiler capture
(PyTorch port of ``mcmc_tpu.observability``).

The reference has no timers or counters beyond ``n_accept_draws``
(SURVEY.md §5). This module provides the instrumentation layer:

- :class:`PhaseTimer` — wall-clock per named phase that waits for the card
  before it stops the clock (``torch.cuda.synchronize``), so asynchronous
  launches don't hide compute in a later phase;
- :func:`throughput` — draws/sec and leapfrog-steps/sec accounting;
- :func:`trace` / :func:`capture_trace` — thin wrappers over
  :mod:`torch.profiler`: a named range, and a profile of the enclosed block
  exported as a Chrome trace (viewable in Perfetto or ``chrome://tracing``).
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

__all__ = ["PhaseTimer", "throughput", "trace", "capture_trace"]


def _synchronize(target):
    """Wait for the card(s) ``target`` lives on: a tensor, a
    ``torch.device``, or a list, tuple, dict or named tuple of them. CPU
    work is already done when it returns; ``True`` waits for the current
    card."""
    devices = set()

    def visit(x):
        if torch.is_tensor(x):
            devices.add(x.device)
        elif isinstance(x, torch.device):
            devices.add(x)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    if target is True:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return
    visit(target)
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


@dataclass
class PhaseTimer:
    """Usage::

        timer = PhaseTimer()
        with timer.phase("warmup", sync=state):
            state = warmup(state)
        print(timer.timings)  # {"warmup": 1.23}

    ``sync`` (or ``box["sync"]`` set inside the block) names what the
    phase computed: the timer waits for the card it lives on before it
    stops the clock."""

    timings: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        t0 = time.perf_counter()
        box = {}
        try:
            yield box
        finally:
            target = box.get("sync", sync)
            if target is not None:
                _synchronize(target)
            self.timings[name] = self.timings.get(name, 0.0) \
                + time.perf_counter() - t0

    def count(self, name: str, n: float):
        self.counters[name] = self.counters.get(name, 0.0) + n

    def rates(self) -> Dict[str, float]:
        """counter / matching-phase-seconds for counters named 'phase.metric'."""
        out = {}
        for cname, n in self.counters.items():
            phase = cname.split(".")[0]
            secs = self.timings.get(phase)
            if secs:
                out[cname + "_per_sec"] = n / secs
        return out


def throughput(n_draws: int, n_chains: int, seconds: float,
               leapfrogs_per_draw: Optional[float] = None) -> Dict[str, float]:
    out = {
        "draws_per_sec": n_draws / seconds,
        "samples_per_sec": n_draws * n_chains / seconds,
    }
    if leapfrogs_per_draw is not None:
        out["leapfrog_steps_per_sec"] = n_draws * n_chains * leapfrogs_per_draw / seconds
    return out


def trace(name: str):
    """Annotate a region so it shows up named in a captured trace."""
    return torch.profiler.record_function(name)


class TraceCapture:
    """What :func:`capture_trace` yields: ``profile`` is the running
    ``torch.profiler.profile``; ``path`` the Chrome trace written when the
    block ends."""

    def __init__(self, profile):
        self.profile = profile
        self.path: Optional[pathlib.Path] = None


@contextlib.contextmanager
def capture_trace(log_dir: str):
    """Profile the enclosed block with ``torch.profiler`` (the CPU, and
    the card when there is one) and export it as a Chrome trace
    ``trace-<pid>-<ns>.json`` under ``log_dir``; yields a
    :class:`TraceCapture` whose ``path`` names the file afterwards.

    Once the profiler has run in a process, kernel launches there stay
    slower (on an H100 a steady Gaussian transition took 0.756 ms after a
    profile against 0.370 ms before), so profile last, or in a process of
    its own."""
    log_dir = pathlib.Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        cap = TraceCapture(prof)
        yield cap
    cap.path = log_dir / f"trace-{os.getpid()}-{time.time_ns()}.json"
    prof.export_chrome_trace(str(cap.path))
