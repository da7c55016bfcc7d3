"""The port's observability layer (``mcmc_tpu_torch.observability``): the
phase timer, throughput accounting, named ranges and the Chrome trace
capture, on the CPU."""

import json
import time

import pytest
import torch

from mcmc_tpu_torch import observability as obs


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for every test here: the tests run in several
    worker processes at once, and torch's default of a thread per core
    oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_phase_timer_records_phases_and_rates():
    """Each phase's seconds accumulate under its name (a repeated phase
    adds), the ``sync`` target (given or set inside the block) is accepted,
    and counters named ``phase.metric`` become rates."""
    timer = obs.PhaseTimer()
    x = torch.ones(64)
    with timer.phase("warmup", sync=x):
        time.sleep(0.01)
    with timer.phase("sample") as box:
        y = x * 2
        box["sync"] = {"y": y, "devs": [torch.device("cpu")]}
    with timer.phase("sample", sync=True):
        time.sleep(0.01)
    assert set(timer.timings) == {"warmup", "sample"}
    assert timer.timings["warmup"] >= 0.01 and timer.timings["sample"] >= 0.01
    timer.count("sample.draws", 100)
    timer.count("sample.draws", 100)
    timer.count("other", 5)
    rates = timer.rates()
    assert rates == pytest.approx(
        {"sample.draws_per_sec": 200 / timer.timings["sample"]})
    with pytest.raises(RuntimeError):
        with timer.phase("failed"):
            raise RuntimeError("boom")
    assert "failed" in timer.timings      # recorded even when it raises


def test_throughput():
    out = obs.throughput(100, 8, 2.0, leapfrogs_per_draw=4)
    assert out == {"draws_per_sec": 50.0, "samples_per_sec": 400.0,
                   "leapfrog_steps_per_sec": 1600.0}
    assert "leapfrog_steps_per_sec" not in obs.throughput(1, 1, 1.0)


def test_capture_trace_writes_a_chrome_trace(tmp_path):
    """``capture_trace`` profiles the block and writes a non-empty Chrome
    trace under ``tmp_path`` that holds the ``trace`` range by name."""
    with obs.capture_trace(tmp_path / "prof") as cap:
        with obs.trace("mcmc_step"):
            a = torch.randn(32, 32)
            (a @ a).sum()
    assert cap.path is not None and cap.path.parent == tmp_path / "prof"
    assert cap.path.stat().st_size > 0
    events = json.loads(cap.path.read_text())["traceEvents"]
    assert any(e.get("name") == "mcmc_step" for e in events)
