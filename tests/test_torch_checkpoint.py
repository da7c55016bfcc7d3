"""Durability in the PyTorch port: ``checkpoint.save``/``restore``, the
chunked runner, and ``checkpoint_dir=`` on every sampler entry point that
takes it in the JAX package, and on ``fit``.

The contract: a checkpointed run makes the same ``step(gen, state)`` calls
in the same order as the in-memory loop, so with the same seed its draws
are bit-equal to the in-memory run's, its acceptance (from the per-chain
totals) equal, and a resumed run — after ``max_chunks``, with another chunk
size, extended, or after the process was killed with SIGKILL — bit-equal to
an uninterrupted one. All on the CPU at tiny sizes.
"""

import os
import pathlib
import signal
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest
import torch

import mcmc_tpu_torch as M
from mcmc_tpu_torch import checkpoint, diagnostics
from mcmc_tpu_torch.runtime import read_draws
from mcmc_tpu_torch.samplers.hmc import HMCState, build_hmc_kernel
from mcmc_tpu_torch.samplers import common
from mcmc_tpu_torch.integrators import grad_of

ROOT = pathlib.Path(__file__).resolve().parent.parent
W, K = 6, 10            # burn-in and kept draws of every entry point case
EVERY = 4               # chunks of 4: ragged at both phase ends


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for every test here: the tests run in several
    worker processes at once, and torch's default of a thread per core
    oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lk(v):
    return -0.5 * (v * v).sum(-1) - 0.1 * v[:, 0]


def _eye_metric(v):
    return torch.eye(v.shape[-1]).expand(v.shape[0], -1, -1)


def _zero_lik(theta, batch):
    return -0.05 * ((batch - theta[:, None, :]) ** 2).sum(dim=(1, 2))


_DATA = np.random.default_rng(0).standard_normal((32, 2)).astype(np.float32)

# name -> (entry point call taking **checkpoint kwargs, result's accept key)
CASES = {
    "rwmh": lambda **k: M.rwmh(np.zeros(2), lk, M.RWMHSettings(
        n_burnin_draws=W, n_keep_draws=K, par_scale=0.8), n_chains=4,
        adapt_scale=True, **k),
    "mala": lambda **k: M.mala(np.zeros(2), lk, M.MALASettings(
        n_burnin_draws=W, n_keep_draws=K, step_size=0.4), n_chains=4,
        adapt_step_size=True, **k),
    "hmc": lambda **k: M.hmc(np.zeros(2), lk, M.HMCSettings(
        n_burnin_draws=W, n_keep_draws=K, step_size=0.3, n_leap_steps=3),
        n_chains=4, adapt_step_size=True, adapt_mass_matrix=True, **k),
    "ghmc": lambda **k: M.ghmc(np.zeros(2), lk, M.GHMCSettings(
        n_burnin_draws=W, n_keep_draws=K), n_chains=4, **k),
    "nuts": lambda **k: M.nuts(np.zeros(2), lk, M.NUTSSettings(
        n_burnin_draws=W, n_keep_draws=K, n_adapt_draws=W, max_tree_depth=4),
        n_chains=4, adapt_mass_matrix=True, **k),
    "chees": lambda **k: M.chees(np.zeros(2), lk, M.ChEESSettings(
        n_burnin_draws=W, n_keep_draws=K), n_chains=4, **k),
    "rmhmc": lambda **k: M.rmhmc(np.zeros(2), lk, _eye_metric,
                                 M.RMHMCSettings(n_burnin_draws=W,
                                                 n_keep_draws=K,
                                                 step_size=0.3, n_fp_steps=2),
                                 n_chains=4, **k),
    "de": lambda **k: M.de(np.zeros(2), lk, M.DESettings(
        n_pop=8, n_burnin_draws=W, n_keep_draws=K), **k),
    "demcz": lambda **k: M.demcz(np.zeros(2), lk, M.DEMCZSettings(
        n_pop=4, n_burnin_draws=W, n_keep_draws=K), n_runs=2, **k),
    "aees": lambda **k: M.aees(np.zeros(2), lk, M.AEESSettings(
        n_initial_draws=3, n_burnin_draws=3, n_keep_draws=K, n_rings=2,
        temper_vec=[4.0]), n_runs=2, **k),
    "pt": lambda **k: M.pt(np.zeros(2), lk, M.PTSettings(
        n_burnin_draws=W, n_keep_draws=K, n_temps=3, max_temp=5.0,
        adapt_temps=True), n_chains=4, **k),
    "stretch": lambda **k: M.stretch(np.zeros(2), lk, M.StretchSettings(
        n_walkers=8, n_burnin_draws=W, n_keep_draws=K), **k),
    "sgld": lambda **k: M.sgld(np.zeros(2), lk, _zero_lik, _DATA,
                               M.SGLDSettings(step_size=0.05, batch_size=8,
                                              n_burnin_draws=W,
                                              n_keep_draws=K),
                               n_chains=4, **k),
    "sghmc": lambda **k: M.sghmc(np.zeros(2), lk, _zero_lik, _DATA,
                                 M.SGHMCSettings(step_size=0.01, batch_size=8,
                                                 n_burnin_draws=W,
                                                 n_keep_draws=K),
                                 n_chains=4, minibatch="shared", **k),
    "elliptical_slice": lambda **k: M.elliptical_slice(
        np.zeros(2), lambda v: -0.5 * ((v - 1.0) ** 2).sum(-1),
        M.EllipticalSettings(n_burnin_draws=W, n_keep_draws=K),
        prior_mean=np.zeros(2), prior_cov=np.eye(2), n_chains=4, **k),
    "slice_sampler": lambda **k: M.slice_sampler(np.zeros(2), lk,
                                                 M.SliceSettings(
                                                     n_burnin_draws=W,
                                                     n_keep_draws=K),
                                                 n_chains=4, adapt_w=True,
                                                 **k),
    "gibbs": lambda **k: M.gibbs(np.zeros(2), lk, M.GibbsSettings(
        n_burnin_draws=W, n_keep_draws=K),
        blocks=[([0], "rwmh"), ([1], "slice")], n_chains=4, **k),
    "mclmc": lambda **k: M.mclmc(np.zeros(2), lk, M.MCLMCSettings(
        n_burnin_draws=W, n_keep_draws=K), n_chains=4, **k),
    "mams": lambda **k: M.mams(np.zeros(2), lk, M.MAMSSettings(
        n_burnin_draws=W, n_keep_draws=K), n_chains=4, **k),
    "barker": lambda **k: M.barker(np.zeros(2), lk, M.BarkerSettings(
        n_burnin_draws=W, n_keep_draws=K), n_chains=4, adapt_step_size=True,
        adapt_precond=True, **k),
    "mmala": lambda **k: M.mmala(np.zeros(2), lk, _eye_metric,
                                 M.MMALASettings(n_burnin_draws=W,
                                                 n_keep_draws=K,
                                                 step_size=0.5),
                                 n_chains=4, adapt_step_size=True, **k),
}


@pytest.mark.parametrize("name", list(CASES))
def test_checkpointed_entry_point_equals_in_memory(name, tmp_path):
    """The checkpointed run's draws bit-equal to the in-memory run's with
    the same seed, its acceptance from the totals equal to the in-memory
    count, the draws on the host (the sink's memmap) and in the sink file;
    a second call on the finished directory resumes as a no-op."""
    run = CASES[name]
    plain = run(key=5, device="cpu")
    ck = run(key=5, device="cpu", checkpoint_dir=tmp_path / "ck",
             checkpoint_every=EVERY)
    assert ck.draws.device.type == "cpu"
    assert torch.equal(plain.draws, ck.draws), name
    assert torch.equal(torch.as_tensor(plain.n_accept_draws).to(torch.int64),
                       torch.as_tensor(ck.n_accept_draws).to(torch.int64))
    torch.testing.assert_close(plain.accept_rate, ck.accept_rate,
                               rtol=0, atol=0)
    if "accept_rate_per_walker" in plain.diagnostics:
        torch.testing.assert_close(
            plain.diagnostics["accept_rate_per_walker"],
            ck.diagnostics["accept_rate_per_walker"], rtol=1e-6, atol=0)
    sunk = read_draws(tmp_path / "ck" / "draws.bin")
    assert sunk.shape[0] == K
    again = run(key=5, device="cpu", checkpoint_dir=tmp_path / "ck",
                checkpoint_every=EVERY)
    assert torch.equal(again.draws, ck.draws)


def test_smc_refuses_checkpoint_and_mesh_names_a12(tmp_path):
    """As in the JAX package, ``smc`` takes no ``checkpoint_dir``; ``mesh=``
    still raises everywhere, naming A12."""
    with pytest.raises(TypeError, match="checkpoint_dir"):
        M.smc(np.zeros(2), lk, checkpoint_dir=tmp_path, device="cpu")
    with pytest.raises(NotImplementedError, match="A12"):
        M.hmc(np.zeros(2), lk, n_chains=2, mesh=object(),
              checkpoint_dir=tmp_path, device="cpu")
    with pytest.raises(ValueError, match="return_resume"):
        CASES["hmc"](device="cpu", checkpoint_dir=tmp_path,
                     return_resume=True)


def test_save_restore_round_trip(tmp_path):
    """A tree of named tuples, dicts, lists, host numbers and a generator
    round-trips exactly; the restored generator continues the stream; a
    template of another layout raises."""
    gen = torch.Generator().manual_seed(3)
    torch.rand(5, generator=gen)
    tree = {"s": HMCState(*[torch.randn(3) for _ in range(9)]),
            "n": 7, "x": 0.5, "ok": True,
            "l": [torch.arange(4, dtype=torch.int32), np.ones(2)],
            "gen": gen}
    checkpoint.save(tmp_path / "t.npz", tree)
    want_next = torch.rand(3, generator=gen)
    like_gen = torch.Generator().manual_seed(0)
    like = {**tree, "s": HMCState(*[torch.zeros(3) for _ in range(9)]),
            "n": 0, "x": 0.0, "ok": False,
            "l": [torch.zeros(4, dtype=torch.int32), np.zeros(2)],
            "gen": like_gen}
    out = checkpoint.restore(tmp_path / "t.npz", like)
    assert isinstance(out["s"], HMCState)
    for a, b in zip(out["s"], tree["s"]):
        assert torch.equal(a, b)
    assert (out["n"], out["x"], out["ok"]) == (7, 0.5, True)
    assert type(out["n"]) is int and type(out["ok"]) is bool
    assert out["l"][0].dtype == torch.int32
    assert torch.equal(out["l"][0], tree["l"][0])
    np.testing.assert_array_equal(out["l"][1], np.ones(2))
    assert out["gen"] is like_gen
    assert torch.equal(torch.rand(3, generator=like_gen), want_next)
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore(tmp_path / "t.npz", {"only": torch.zeros(1)})


def _runner(tmp_path, name):
    init, step = build_hmc_kernel(lk, grad_of(lk), common.make_spd(None, 2,
                                                                  None),
                                  0.4, 3, None, None)
    return (checkpoint.ChunkedRunner(step, lambda st: st.position,
                                     tmp_path / name),
            init(torch.zeros((4, 2))))


def test_resume_after_max_chunks_and_rechunked(tmp_path):
    """A run stopped after ``max_chunks`` and resumed — with the same chunk
    size, another one, and extended to more draws — equals the
    uninterrupted run bit for bit, state and totals included."""
    r, s0 = _runner(tmp_path, "full")
    final, straight, tot = r.run(torch.Generator().manual_seed(1), s0,
                                 n_draws=30, chunk_size=7, n_burnin=5)
    straight = np.array(straight)
    r2, s0b = _runner(tmp_path, "part")
    r2.run(torch.Generator().manual_seed(1), s0b, n_draws=20, chunk_size=7,
           n_burnin=5, max_chunks=2)
    r3, s0c = _runner(tmp_path, "part")
    _, mid, _ = r3.run(torch.Generator().manual_seed(1), s0c, n_draws=20,
                       chunk_size=3, n_burnin=5)
    np.testing.assert_array_equal(np.array(mid), straight[:20])
    r4, s0d = _runner(tmp_path, "part")
    final2, ext, tot2 = r4.run(torch.Generator().manual_seed(1), s0d,
                               n_draws=30, chunk_size=11, n_burnin=5)
    np.testing.assert_array_equal(np.array(ext), straight)
    assert torch.equal(final.position, final2.position)
    np.testing.assert_array_equal(tot["accepted"], tot2["accepted"])


def test_incompatible_burnin_warns_and_progress(tmp_path):
    """A changed ``n_burnin`` restarts loudly; ``progress=`` receives one
    dict per durable chunk with the phase labels."""
    r, s0 = _runner(tmp_path, "w")
    msgs = []
    r.run(torch.Generator().manual_seed(2), s0, n_draws=20, n_burnin=10,
          chunk_size=10, progress=msgs.append)
    assert [m["done"] for m in msgs] == [10, 20, 30]
    assert [m["phase"] for m in msgs] == ["burnin", "keep", "keep"]
    assert all(m["total"] == 30 and m["draws_per_s"] > 0 for m in msgs)
    r2, s0b = _runner(tmp_path, "w")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        _, d, _ = r2.run(torch.Generator().manual_seed(2), s0b, n_draws=20,
                         n_burnin=12, chunk_size=10)
    assert any("restarting from scratch" in str(w.message) for w in rec)
    assert d.shape == (20, 4, 2)


def test_streaming_moments_match_diagnostics(tmp_path):
    """``track_moments`` across chunks and a resume: the count, mean and
    m2 equal batch statistics of the stored draws, and feed
    ``diagnostics.moments_rhat``."""
    r, s0 = _runner(tmp_path, "m")
    r.run(torch.Generator().manual_seed(4), s0, n_draws=40, chunk_size=6,
          n_burnin=4, track_moments=True, max_chunks=3)
    r, s0 = _runner(tmp_path, "m")
    _, draws, tot = r.run(torch.Generator().manual_seed(4), s0, n_draws=40,
                          chunk_size=6, n_burnin=4, track_moments=True)
    d = np.asarray(draws, np.float64)
    m = tot["moments"]
    assert float(m["count"]) == 40
    np.testing.assert_allclose(m["mean"], d.mean(axis=0), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(m["m2"] / 39.0, d.var(axis=0, ddof=1),
                               rtol=1e-10)
    mom = {"count": torch.tensor(40, dtype=torch.int32),
           "mean": torch.as_tensor(m["mean"], dtype=torch.float32),
           "m2": torch.as_tensor(m["m2"], dtype=torch.float32)}
    rhat = diagnostics.moments_rhat(mom)
    assert torch.isfinite(rhat).all() and rhat.shape == (2,)


_CRASH = textwrap.dedent("""
    import os, signal, sys
    sys.path.insert(0, {root!r})
    import torch
    from mcmc_tpu_torch import checkpoint
    sys.path.insert(0, {tests!r})
    from test_torch_checkpoint import _runner
    import pathlib
    r, s0 = _runner(pathlib.Path(sys.argv[1]), "run")
    orig, n = checkpoint.DrawSink.append, [0]
    def killing(self, arr):
        orig(self, arr)
        n[0] += 1
        if n[0] > 3:
            self.flush()
            os.kill(os.getpid(), signal.SIGKILL)   # no close, no cleanup
    checkpoint.DrawSink.append = killing
    r.run(torch.Generator().manual_seed(6), s0, n_draws=60, chunk_size=8,
          n_burnin=4)
""")


def test_sigkill_mid_run_resumes_bit_identically(tmp_path):
    """A process killed with SIGKILL after four appended chunks leaves a
    checkpoint and an unclosed sink; resuming here finishes the run with
    draws, state and totals equal to an uninterrupted run's."""
    script = tmp_path / "crash.py"
    script.write_text(_CRASH.format(root=str(ROOT),
                                    tests=str(ROOT / "tests")))
    proc = subprocess.run([sys.executable, str(script), str(tmp_path)],
                          capture_output=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == -signal.SIGKILL, proc.stderr.decode()[-800:]
    done = __import__("json").loads(
        (tmp_path / "run" / "progress.json").read_text())["done"]
    assert 4 < done < 64
    r, s0 = _runner(tmp_path, "run")
    final, resumed, tot = r.run(torch.Generator().manual_seed(6), s0,
                                n_draws=60, chunk_size=8, n_burnin=4)
    r2, s0b = _runner(tmp_path, "clean")
    final2, clean, tot2 = r2.run(torch.Generator().manual_seed(6), s0b,
                                 n_draws=60, chunk_size=8, n_burnin=4)
    np.testing.assert_array_equal(np.array(resumed), np.array(clean))
    assert torch.equal(final.position, final2.position)
    np.testing.assert_array_equal(tot["accepted"], tot2["accepted"])


def test_fit_checkpoint_convergence_gate(tmp_path):
    """``fit(checkpoint_dir=, min_ess=)``: extension rounds re-enter the
    directory with a grown total, the gate reads the whole sink, and the
    sink holds exactly the final draws (``tests/test_resume_fit.py``'s
    checkpointed case at its sizes)."""
    out = M.fit(np.zeros(2), lambda v: -0.5 * (v * v).sum(-1),
                algorithm="chees", n_chains=16, n_warmup=300, n_draws=150,
                key=2, min_ess=2500, max_rounds=6,
                checkpoint_dir=tmp_path / "fitck", device="cpu")
    rounds = int(out.diagnostics["n_rounds"])
    assert out.diagnostics["converged"] and rounds >= 2
    assert out.draws.shape == (150 * rounds, 16, 2)
    assert float(out.diagnostics["summary"]["ess_bulk"].min()) >= 2500
    sunk = np.asarray(read_draws(tmp_path / "fitck" / "draws.bin"))
    np.testing.assert_array_equal(sunk, out.draws.numpy())
    # one long checkpointed run of the same total is the same stream
    long = M.fit(np.zeros(2), lambda v: -0.5 * (v * v).sum(-1),
                 algorithm="chees", n_chains=16, n_warmup=300,
                 n_draws=150 * rounds, key=2,
                 checkpoint_dir=tmp_path / "long", device="cpu")
    assert torch.equal(long.draws, out.draws)
