"""One batched HMC transition of the flagship workload: the port's
counterpart of the JAX package's driver hook ``entry()``.

``entry()`` returns ``(fn, example_args)``: ``fn(gen, state)`` advances
1,024 chains of the 100-dimensional Bayesian logistic regression (1,000
observations, numpy-seeded data) by one HMC transition of 4 leapfrogs at
step 0.01 and returns the new positions and the accept decisions. It runs
on the card unless ``device=`` asks for another device.

    from mcmc_tpu_torch.entry import entry
    fn, args = entry()
    positions, accepted = fn(*args)

``dryrun_multichip(n)`` starts ``n`` ranks on this machine and runs the
eleven sharded paths of the JAX package's dry run through
:mod:`mcmc_tpu_torch.parallel` (``python -m mcmc_tpu_torch.entry
--dryrun-multichip N [--device cpu|cuda] [--out FILE]``).
"""

from __future__ import annotations

import json
import math
import sys
import time

import torch

from mcmc_tpu_torch import integrators, models
from mcmc_tpu_torch.samplers import common
from mcmc_tpu_torch.samplers._resolve import resolve_device
from mcmc_tpu_torch.samplers.hmc import build_hmc_kernel

__all__ = ["entry", "dryrun_multichip", "FLAGSHIP_DIM", "FLAGSHIP_DATA",
           "ENTRY_CHAINS"]

FLAGSHIP_DIM = 100
FLAGSHIP_DATA = 1000
ENTRY_CHAINS = 1024


def entry(device=None, n_chains=ENTRY_CHAINS):
    """``(fn, (gen, state))``: ``fn(gen, state) -> (positions (n_chains,
    100), accepted (n_chains,))``, one batched HMC transition on the
    flagship posterior from starts ``0.1 N(0, 1)``; ``gen`` is the
    transition's ``torch.Generator`` on ``device`` (default: the card)."""
    device = resolve_device(device)
    X, y, _ = models.make_logistic_regression_data(
        0, FLAGSHIP_DATA, FLAGSHIP_DIM, device=device)
    log_kernel = models.logistic_regression_model(X, y)
    precond = common.make_spd(None, FLAGSHIP_DIM, torch.float32, device)
    init, step = build_hmc_kernel(log_kernel,
                                  integrators.grad_of(log_kernel), precond,
                                  step_size=0.01, n_leap_steps=4)
    gen = torch.Generator(device=device).manual_seed(1)
    state = init(0.1 * torch.randn((n_chains, FLAGSHIP_DIM), generator=gen,
                                   device=device))
    gen.manual_seed(2)

    def fn(gen, state):
        with torch.no_grad():
            new_state, info = step(gen, state)
        return new_state.position, info["accepted"]

    return fn, (gen, state)


def _dryrun_rank(device):
    """One rank of :func:`dryrun_multichip`: the eleven paths on a mesh of
    every rank, each checked for its shape and finite draws; returns a
    dict of per-path seconds and collectives, and the paths' global
    statistics (identical on every rank)."""
    import mcmc_tpu_torch as mt
    from mcmc_tpu_torch import parallel as par
    from mcmc_tpu_torch.parallel import mesh as mesh_mod

    n = torch.distributed.get_world_size()
    mesh = par.make_mesh()
    dim, n_chains = 8, 4 * n
    kw = {"device": device}
    log_kernel = models.ill_conditioned_gaussian(dim, 100.0, device=device)
    lk_mix = models.gaussian_mixture_model(
        torch.tensor([[-1.0], [1.0]]), torch.tensor([0.3, 0.3]),
        torch.tensor([0.5, 0.5]), device=device)
    z = lambda d: torch.zeros(d, device=device)
    paths = {}

    def run(name, fn, shape):
        for k in mesh_mod.COUNTS:
            mesh_mod.COUNTS[k] = 0
        t0 = time.perf_counter()
        out = fn()
        draws = out.draws
        if draws.is_cuda:
            torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        if tuple(draws.shape) != tuple(shape):
            raise AssertionError(f"{name}: draws {tuple(draws.shape)}, "
                                 f"expected {tuple(shape)}")
        if not bool(torch.isfinite(draws).all()):
            raise AssertionError(f"{name}: non-finite draws")
        paths[name] = {"seconds": sec, "collectives": dict(mesh_mod.COUNTS),
                       "mean": float(draws.double().mean())}
        return out

    # 1) chain-sharded NUTS
    run("nuts", lambda: mt.nuts(
        z(dim), log_kernel,
        mt.NUTSSettings(n_burnin_draws=2, n_keep_draws=3, n_adapt_draws=2,
                        max_tree_depth=4),
        n_chains=n_chains, key=0, mesh=mesh, **kw), (3, n_chains, dim))
    # 2) population-sharded DE (an all-gather a generation)
    run("de", lambda: mt.de(
        torch.ones(1, device=device), lk_mix,
        mt.DESettings(n_pop=8 * n, n_burnin_draws=0, n_keep_draws=2),
        key=3, mesh=mesh, **kw), (2, 8 * n, 1))
    # 3) ladder-sharded AEES (history down the ladder), capped history
    if n >= 2:
        temps = torch.linspace(8.0, 2.0, n - 1).tolist() if n > 2 else [8.0]
        run("aees_sharded", lambda: par.aees_sharded(
            torch.tensor([-1.0], device=device), lk_mix,
            mt.AEESSettings(n_initial_draws=2, n_burnin_draws=2,
                            n_keep_draws=4, n_rings=2, ee_prob_par=0.3,
                            temper_vec=temps, cov_mat=[[0.5]]),
            mesh=mesh, key=5, history_capacity=8, **kw), (4, 1))
    # 4) chain-sharded ChEES (pooled criterion)
    run("chees", lambda: mt.chees(
        z(dim), log_kernel, mt.ChEESSettings(n_burnin_draws=3,
                                             n_keep_draws=3),
        n_chains=n_chains, key=7, mesh=mesh, **kw), (3, n_chains, dim))
    # 5) ladder-sharded PT (neighbour swaps)
    if n >= 2:
        run("pt_sharded", lambda: par.pt_sharded(
            torch.tensor([-1.0], device=device), lk_mix,
            mt.PTSettings(n_burnin_draws=2, n_keep_draws=4, n_temps=n,
                          max_temp=10.0, step_size=0.2, n_leap_steps=2),
            mesh=mesh, key=9, **kw), (4, 1))
    # 6) particle-sharded SMC
    run("smc", lambda: mt.smc(
        z(dim), log_kernel,
        mt.SMCSettings(n_particles=16 * n, max_stages=12, n_mcmc_steps=2,
                       init_scale=3.0),
        key=11, mesh=mesh, **kw), (16 * n, dim))
    # 7) walker-sharded stretch ensemble
    run("stretch", lambda: mt.stretch(
        z(dim), log_kernel,
        mt.StretchSettings(n_walkers=4 * dim * n, n_burnin_draws=2,
                           n_keep_draws=3),
        key=13, mesh=mesh, **kw), (3, 4 * dim * n, dim))
    # 8) HMC on a (chains, data) grid, the likelihood's sum all-reduced
    if n >= 2 and n % 2 == 0:
        grid = par.make_grid_mesh(2, n // 2)
        g = torch.Generator().manual_seed(15)
        Xd = torch.randn((64 * n, dim), generator=g).to(device)
        yd = (Xd[:, 0] > 0).to(torch.float32)

        def lk_data(beta, data):
            Xa, ya = data
            eta = beta @ Xa.T
            return (ya * eta - torch.nn.functional.softplus(eta)).sum(-1) \
                - 0.5 * (beta * beta).sum(-1)

        lk_dp = par.data_parallel_kernel(lk_data, (Xd, yd), grid)
        run("hmc_grid", lambda: mt.hmc(
            z(dim), lk_dp,
            mt.HMCSettings(step_size=0.05, n_leap_steps=2, n_burnin_draws=2,
                           n_keep_draws=3),
            n_chains=4, key=17, mesh=grid, **kw), (3, 4, dim))
    # 9) chain-sharded MCLMC (pooled tuning)
    run("mclmc", lambda: mt.mclmc(
        z(dim), log_kernel, mt.MCLMCSettings(n_burnin_draws=3,
                                             n_keep_draws=3),
        n_chains=n_chains, key=19, mesh=mesh, adapt_mass=True, **kw),
        (3, n_chains, dim))
    # 10) chain-sharded evidence ladder (pooled per-rung step sizes)
    half_log_2pi = 0.5 * dim * math.log(2 * math.pi)
    ev = mt.thermo_evidence(
        z(dim), lambda th: -0.5 * (th * th).sum(-1) - half_log_2pi,
        lambda th: -0.5 * ((th - 1.0) ** 2).sum(-1),
        mt.AlgoSettings(evidence_settings=mt.EvidenceSettings(
            n_burnin_draws=3, n_keep_draws=3, n_temps=4, n_leap_steps=2)),
        n_chains=n_chains, key=21, mesh=mesh, **kw)
    if not bool(torch.isfinite(ev.log_z)):
        raise AssertionError("evidence: non-finite log Z")
    paths["evidence"] = {"log_z": float(ev.log_z)}

    # 11) chain-sharded block Gibbs (an exact block and an HMC block)
    def cond0(gen, full):
        return 0.5 * full[:, 1:2] + torch.randn(
            (full.shape[0], 1), generator=gen, dtype=full.dtype,
            device=full.device)

    run("gibbs", lambda: mt.gibbs(
        z(3), lambda v: -0.5 * (v[:, 0] - 0.5 * v[:, 1]) ** 2
        - 0.5 * v[:, 1] ** 2 - 0.5 * v[:, 2] ** 2,
        mt.GibbsSettings(n_burnin_draws=2, n_keep_draws=3),
        blocks=[([0], cond0), ([1, 2], "hmc",
                               {"step_size": 0.3, "n_leap_steps": 2})],
        n_chains=n_chains, key=23, mesh=mesh, **kw), (3, n_chains, 3))
    return paths


def dryrun_multichip(n_devices: int, device=None, timeout_s: float = 600.0):
    """Start ``n_devices`` ranks (Gloo; on the card every rank shares this
    machine's first card) and run the JAX package's eleven sharded paths
    through the port on a mesh of them: NUTS, ChEES, MCLMC, the evidence
    ladder and block Gibbs chain-sharded; DE, SMC and the stretch ensemble
    population-sharded; AEES and PT ladder-sharded; HMC on a (chains,
    data) grid. Raises if a rank fails or the ranks' statistics differ;
    returns ``{"n_devices", "ok", "device", "paths", "seconds"}``."""
    from mcmc_tpu_torch.parallel import launch_local
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    t0 = time.perf_counter()
    ranks = launch_local(int(n_devices),
                         ["-m", "mcmc_tpu_torch.entry", "--dryrun-rank",
                          str(device)], timeout_s=timeout_s)
    stats = [{k: {kk: v for kk, v in p.items() if kk != "seconds"
                  and kk != "collectives"} for k, p in r.items()}
             for r in ranks]
    if any(st != stats[0] for st in stats[1:]):
        raise AssertionError(f"ranks disagree: {stats}")
    return {"n_devices": int(n_devices), "ok": True, "device": str(device),
            "paths": ranks[0], "seconds": time.perf_counter() - t0}


def _main(argv):
    if argv[:1] == ["--dryrun-rank"]:
        from mcmc_tpu_torch.parallel import init_distributed
        device = torch.device(argv[1])
        torch.set_num_threads(1)
        init_distributed(backend="gloo")
        print(json.dumps(_dryrun_rank(device)))
        torch.distributed.destroy_process_group()
        return 0
    if argv[:1] == ["--dryrun-multichip"]:
        n = int(argv[1])
        device = argv[argv.index("--device") + 1] if "--device" in argv \
            else None
        out = dryrun_multichip(n, device)
        text = json.dumps(out, indent=1)
        if "--out" in argv:
            with open(argv[argv.index("--out") + 1], "w") as f:
                f.write(text + "\n")
        print(text)
        return 0
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
