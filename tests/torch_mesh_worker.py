"""One rank of the port's multi-process checks (``tests/test_torch_multi
process.py`` starts it through ``mcmc_tpu_torch.parallel.launch_local``).

``python tests/torch_mesh_worker.py JOB DIR`` joins a Gloo process group
(rank and world from the launcher's environment), runs every check of
``JOB`` on the CPU with one torch thread, and prints one JSON line of
results; the inputs the JAX side made (``DIR/data.npz``) are read with
numpy. This file imports no JAX.
"""

import json
import math
import os
import sys
import time

import numpy as np
import torch

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import mcmc_tpu_torch as mt  # noqa: E402
from mcmc_tpu_torch import models, parallel as par  # noqa: E402
from mcmc_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402

CPU = {"device": "cpu"}
_T = [time.perf_counter()]


def _lap(out, name):
    """Each check's seconds since the last, under ``out["seconds"]``."""
    now = time.perf_counter()
    out.setdefault("seconds", {})[name] = now - _T[0]
    _T[0] = now


def bimodal(v):
    """Equal-weight Gaussian mixture at +-2 (the JAX tests' PT target)."""
    return torch.logaddexp(-0.5 * ((v - 2.0) ** 2).sum(-1),
                           -0.5 * ((v + 2.0) ** 2).sum(-1))


def mixture(sig_sq):
    mu = torch.tensor([[-2.0, -2.0], [2.0, 2.0]])
    return mu, models.gaussian_mixture_model(
        mu, torch.tensor([sig_sq, sig_sq]), torch.tensor([0.5, 0.5]),
        device="cpu")


def stats(d):
    """Shape, mean and variance of the draws, and the mean's Monte-Carlo
    standard error by 20 batch means over the draw axis."""
    d = d.double()
    b = d.reshape(20, -1).mean(1)
    return {"shape": list(d.shape), "mean": d.mean().item(),
            "var": d.var().item(), "se": (b.std() / math.sqrt(20)).item()}


def fed_sweeps(mesh):
    """The sharded DE and stretch sweeps fed the unsharded sweeps' draws
    row for row: equal to the unsharded sweeps bit for bit."""
    from mcmc_tpu_torch.parallel.de_sharded import build_sharded_de_sweep
    from mcmc_tpu_torch.parallel.stretch_sharded import \
        build_sharded_stretch_sweep
    from mcmc_tpu_torch.samplers.de import DEState, build_de_sweep
    from mcmc_tpu_torch.samplers.stretch import (StretchState,
                                                 build_stretch_sweep)
    lk = lambda v: -0.5 * ((v - 1.0) ** 2).sum(-1) - 0.1 * (v ** 4).sum(-1)
    out = {}
    g = torch.Generator().manual_seed(5)     # the same on every rank
    n, d = 16, 3
    X = torch.randn((n, d), generator=g)
    de_cfg = mt.DESettings(n_pop=n, jumps=True)
    full = build_de_sweep(lk, de_cfg, d)
    st = DEState(X=X, kernel_vals=lk(X),
                 gen_ind=torch.tensor(8, dtype=torch.int32))
    shard = build_sharded_de_sweep(lk, de_cfg, d, mesh)
    rows = shard.rows
    ok = True
    for _ in range(3):   # the jump generation (gen_ind 9) among them
        draws = full.draw(g, st)
        ref, info = full.transition(st, *draws)
        loc, linfo = shard.transition(
            DEState(st.X[rows], st.kernel_vals[rows], st.gen_ind),
            *[v[rows] for v in draws])
        ok &= bool(torch.equal(loc.X, ref.X[rows])
                   and torch.equal(loc.kernel_vals, ref.kernel_vals[rows])
                   and torch.equal(linfo["accepted"], info["accepted"][rows]))
        st = ref
    out["de_fed_equal"] = ok
    _lap(out, "de_fed_equal")
    s_cfg = mt.StretchSettings(n_walkers=n)
    full = build_stretch_sweep(lk, s_cfg, d)
    st = StretchState(X=X, kernel_vals=lk(X))
    shard = build_sharded_stretch_sweep(lk, s_cfg, d, mesh)
    rows = shard.rows
    ok = True
    for _ in range(3):
        j_a, uz_a, u_a, j_b, uz_b, u_b = full.draw(g, st)
        ref, info = full.transition(st, j_a, uz_a, u_a, j_b, uz_b, u_b)
        fed = [torch.cat(p)[rows] for p in ((j_a, j_b), (uz_a, uz_b),
                                            (u_a, u_b))]
        loc, linfo = shard.transition(
            StretchState(st.X[rows], st.kernel_vals[rows]), *fed)
        ok &= bool(torch.equal(loc.X, ref.X[rows])
                   and torch.equal(loc.kernel_vals, ref.kernel_vals[rows])
                   and torch.equal(linfo["accepted"], info["accepted"][rows]))
        st = ref
    out["stretch_fed_equal"] = ok
    _lap(out, "stretch_fed_equal")
    return out


def kernel_of_data(beta, d):
    """Logistic log-likelihood with a standard-normal log prior (its
    normalising constant included), so a prior counted once per data rank
    misses by several nats and by beta in the gradient; the JAX side in
    ``tests/test_torch_multiprocess.py`` computes the same function."""
    Xa, ya = d
    eta = beta @ Xa.T
    ll = (ya * eta - torch.nn.functional.softplus(eta)).sum(-1)
    return ll - 0.5 * (beta * beta).sum(-1) \
        - 0.5 * beta.shape[-1] * math.log(2 * math.pi)


def data_parallel(data, grid):
    """The grid's data-parallel value and gradient at three parameter
    batches (the test holds them against JAX's and the unsharded
    kernel's), and the same sum without the prior's correction, each data
    rank's prior kept (the test shows its check tells the two apart)."""
    X = torch.from_numpy(data["dp_X"])
    y = torch.from_numpy(data["dp_y"])
    betas = torch.from_numpy(data["dp_betas"])
    ax = mesh_mod.mesh_axis(grid, "data")
    shard = par.shard_data_axis((X, y), grid)

    def prior_per_rank(b):
        p = mesh_mod._CopyToGroup.apply(b, ax.group)
        return mesh_mod._ReduceFromGroup.apply(kernel_of_data(p, shard),
                                               ax.group)

    out = {}
    for name, lk in (("dp", par.data_parallel_kernel(kernel_of_data, (X, y),
                                                     grid)),
                     ("dp_prior_per_rank", prior_per_rank)):
        b = betas.clone().requires_grad_(True)
        v = lk(b)
        (g,) = torch.autograd.grad(v.sum(), b)
        out[f"{name}_value"], out[f"{name}_grad"] = v.tolist(), g.tolist()
    return out


def job2(tmp, data):
    mesh = par.make_mesh()
    out = fed_sweeps(mesh)
    # test_multiprocess.py:249's case: HMC on N(1.5, 1), 32 chains
    lk15 = lambda v: -0.5 * ((v - 1.5) ** 2).sum(-1)
    r = mt.hmc(torch.zeros(3), lk15,
               mt.HMCSettings(n_burnin_draws=100, n_keep_draws=300,
                              step_size=0.4, n_leap_steps=5),
               n_chains=32, key=0, mesh=mesh, **CPU)
    out["hmc"] = {**stats(r.draws), "acc": float(r.accept_rate.mean())}
    _lap(out, "hmc")
    # pooled NUTS: every chain on every rank ends with one step size, mass
    r = mt.nuts(torch.zeros(3), lk15,
                mt.NUTSSettings(n_burnin_draws=100, n_keep_draws=60),
                n_chains=16, key=1, mesh=mesh, pooled_adaptation=True,
                adapt_mass_matrix=True, **CPU)
    out["nuts"] = {**stats(r.draws),
                   "step_size": r.diagnostics["step_size"][-1].tolist(),
                   "inv_mass": r.diagnostics["inv_mass_diag"].tolist()}
    _lap(out, "nuts")
    # test_rmhmc_de_aees.py:122's case
    lk_x31 = models.gaussian_mean_model(torch.from_numpy(data["x31"]),
                                        sigma=1.0, device="cpu")
    r = mt.de(torch.tensor([1.0]), lk_x31,
              mt.DESettings(n_pop=64, n_burnin_draws=400, n_keep_draws=400),
              key=2, mesh=mesh, **CPU)
    out["de"] = {**stats(r.draws),
                 "rate": int(r.n_accept_draws) / (400 * 64)}
    _lap(out, "de")
    # test_stretch.py:142's case
    lk_x1 = models.gaussian_mean_model(torch.from_numpy(data["x1"]),
                                       device="cpu")
    r = mt.stretch(torch.tensor([1.0]), lk_x1,
                   mt.StretchSettings(n_walkers=64, n_burnin_draws=200,
                                      n_keep_draws=400),
                   key=3, mesh=mesh, **CPU)
    out["stretch"] = {**stats(r.draws), "acc": float(
        r.diagnostics["accept_rate_per_walker"].mean())}
    _lap(out, "stretch")
    # test_smc.py:140's case
    r = mt.smc(torch.zeros(3), lambda v: -0.5 * ((v - 1.0) ** 2).sum(-1)
               / 1.69, mt.SMCSettings(n_particles=4096, init_scale=3.0),
               key=4, mesh=mesh, **CPU)
    out["smc"] = {"mean": r.draws.mean(0).tolist(),
                  "var": r.draws.var(0, unbiased=False).tolist(),
                  "log_z": float(r.diagnostics["log_z"]),
                  "completed": bool(r.diagnostics["completed"])}
    _lap(out, "smc")
    # test_multiprocess.py:181's ladders, two rungs
    r = par.pt_sharded(torch.zeros(2), bimodal,
                       mt.PTSettings(n_burnin_draws=150, n_keep_draws=600,
                                     temper_vec=[16.0], inner="hmc",
                                     step_size=0.25, n_leap_steps=5),
                       mesh=mesh, key=5, **CPU)
    out["pt_sharded"] = {**stats(r.draws),
                         "frac_hi": float((r.draws[:, 0] > 0).double()
                                          .mean()),
                         "swap": r.diagnostics["swap_accept_rate"].tolist()}
    _lap(out, "pt_sharded")
    mu, lk_mix = mixture(0.1)
    r = par.aees_sharded(mu[0], lk_mix,
                         mt.AEESSettings(n_initial_draws=150,
                                         n_burnin_draws=150,
                                         n_keep_draws=800, n_rings=5,
                                         ee_prob_par=0.1, temper_vec=[30.0],
                                         cov_mat=0.35 * np.eye(2)),
                         mesh=mesh, key=6, **CPU)
    out["aees_sharded"] = {**stats(r.draws), "frac_hi": float(
        (r.draws[:, 0] > 0).double().mean())}
    _lap(out, "aees_sharded")
    out.update(data_parallel(data, par.make_grid_mesh(1, 2)))
    # test_mclmc.py:186's case
    sd = torch.tensor([1.0, 2.0])
    r = mt.mclmc(torch.zeros(2), lambda v: -0.5 * ((v / sd) ** 2).sum(-1),
                 mt.MCLMCSettings(n_burnin_draws=200, n_keep_draws=300),
                 n_chains=64, key=7, mesh=mesh, **CPU)
    out["mclmc"] = {"std": r.draws.std(dim=(0, 1)).tolist(),
                    "mean": r.draws.mean(dim=(0, 1)).tolist(),
                    "rhat": float(mt.diagnostics.split_rhat(r.draws).max())}
    _lap(out, "mclmc")
    # test_gibbs.py:235's case
    r = mt.gibbs(torch.zeros(3), lambda v: -0.5 * (v * v).sum(-1),
                 mt.GibbsSettings(n_burnin_draws=30, n_keep_draws=40),
                 blocks=[([0, 1], "hmc", {"step_size": 0.5,
                                          "n_leap_steps": 2}),
                         ([2], "slice")],
                 n_chains=16, key=8, mesh=mesh, **CPU)
    out["gibbs"] = stats(r.draws)
    _lap(out, "gibbs")
    # test_elliptical.py:158's case
    r = mt.elliptical_slice(torch.zeros(1),
                            lambda x: -0.5 * ((x - 1.0) ** 2).sum(-1),
                            mt.EllipticalSettings(n_burnin_draws=200,
                                                  n_keep_draws=1000),
                            n_chains=16, key=9, mesh=mesh, **CPU)
    out["ellipse"] = stats(r.draws)
    _lap(out, "ellipse")
    # test_thin.py:82's case
    r = mt.mala(torch.tensor([1.0]), lk_x1,
                mt.MALASettings(n_burnin_draws=200, n_keep_draws=200,
                                step_size=0.05),
                n_chains=16, key=10, thin=2, mesh=mesh, **CPU)
    out["mala_thin"] = stats(r.draws)
    _lap(out, "mala_thin")
    # test_demcz.py:206's case
    r = mt.demcz(torch.tensor([1.0]), lk_x1,
                 mt.DEMCZSettings(n_pop=6, n_burnin_draws=500,
                                  n_keep_draws=1000),
                 n_runs=8, key=11, mesh=mesh, **CPU)
    out["demcz"] = stats(r.draws)
    _lap(out, "demcz")
    # library PT: 8 ladders, pooled ladder adaptation over both ranks
    r = mt.pt(torch.zeros(2), bimodal,
              mt.PTSettings(n_burnin_draws=200, n_keep_draws=200, n_temps=4,
                            max_temp=20.0, adapt_temps=True, inner="hmc",
                            step_size=0.25, n_leap_steps=3),
              n_chains=8, key=12, mesh=mesh, **CPU)
    out["pt_ladders"] = {"temperatures": r.diagnostics["temperatures"]
                         .tolist(), "shape": list(r.draws.shape)}
    _lap(out, "pt_ladders")
    # the evidence ladder: log Z of N(0, I) prior x N(1, I) likelihood
    ev = mt.thermo_evidence(
        torch.zeros(2), lambda th: -0.5 * (th * th).sum(-1) - math.log(
            2 * math.pi),
        lambda th: -0.5 * ((th - 1.0) ** 2).sum(-1),
        mt.AlgoSettings(evidence_settings=mt.EvidenceSettings(
            n_burnin_draws=100, n_keep_draws=150, n_temps=8)),
        n_chains=16, key=13, mesh=mesh, **CPU)
    out["evidence"] = {"log_z": float(ev.log_z), "se": float(ev.log_z_se),
                       "step_sizes": ev.step_sizes.tolist()}
    _lap(out, "evidence")
    # shared-minibatch SGLD over the mesh: one index draw for every rank
    xs = torch.from_numpy(data["x1"])
    r = mt.sgld(torch.tensor([1.0]), lambda th: -0.5 * (th - 1.0).pow(2)
                .sum(-1) / 4.0,
                lambda th, b: -0.5 * ((b - th) ** 2).sum(-1),
                xs, mt.SGLDSettings(n_burnin_draws=300, n_keep_draws=300,
                                    batch_size=20, step_size=1e-3),
                n_chains=8, key=14, mesh=mesh, **CPU)
    out["sgld"] = {**stats(r.draws), "acc": float(r.accept_rate.mean())}
    _lap(out, "sgld")
    # in memory and checkpointed on the mesh: bit-equal
    s = mt.HMCSettings(n_burnin_draws=20, n_keep_draws=60, step_size=0.4,
                       n_leap_steps=3)
    a = mt.hmc(torch.zeros(3), lk15, s, n_chains=8, key=15, mesh=mesh,
               **CPU)
    b = mt.hmc(torch.zeros(3), lk15, s, n_chains=8, key=15, mesh=mesh,
               checkpoint_dir=os.path.join(tmp, "mem_vs_ckpt"),
               checkpoint_every=25, **CPU)
    out["ckpt_equal"] = bool(torch.equal(a.draws, b.draws.to(a.draws.dtype))
                             and torch.equal(a.n_accept_draws,
                                             b.n_accept_draws))
    _lap(out, "ckpt_equal")
    # the other chain entry points over the mesh, pooled adaptation on
    # where they have it: moments of N(0, I) (SGHMC's discretised law at
    # eta 0.3, alpha 0.8) and the adapted parameters of every chain
    sq = lambda v: -0.5 * (v * v).sum(-1)
    fisher = lambda v: torch.eye(2).expand(v.shape[0], 2, 2)
    few = dict(n_burnin_draws=200, n_keep_draws=400)
    runs = {
        "ghmc": lambda: mt.ghmc(torch.zeros(2), sq, mt.GHMCSettings(**few),
                                n_chains=8, key=40, mesh=mesh, **CPU),
        "mams": lambda: mt.mams(torch.zeros(2), sq, mt.MAMSSettings(**few),
                                n_chains=8, key=41, adapt_mass=True,
                                mesh=mesh, **CPU),
        "rwmh": lambda: mt.rwmh(torch.zeros(2), sq, mt.RWMHSettings(**few),
                                n_chains=8, key=42, adapt_scale=True,
                                adapt_precond=True, pooled_adaptation=True,
                                mesh=mesh, **CPU),
        "rmhmc": lambda: mt.rmhmc(torch.zeros(2), sq, fisher,
                                  mt.RMHMCSettings(**few), n_chains=8,
                                  key=43, mesh=mesh, **CPU),
        "barker": lambda: mt.barker(torch.zeros(2), sq,
                                    mt.BarkerSettings(**few), n_chains=8,
                                    key=44, adapt_step_size=True,
                                    adapt_precond=True,
                                    pooled_adaptation=True, mesh=mesh,
                                    **CPU),
        "mmala": lambda: mt.mmala(torch.zeros(2), sq, fisher,
                                  mt.MMALASettings(**few), n_chains=8,
                                  key=45, adapt_step_size=True, mesh=mesh,
                                  **CPU),
        "slice_sampler": lambda: mt.slice_sampler(
            torch.zeros(2), sq, mt.SliceSettings(**few), n_chains=8,
            key=46, adapt_w=True, pooled_adaptation=True, mesh=mesh, **CPU),
        "sghmc": lambda: mt.sghmc(
            torch.zeros(1), sq, lambda th, b: 0.0 * th.sum(-1),
            torch.zeros((4, 1)),
            mt.SGHMCSettings(**few, step_size=0.3, friction_alpha=0.8,
                             batch_size=2), n_chains=8, key=47,
            minibatch="shared", mesh=mesh, **CPU),
    }
    adapted = {"ghmc": ["adapted_step_size"],
               "mams": ["adapted_step_size", "adapted_L"],
               "rwmh": ["adapted_scale", "proposal_var"],
               "barker": ["adapted_step_size", "precond_var"],
               "mmala": ["adapted_step_size"],
               "slice_sampler": ["adapted_w"]}
    out["entry_points"] = {}
    for name, run in runs.items():
        r = run()
        out["entry_points"][name] = {
            **stats(r.draws), "finite": bool(torch.isfinite(r.draws).all()),
            "adapted": {k: r.diagnostics[k].tolist()
                        for k in adapted.get(name, [])}}
    _lap(out, "entry_points")
    # fit over the mesh: NUTS with its warmup, every rank's chains pooled
    r = mt.fit(torch.zeros(3), lk15, n_chains=8, n_warmup=100, n_draws=60,
               key=16, mesh=mesh, **CPU)
    out["fit"] = stats(r.draws)
    _lap(out, "fit")
    from mcmc_tpu_torch.entry import _dryrun_rank
    out["dryrun"] = sorted(_dryrun_rank(torch.device("cpu")))
    _lap(out, "dryrun")
    return out


def job4(tmp, data):
    mesh = par.make_mesh()
    out = fed_sweeps(mesh)
    # test_rmhmc_de_aees.py:140 and :240's cases, four rungs
    mu, lk_mix = mixture(0.1)
    aes = lambda: mt.AEESSettings(
        n_initial_draws=80, n_burnin_draws=80, n_keep_draws=800,
        n_rings=11, ee_prob_par=0.05, temper_vec=[60.0, 20.0, 9.0],
        cov_mat=0.35 * np.eye(2))
    for name, cap in (("aees_sharded", None), ("aees_capped", 256)):
        r = par.aees_sharded(mu[0], lk_mix, aes(), mesh=mesh, key=20,
                             history_capacity=cap, **CPU)
        d = r.draws
        pos, neg = d[d[:, 0] > 0.1], d[d[:, 0] < -0.1]
        out[name] = {"n_pos": len(pos), "n_neg": len(neg),
                     "pos_mean": pos.mean(0).tolist(),
                     "neg_mean": neg.mean(0).tolist()}
        _lap(out, name)
    # test_rmhmc_de_aees.py:268's case: whole ladders per rank
    mu5, lk5 = mixture(0.5)
    r = mt.aees(mu5[0], lk5,
                mt.AEESSettings(n_initial_draws=100, n_burnin_draws=100,
                                n_keep_draws=400, n_rings=5, ee_prob_par=0.1,
                                temper_vec=[20.0, 4.0],
                                cov_mat=0.5 * np.eye(2)),
                key=21, n_runs=8, mesh=mesh, history_capacity=128, **CPU)
    pooled = r.draws.reshape(-1, 2)
    out["aees_runs"] = {"shape": list(r.draws.shape),
                        "frac_hi": float((pooled[:, 0] > 0.1).double()
                                         .mean()),
                        "frac_lo": float((pooled[:, 0] < -0.1).double()
                                         .mean())}
    _lap(out, "aees_runs")
    # test_pt.py:187's case on four rungs
    pts = mt.PTSettings(n_burnin_draws=100, n_keep_draws=500, n_temps=4,
                        max_temp=50.0, inner="hmc", step_size=0.25,
                        n_leap_steps=5)
    r = par.pt_sharded(torch.zeros(2), bimodal, pts, mesh=mesh, key=22,
                       **CPU)
    out["pt_sharded"] = {"frac": float((r.draws[:, 0] > 0).double().mean()),
                         "swap": r.diagnostics["swap_accept_rate"].tolist()}
    _lap(out, "pt_sharded")
    # test_data_parallel.py: the (2, 2) grid, value and gradient, and HMC
    grid = par.make_grid_mesh(2, 2)
    out.update(data_parallel(data, grid))
    X = torch.from_numpy(data["dp_X"])
    y = torch.from_numpy(data["dp_y"])
    lk = par.data_parallel_kernel(kernel_of_data, (X, y), grid)
    r = mt.hmc(torch.zeros(8), lk,
               mt.HMCSettings(n_burnin_draws=40, n_keep_draws=60,
                              step_size=0.02, n_leap_steps=5),
               n_chains=8, key=23, mesh=grid, **CPU)
    out["hmc_grid"] = {"mean": r.draws.double().mean((0, 1)).tolist(),
                       "var": r.draws.double().var((0, 1)).tolist(),
                       "acc": float(r.accept_rate.mean())}
    _lap(out, "hmc_grid")
    # pooled ChEES over four ranks: every chain's adapted trajectory length
    r = mt.chees(torch.zeros(3), lambda v: -0.5 * (v * v).sum(-1),
                 mt.ChEESSettings(n_burnin_draws=100, n_keep_draws=100),
                 n_chains=16, key=24, mesh=mesh, **CPU)
    out["chees"] = {**stats(r.draws),
                    "step_size": r.diagnostics["step_size"].tolist()
                    if torch.is_tensor(r.diagnostics.get("step_size"))
                    else None}
    _lap(out, "chees")
    return out


def crash_resume(tmp, data, crash_after):
    """Checkpointed NUTS on the mesh; ``crash_after > 0`` ends every rank
    with exit code 17 once rank 0 has made that many chunks durable (the
    JAX package's kill test, ``tests/test_checkpoint_runtime.py:301``)."""
    from mcmc_tpu_torch import checkpoint
    from mcmc_tpu_torch.runtime import DrawSink
    if crash_after > 0:
        orig = DrawSink.append
        seen = {"n": 0}

        def crashing(self, arr):
            orig(self, arr)
            seen["n"] += 1
            if seen["n"] > crash_after:
                self.flush()
                os._exit(17)
        checkpoint.DrawSink.append = crashing
    mesh = par.make_mesh()
    run_dir = os.path.join(tmp, sys.argv[3])   # the checkpoint directory
    r = mt.nuts(torch.zeros(3), lambda v: -0.5 * (v * v).sum(-1),
                mt.NUTSSettings(n_burnin_draws=50, n_keep_draws=100,
                                n_adapt_draws=50),
                n_chains=8, key=30, mesh=mesh, checkpoint_dir=run_dir,
                checkpoint_every=25, **CPU)
    return {"draws": r.draws.tolist()}


def main():
    job, tmp = sys.argv[1], sys.argv[2]
    par.init_distributed(backend="gloo", timeout_s=120)
    data = dict(np.load(os.path.join(tmp, "data.npz")))
    if job == "2":
        out = job2(tmp, data)
    elif job == "4":
        out = job4(tmp, data)
    else:
        out = crash_resume(tmp, data, int(job.split(":")[1]))
    out["rank"] = torch.distributed.get_rank()
    _lap(out, "rank")
    out["collectives"] = dict(mesh_mod.COUNTS)
    _lap(out, "collectives")
    print(json.dumps(out))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
