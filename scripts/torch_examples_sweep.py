"""Run every example of ``examples_torch/`` on the card and check what each
one prints.

Each script runs in a subprocess of its own from the repository root, at
its full settings (no ``--quick``), on the card (the scripts' default
device), under a time limit of ``--timeout`` seconds (600). Its last line
of output is its figures (one JSON object). Each example is then checked:

- against its own truth where it has one (the data's true parameters, the
  conjugate or closed-form posterior, the exact log Z of a linear-Gaussian
  model), each bound stated beside its check;
- against the figures the JAX example printed on the CPU
  (``examples_torch/jax_cpu_figures.json``, written by
  ``scripts/jax_examples_figures.py``) where they do not depend on the data,
  which the two packages draw differently (JAX keys against numpy seeds):
  acceptance rates, R-hat under its gate, ESS per draw, adapted step sizes
  and trajectory lengths, the sign and size of the log Bayes factor, the
  correlation with the truth;
- on R-hat under a gate, where the JAX script prints one.

``fused_glm_probit.py`` also reports the launches of the fused GLM
trajectory kernel (K1) on its two runs, which must equal their transitions:
the kernel ran, not its plain version.

One JSON line per example is printed (name, status, seconds, figures,
checks with their values and bounds), and all of it is written to
``examples_torch/examples_h100.json`` with the card's name and power limit
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``). The
exit code is 1 if any example fails, runs past its limit, prints no figures
or misses a check. From the repository root, on a machine with the card:

    python3 scripts/torch_examples_sweep.py [--only name ...] [--timeout S]
"""

import argparse
import json
import math
import os
import platform
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples_torch"
JAX_FIGURES = EXAMPLES / "jax_cpu_figures.json"
OUT = EXAMPLES / "examples_h100.json"
# arguments beyond the defaults: distributed_hmc.py runs a world of one
# unless asked for ranks; the sweep starts two, as its usage text does
ARGS = {"distributed_hmc": ["--nproc", "2"]}
# a truth check's bound in MC standard errors (chip_smoke.py's
# NUTS_MEAN_SIGMAS)
SIGMAS = 5.0


class Checks:
    """The checks of one example: each a name, a value, a bound and a
    verdict."""

    def __init__(self):
        self.items = []

    def add(self, name, value, bound, ok):
        self.items.append({"check": name, "value": value, "bound": bound,
                           "ok": bool(ok)})

    def at_most(self, name, value, hi):
        self.add(name, value, f"<= {hi:g}", value <= hi)

    def at_least(self, name, value, lo):
        self.add(name, value, f">= {lo:g}", value >= lo)

    def equal(self, name, value, want):
        self.add(name, value, f"== {want!r}", value == want)

    def near(self, name, value, ref, tol, what="JAX"):
        """``|value - ref| <= tol``."""
        self.add(name, value, f"{what} {ref:.6g} +- {tol:g}",
                 abs(value - ref) <= tol)

    def ratio(self, name, value, ref, factor, what="JAX"):
        """``value / ref`` within ``[1 / factor, factor]``."""
        ok = ref > 0 and value > 0 and 1 / factor <= value / ref <= factor
        self.add(name, value, f"{what} {ref:.6g} within x{factor:g}", ok)

    def within_mcse(self, name, mean, mcse, exact, sigmas=SIGMAS):
        """Each coordinate of ``mean`` within ``sigmas`` of its MC standard
        error from ``exact``."""
        z = max(abs(m - e) / s for m, e, s in zip(mean, exact, mcse))
        self.add(name, z, f"<= {sigmas:g} MC standard errors from "
                 f"{[round(e, 6) for e in exact]}", z <= sigmas)


def jax_array(figs, label, n):
    """The ``n`` numbers JAX printed after ``label``, across the lines a
    long array wraps onto (parsed under the labels ``''``, ``'#2'``, ...)."""
    out, taking = [], False
    for k, v in figs.items():
        if k == label:
            taking = True
            out.extend(v)
        elif taking and re.fullmatch(r"(#\d+)?", k):
            out.extend(v)
        elif taking:
            break
        if taking and len(out) >= n:
            break
    return out[:n]


def check_example(name, f, j):
    """The checks of example ``name`` on its figures ``f`` and JAX's ``j``
    (``label -> [numbers]``)."""
    c = Checks()
    if name == "rwmh_normal_mean":
        c.within_mcse("mean vs the conjugate posterior mean", f["mean"],
                      f["mcse"], f["exact_mean"])
        # the posterior sd is 1/sqrt(100.25) for any data: acceptance is
        # data-independent (MC error about 0.02 over 2000 draws)
        c.near("accept rate", f["accept_rate"], j["acceptance rate"][0], 0.05)
    elif name in ("mala_normal", "hmc_normal", "hmc_normal_autodiff",
                  "nuts_normal"):
        c.within_mcse("mean vs the closed-form posterior mean", f["mean"],
                      f["mcse"], f["exact_mean"])
        if name == "mala_normal":
            c.near("accept rate", f["accept_rate"],
                   j["acceptance rate"][0], 0.05)
        else:
            # one step of 0.08 against a posterior sd of 0.063 (2 /
            # sqrt(1000)) scaled by each data set's sd: the JAX package's
            # two HMC examples on this model read 0.6095 and 0.5305
            c.near("accept rate", f["accept_rate"],
                   j["acceptance rate"][0], 0.1)
        if name == "hmc_normal_autodiff":
            err = max(abs(a - b) / abs(b) for a, b in
                      zip(f["grad"], f["grad_by_hand"]))
            c.at_most("autograd gradient vs the hand-derived one "
                      "(relative)", err, 1e-4)
        if name == "nuts_normal":
            c.near("mean tree depth", f["mean_tree_depth"],
                   j["mean tree depth"][0], 0.5)
            c.ratio("adapted step size", f["adapted_step_size"],
                    j["adapted step size"][0], 1.5)
    elif name == "rmhmc_normal":
        c.within_mcse("mean vs the closed-form posterior mean (C5)",
                      f["mean"], f["mcse"], f["exact_mean"])
        c.near("accept rate", f["accept_rate"], j["acceptance rate"][0],
               0.02)
    elif name == "rmhmc_funnel_softabs":
        c.equal("draws finite", f["finite"], True)
        c.near("accept rate", f["accept_rate"], j["accept"][0], 0.1)
        # v ~ N(0, 3^2): the mean within 5 MC standard errors of 0
        c.at_most("|v mean| / MC standard error (truth 0)",
                  abs(f["v_mean"]) / (f["v_std"] / math.sqrt(f["v_ess"])),
                  SIGMAS)
        # RM-HMC misses the neck's far tail in both packages (JAX: sd
        # 2.423 against 3)
        c.near("v std", f["v_std"], j["v mean / std (truth 0 / 3)"][1],
               0.15 * j["v mean / std (truth 0 / 3)"][1])
        c.at_most("deepest neck visited (v min)", f["v_min"], -5.0)
    elif name == "de_normal_mean":
        c.within_mcse("mean vs the conjugate posterior mean (population as "
                      "chains)", f["mean"], f["mcse"], f["exact_mean"])
        c.near("accept rate", f["accept_rate"], j["acceptance rate"][0],
               0.05)
    elif name == "aees_mixture":
        for key, t in (("mean_pos", 2.0), ("mean_neg", -2.0)):
            c.at_most(f"{key}: max |mean - ({t:g}, {t:g})| (mode sd 0.32)",
                      max(abs(v - t) for v in f[key]), 0.1)
        c.add("mode share (truth 0.5)", f["mode_share"], "in [0.2, 0.8]",
              0.2 <= f["mode_share"] <= 0.8)
        jee = [v for v in j["per-rung EE accept"] if v > 0]
        pee = [v for v in f["auto_ee_accept"] if v > 0]
        c.near("auto ladder: mean EE accept of the rungs below the hottest",
               sum(pee) / len(pee), sum(jee) / len(jee), 0.1)
    elif name == "pt_mixture":
        for key, t in (("mean_pos", 2.0), ("mean_neg", -2.0)):
            c.at_most(f"{key}: max |mean - ({t:g}, {t:g})| (mode sd 0.32)",
                      max(abs(v - t) for v in f[key]), 0.1)
        c.near("mode balance (truth 0.5)", f["mode_balance"], 0.5, 0.1,
               what="truth")
        js = j["swap acceptance"]
        c.near("mean swap acceptance", sum(f["swap_accept_rate"])
               / len(f["swap_accept_rate"]), sum(js) / len(js), 0.1)
    elif name == "smc_mixture":
        c.near("mode mass at +2", f["mode_mass_pos"], 0.7, 0.05,
               what="truth")
        c.at_most("|log Z| (exact 0)", abs(f["log_z"]), 0.1)
        for key, t in (("mean_pos", 2.0), ("mean_neg", -2.0)):
            c.at_most(f"{key}: max |mean - ({t:g}, {t:g})|",
                      max(abs(v - t) for v in f[key]), 0.05)
        c.near("stages", f["n_stages"], j["stages"][0], 1)
    elif name == "stretch_correlated":
        c.at_most("max |cov - true cov|", max(
            abs(a - b) for a, b in zip(f["cov"], f["true_cov"])), 0.1)
        c.near("mean accept per walker", f["accept_rate"],
               j["mean accept/walker"][0], 0.05)
    elif name == "demcz_smallpop":
        c.near("accept rate", f["accept_rate"], j["accept rate"][0], 0.05)
        c.near("marginal var", f["marginal_var"], 1.0, 0.15, what="truth")
        c.near("corr[0,1]", f["corr01"], 0.8, 0.05, what="truth")
        # eight walkers coupled through one archive
        c.at_most("max split R-hat", f["max_split_rhat"], 1.05)
    elif name == "fused_glm_probit":
        c.at_least("probit: corr(posterior mean, truth)", f["probit_corr"],
                   0.95)
        c.near("probit: corr(posterior mean, truth)", f["probit_corr"],
               j["probit"][0], 0.03)
        c.near("probit: accept rate", f["probit_accept_rate"],
               j["accept rate ="][0], 0.05)
        # the JAX example's 32 CPU chains read 1.0105; the card runs 512
        c.at_most("probit: max rank R-hat", f["probit_max_rank_rhat"], 1.02)
        c.near("student-t: corr(posterior mean, truth)", f["studentt_corr"],
               j["student-t"][0], 0.02)
        c.near("student-t: accept rate", f["studentt_accept_rate"],
               j["accept rate =#2"][0], 0.08)
        for link in ("probit", "studentt"):
            c.equal(f"K1 launches on the {link} run (one a transition)",
                    f["k1_launches"][link], f["transitions_per_link"])
    elif name == "chees_logreg":
        c.at_most("max split R-hat", f["max_split_rhat"], 1.01)
        c.ratio("adapted trajectory length",
                f["adapted_trajectory_length"],
                j["adapted trajectory length"][0], 2.0)
        c.ratio("mean leapfrogs per draw", f["mean_leapfrogs_per_draw"],
                j["mean leapfrogs/draw"][0], 2.0)
        # 25 features scaled 1/5 over 500 rows inform beta weakly; JAX
        # prints only the first five coordinates
        c.at_least("corr(posterior mean, truth)", f["corr_with_truth"], 0.7)
    elif name == "mclmc_logreg":
        c.at_most("bias audit: max |dmean| / max posterior sd",
                  f["bias_max_dmean"] / f["posterior_sd_max"], 0.1)
        c.at_most("bias audit: max |dstd| / std", f["bias_max_dstd"], 0.1)
        c.near("mams accept rate", f["mams_accept_rate"],
               j["mams accept rate"][0], 0.08)
        c.ratio("mams mean leapfrogs per draw",
                f["mams_mean_leapfrogs_per_draw"], j["mams accept rate"][1],
                2.0)
        c.ratio("mclmc adapted step", f["mclmc_step"],
                j["mclmc adapted step"][0], 2.0)
        c.ratio("mclmc adapted L", f["mclmc_L"], j["mclmc adapted step"][1],
                2.0)
        c.at_most("mclmc max split R-hat", f["mclmc_max_split_rhat"], 1.01)
        c.at_most("mams max split R-hat", f["mams_max_split_rhat"], 1.01)
        c.at_least("mams corr(posterior mean, truth)",
                   f["mams_corr_with_truth"], 0.7)
    elif name == "fit_quickstart":
        # the eight schools' data are the same in both packages
        jm = jax_array(j, "posterior mean", 10)
        js = jax_array(j, "mcse", 10)
        z = max(abs(a - b) / math.hypot(s, t) for a, b, s, t in
                zip(f["mean"], jm, f["mcse"], js))
        c.at_most("max |mean - JAX's| / combined MC standard error", z,
                  SIGMAS)
        c.at_most("max split R-hat", f["max_split_rhat"], 1.01)
        c.ratio("min ESS per draw", f["min_ess_per_draw"],
                min(jax_array(j, "ESS", 10)) / 8000.0, 2.0)
    elif name == "map_laplace_init":
        c.at_most("grad norm at the mode", f["grad_norm"], 0.05)
        c.at_most("max |posterior mean - MAP| / Laplace sd",
                  f["max_abs_mean_minus_map_over_sd"], 0.5)
        c.at_least("corr(posterior mean, truth)", f["corr_with_truth"], 0.9)
        # 16 chains of 500 draws
        c.at_most("max rank R-hat", f["max_rank_rhat"], 1.02)
    elif name == "pathfinder_init":
        c.at_most("pooled pareto-k", f["pareto_k"], 0.7)
        c.at_most("max |Pathfinder draw mean - posterior mean|",
                  f["draw_mean_minus_fit_mean_max"], 0.15)
        c.at_least("corr(posterior mean, truth)", f["corr_with_truth"], 0.9)
        c.at_most("max rank R-hat", f["max_rank_rhat"], 1.02)
        c.at_most("funnel: latest winning iterate (none at the path's end, "
                  "40)", max(f["funnel_best_iter"]), 39)
        c.at_most("funnel: |v mean| (v ~ N(0, 3^2))",
                  abs(f["funnel_v_mean"]), 3.0)
    elif name == "approximate_inference":
        # the posterior's smallest sd is about 0.034; its covariance's
        # entries are about 1e-3
        for m, e in f["mean_err"].items():
            c.at_most(f"{m}: max |mean - exact|", e, 0.01)
        for m, e in f["cov_err"].items():
            c.at_most(f"{m}: max |cov - exact|", e, 0.001)
        c.at_most("pathfinder pareto-k", f["pathfinder_pareto_k"], 0.7)
    elif name == "model_comparison":
        c.equal("ranking", f["ranking"], ["linear", "intercept-only"])
        c.at_least("elpd difference / its standard error",
                   f["elpd_diff"] / f["se_diff"], 4.0)
        for m in ("linear", "intercept"):
            c.at_most(f"{m}: max pareto-k", f["max_pareto_k"][m], 0.7)
        c.near("linear: p_eff (3 parameters)", f["p_eff"]["linear"],
               j["linear"][2], 1.0)
        c.near("intercept: p_eff (2 parameters)", f["p_eff"]["intercept"],
               j["intercept"][2], 1.0)
    elif name == "evidence_bayes_factor":
        # chip_smoke.py phase 18's gates on the same models
        for m in ("linear", "quadratic"):
            g = f[m]
            c.at_most(f"{m}: |stepping-stone - exact| / SE",
                      abs(g["ss"] - g["exact"]) / g["ss_se"], SIGMAS)
            c.at_most(f"{m}: |corrected TI - exact| / SE",
                      abs(g["ti"] - g["exact"]) / g["ti_se"], SIGMAS)
            c.at_most(f"{m}: |nested - exact| / error bar",
                      abs(g["nested"] - g["exact"]) / g["nested_err"], 3.0)
            c.at_most(f"{m}: |Laplace - exact| (Gaussian posterior)",
                      abs(g["laplace"] - g["exact"]), 1e-2)
            c.at_most(f"{m}: |SMC - exact| (2048 particles)",
                      abs(g["smc"] - g["exact"]), 0.5)
            jr = j["per" if m == "linear" else "per#2"]
            c.near(f"{m}: min per-rung accept", g["min_accept"], jr[0], 0.2)
            c.near(f"{m}: min swap rate", g["min_swap"], jr[2], 0.2)
        bf, ex = f["log_bayes_factor"], f["exact_log_bayes_factor"]
        se = math.hypot(f["linear"]["ss_se"], f["quadratic"]["ss_se"])
        c.at_most("|log BF - exact| / combined SE", abs(bf - ex) / se,
                  SIGMAS)
        c.equal("log BF decisive for quadratic (> 4.6), as JAX's",
                bf > 4.6, j["log Bayes factor"][0] > 4.6)
    elif name == "bayesian_workflow":
        c.equal("converged (R-hat 1.01, ESS 400)", f["converged"], True)
        z = max(abs(m - t) / s for m, t, s in
                zip(f["beta_mean"], f["beta_true"], f["beta_sd"]))
        c.at_most("max |beta mean - truth| / posterior sd", z, 4.0)
        c.add("posterior predictive p-value for sd(y)", f["ppp_sd"],
              "in [0.05, 0.95]", 0.05 <= f["ppp_sd"] <= 0.95)
        c.equal("PSIS-LOO ranking", f["loo_ranking"], ["full", "reduced"])
        c.at_least("elpd difference / its standard error",
                   f["elpd_diff"] / f["se_diff"], 4.0)
        c.at_least("SBC: min uniformity p-value over 4 dims",
                   f["sbc_min_p"], 0.001)
    elif name == "checkpointed_run":
        c.equal("draws shape", f["draws_shape"], [2000, 32, 2])
        c.equal("final state == last stored draw",
                f["final_equals_last_draw"], True)
        c.within_mcse("kept mean vs the closed-form posterior mean",
                      f["mean"], f["mcse"], f["exact_mean"])
    elif name == "sgld_logreg":
        c.equal("finite-update rate", f["finite_update_rate"], 1.0)
        # chip_smoke.py's SGLD tolerance against a full-data HMC mean
        # (0.095) is about the posterior's own spread about the truth
        c.at_most("max |posterior mean - truth|",
                  f["max_abs_mean_minus_truth"], 0.1)
        c.at_least("corr(posterior mean, truth)", f["corr_with_truth"],
                   0.99)
    elif name == "elliptical_gp":
        c.equal("accept rate", f["accept_rate"], 1.0)
        c.at_most("latent-field RMSE vs truth (prior sd 1)", f["rmse"], 0.7)
        c.at_least("corr(f_hat, f_true)", f["corr_with_truth"], 0.8)
        c.near("likelihood evaluations per draw",
               f["likelihood_evals_per_draw"],
               j["likelihood evals per draw"][0], 1.5)
    elif name == "gibbs_semi_conjugate":
        c.equal("theta block accept (exact draws)",
                f["block_accept_rate"][0], 1.0)
        c.near("hyper block (HMC) accept", f["block_accept_rate"][1],
               j["block accept rates"][1], 0.1)
        c.at_most("|mu mean - 4| / mu posterior sd (truth 4)",
                  abs(f["mu_mean"] - 4.0) / f["mu_sd"], 3.0)
        c.at_most("hyper max split R-hat", max(f["hyper_split_rhat"]),
                  1.01)
    elif name == "multichip_nuts":
        c.equal("ranks return the same global figures", f["ranks_agree"],
                True)
        # 300 draws of a condition-number-1e3 target (JAX: 1.0083)
        c.at_most("max split R-hat", f["max_split_rhat"], 1.02)
        c.ratio("min ESS per draw", f["min_ess_per_draw"],
                j["min ESS"][0] / (j["mesh"][1] * 300), 2.0)
        c.at_most("max |var / true var - 1|", f["max_rel_var_err"], 0.15)
    elif name == "data_parallel_hmc":
        c.equal("ranks return the same global figures", f["ranks_agree"],
                True)
        c.near("accept rate", f["accept_rate"], j["accept"][0], 0.05)
        c.at_most("max |posterior mean - truth|",
                  f["max_abs_mean_minus_truth"], 0.15)
        c.at_least("corr(posterior mean, truth)", f["corr_with_truth"],
                   0.99)
    elif name == "distributed_hmc":
        c.equal("ranks return the same global figures", f["ranks_agree"],
                True)
        c.near("posterior mean", f["mean"], 2.0, 0.05, what="truth")
        c.near("accept rate", f["accept_rate"], j["process 0"][2], 0.05)
    else:
        raise KeyError(f"no checks for example {name!r}")
    return c.items


def card():
    """``name, power.limit`` of the card from nvidia-smi."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def run_example(name, timeout):
    argv = [sys.executable, str(EXAMPLES / f"{name}.py"), *ARGS.get(name, [])]
    t0 = time.perf_counter()
    try:
        p = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                           timeout=timeout)
        status = "ok" if p.returncode == 0 else f"exit {p.returncode}"
        out, err = p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        status, out, err = "timeout", e.stdout or "", e.stderr or ""
        out = out.decode() if isinstance(out, bytes) else out
        err = err.decode() if isinstance(err, bytes) else err
    seconds = time.perf_counter() - t0
    lines = [ln for ln in out.splitlines() if ln.strip()]
    figures = None
    if status == "ok":
        try:
            figures = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            status = "no figures"
    rec = {"example": name, "status": status, "seconds": round(seconds, 2),
           "argv": [str(Path(argv[1]).relative_to(ROOT)), *argv[2:]],
           "figures": figures,
           "stdout": lines[:-1] if figures is not None else lines[-40:]}
    if status != "ok":
        rec["stderr_tail"] = err.splitlines()[-30:]
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args()
    names = sorted(p.stem for p in EXAMPLES.glob("*.py")
                   if not p.name.startswith("_"))
    if args.only:
        names = [n for n in names if n in args.only]
    jax = json.loads(JAX_FIGURES.read_text())["examples"]
    gpu = card()
    print(gpu, flush=True)
    records, t_all = [], time.perf_counter()
    for name in names:
        rec = run_example(name, args.timeout)
        if rec["status"] == "ok":
            try:
                rec["checks"] = check_example(name, rec["figures"],
                                              jax[name]["figures"])
            except (KeyError, IndexError, TypeError, ZeroDivisionError) as e:
                rec["status"] = f"checks failed to run: {e!r}"
        rec["ok"] = rec["status"] == "ok" and all(
            c["ok"] for c in rec.get("checks", []))
        records.append(rec)
        print(json.dumps({k: rec[k] for k in ("example", "status", "ok",
                                               "seconds", "figures")}
                         | {"checks": rec.get("checks", []),
                            **({"stderr_tail": rec["stderr_tail"]}
                               if "stderr_tail" in rec else {})}),
              flush=True)
    failed = [r["example"] for r in records if not r["ok"]]
    import torch
    summary = {"card": gpu, "python": platform.python_version(),
               "torch": torch.__version__, "cuda": torch.version.cuda,
               "host_cpus": os.cpu_count(), "timeout_s": args.timeout,
               "total_seconds": round(time.perf_counter() - t_all, 2),
               "n_examples": len(records), "failed": failed,
               "examples": records}
    Path(args.out).write_text(json.dumps(summary, indent=1) + "\n")
    print(json.dumps({"card": gpu, "n_examples": len(records),
                      "total_seconds": summary["total_seconds"],
                      "failed": failed}), flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
