#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. device: a CUDA card is required; prints its name and power limit;
2. build: compiles the kernels of ``mcmc_tpu_torch/csrc`` (nvcc, sm_90a,
   one compiler per source, together) and, beside them, the libraries of
   two links traced from torch (``ops/link_codegen.py``: a complementary
   log-log Bernoulli link on the 128, the cluster and the two-pass body,
   the JAX package's logistic hook on the 128 body; ``_cuda.build_link``);
   prints
   the build time, ptxas's registers and spills, and gates on no ``wgmma``
   advisory for a traced link, on no spills in the two-pass body
   (``fused_glm_xwide_body.cuh``: its registers and spills printed for
   each instantiation, the library's and the traced link's) and on no
   ``CALL`` in a traced link's SASS (``cuobjdump -sass``, counted and
   printed); both facts go into the kernels' JSON line;
3. the GLM trajectory kernel against its plain PyTorch version at the
   flagship shapes (16384 chains, 100 dims, 1000 observations, 4 leapfrogs
   at step 0.01) for each built-in link, Student-t included: max errors
   against the stated tolerances, padded columns exactly zero, and the
   median time of each; then the two traced links the same way (cloglog on
   responses drawn from it, the hook on the flagship's), also within
   ``tests/test_torch_kernels_cuda.py``'s ``_close_but_rare`` bounds, two
   launches bit-equal, and the hook within those bounds of the built-in
   logistic (whether bit-equal printed);
4. the fused main path: ``fused_glm_hmc`` at 16384 chains for 600
   transitions, from numpy data with no ``device=`` (so it must put itself
   on the card), with the kernel's launch count, acceptance, leapfrog
   steps/s, max split R-hat and min ESS;
5. the generic ``hmc`` at 1024 chains over the same transitions, whose
   posterior mean must agree with the fused run's within 0.3; its max
   split R-hat is printed (600 transitions of 4 leapfrogs at step 0.01 from
   the 0.05-scale start do not converge); then phases 4-5 again with
   ``fused_glm_hmc(link=cloglog)`` (one K1 launch a transition, acceptance
   in (0.5, 1], the mean within 0.3 of the generic ``hmc``'s on the same
   torch density; ms a transition printed);
6. the run-time-parameter entry of the GLM kernel at the flagship shapes
   (step size as a 0-d tensor on the card, a diagonal inverse mass):
   against its plain version, bit-equal to phase 3's kernel at inverse
   mass 1, and driven through its factory ``make_fused_trajectory_rt``;
   the same on the traced cloglog link;
7. the Gaussian trajectory kernel against its plain version at the suite's
   shapes (2048 chains, 100 dims, 157 leapfrogs at step 0.9, condition
   number 1e4), on the suite's diagonal precision and on a dense one of
   the same spectrum; two launches bit-equal;
8. the Gaussian main path: ``fused_gaussian_hmc`` at 2048 chains, 2400
   transitions of 157 leapfrogs, from a numpy precision with no
   ``device=``: launch count, acceptance, and mean and variance against
   the analytic answer; rank R-hat, min ESS and leapfrog steps/s printed;
   phases 3-8 then run again past 128 padded columns, as a lap of their
   own: K1 logistic at 256, 384, 896, 1152, 2048, 3072 and 8192 padded
   columns (200 x 1000, 300 x 1000, 784 x 2000, 1100 x 1000, 2000 x 1000,
   3072 x 2000 and 8100 x 512) and every link at 384 and 2048, K3 at 384
   and 2048 (bit-equal to K1 at inverse mass 1, and through its factory),
   K2 at 256, 512, 1024, 1152, 2048 and 4096 (250 to 4096 dims, diagonal
   and dense, two launches bit-equal), each against its plain version at
   its phase's tolerances, timed, with its bound and share; K1 on the
   traced cloglog link at 896 (with a 20-transition ``fused_glm_hmc`` path
   there) and 2048, and K3 on it at 384 (bit-equal to K1 at inverse mass
   1, and through its factory), each against its plain version;
   ``fused_glm_hmc`` on the 784 x 2000 and the 3072 x 2000 models at 16384
   chains (one launch a transition, acceptance in (0.5, 1], its mean
   within 0.3 of the generic ``hmc``'s over the same transitions), and
   ``fused_gaussian_hmc`` on the dense rotations of the 250-d and the
   2000-d ill-conditioned Gaussian at phase 8's protocol, gated on each
   eigen-coordinate's mean and variance within 5 Monte-Carlo standard
   errors of the analytic answer;
9. adapted NUTS, the main path's quality line, at 1024 chains on the
   flagship posterior (the protocol of ``bench.py``'s ``nuts`` line:
   ``build_nuts_kernel`` with pooled dual averaging, windowed diagonal mass
   and the learned depth budget over 500 warmup draws from ``0.05 N(0,
   1)``, target accept 0.65, then the sampling kernel rebuilt at the
   learned cap and 500 timed draws through ``run_sampler_loop``, the
   bench's 1000 halved): the
   bench's ``nuts_*`` keys, warmup-inclusive min ESS/s, host
   synchronisations and leaves per draw; gated on max split and rank
   R-hat <= 1.01, finite draws and divergences under 1% of draws. Then a
   reference that shares no tree, U-turn or adaptation code with NUTS: the
   generic ``hmc`` from NUTS's final draws, with NUTS's adapted inverse mass
   as its mass matrix and half its step size, 1100 transitions of 6
   leapfrogs; gated on its max split R-hat <= 1.01 and each dimension's
   NUTS mean within 5 combined MC standard errors of its mean (phase 5's
   unconverged mean is printed beside it, not gated);
10. the same protocol at 4096 chains (``nuts4096_*``) with 500 timed
   draws, kept on the card and ESS (chunked over chains) and split R-hat
   computed there; gated
   on split R-hat and finite draws, and each dimension's posterior mean
   within 5 combined MC standard errors of phase 9's;
11. ChEES-HMC at 1024 chains, the bench's ``chees`` line (``bench.py``'s
   ``measure_chees_quality``): pooled dual averaging, Adam on the shared
   trajectory length and pooled windowed diagonal mass over 500 warmup
   draws from ``0.05 N(0, 1)``, then 500 timed draws (the bench's 1000,
   halved); the bench's
   ``chees_*`` keys with bulk/tail ESS and rank R-hat; gated on finite
   draws, split and rank R-hat <= 1.01, each dimension's mean within 5
   combined MC standard errors of phase 9's ``hmc`` reference, and exactly
   one host synchronisation per draw (counted by the kernel, and seen by
   CUDA's synchronisation debug mode over a few draws);
12. GHMC at 4096 chains, the bench's ``ghmc`` line: step 0.05, persistence
   0.98, 3 leapfrogs, jitter 0.2, per-chain dual averaging to 0.95 over the
   first 1000 transitions, ``thin_step(., 4)``, 250 warmup sweeps and 250
   timed kept draws (the bench's 1000 each, cut to a quarter); ESS, bulk,
   tail and split R-hat on the card (chunks of 256 chains); gated on finite
   draws, split R-hat, the mean against the ``hmc`` reference and no host
   synchronisation;
13. MAMS and MCLMC at 4096 chains, the bench's microcanonical lines:
   diagonal preconditioning, the McLachlan integrator, L0 = sqrt(100) and
   eps0 = 0.1 sqrt(100), MAMS at thin 1 and MCLMC at thin 2, 500 warmup and
   500 timed kept draws (the bench's 1000, halved), diagnostics on the card
   (chunks of 512); gated on
   finite draws and split R-hat for both, MAMS's mean against the ``hmc``
   reference and one host synchronisation per draw, MCLMC's none, and its
   bias audit against MAMS under the bound derived beside ``MC_VAR_BIAS``;
   each of phases 11-13 also prints its draws/s, warmup seconds,
   warmup-inclusive min ESS/s, host synchronisations and leapfrogs per
   kept draw, and its seconds;
14-16 run ``rmhmc_fisher``, ``elliptical_latent_gp_64d``, ``aees_mixture``,
   ``pt_mixture`` and ``gibbs_hierarchical`` (with its NUTS reference) at
   their depths in worker processes of their own (``WORKER_ROWS``,
   spawned at the start of phase 14 and joined at the end of phase 16),
   beside the main process's rows; each such row says that its seconds
   were measured sharing the host and the card;
14. the suite's rows of the reference library's samplers at their full
   settings (``benchmarks/suite.py``), each through its entry point from
   numpy inputs with no ``device=``: ``rwmh_gaussian_2d`` (256 chains,
   2000 + 4000 draws, scale 0.1, the (mu, sigma) likelihood of 1000 points
   2 + 2 N(0, 1)), ``rmhmc_fisher`` (1024 chains, 500 + 4000 draws, its
   burn-in cut from the suite's 1500, step 0.15, 3 leapfrogs of 3
   fixed-point steps, the Fisher metric, the same data), ``mala_logreg_25d`` (256 chains, 1000 + 2000 draws, step 0.05
   with dual averaging, logistic regression on 500 x 25 data) and
   ``de_mixture`` (200 walkers, 1000 + 2000 generations, initial box +-4,
   the two-mode mixture): the suite's row keys (seconds, chain draws/s,
   min, bulk and tail ESS/s, max split and rank R-hat) and host syncs per
   draw (each entry point run whole at two lengths under CUDA's sync debug
   mode); gated on finite draws, max rank R-hat <= 1.01 and no host sync
   per draw, RM-HMC's means within 5 combined MC standard errors of RWMH's
   (one posterior), MALA's of a converged generic ``hmc`` run's on its
   posterior, DE's within 5 MC standard errors of the exact 0. Then RM-HMC
   with the SoftAbs metric on Neal's funnel, briefly: gated on one host
   sync per ``eigh``, that is per metric evaluation;
15. the suite's tempering and ensemble rows at their full settings, each
   through its entry point from numpy inputs with no ``device=``:
   ``aees_mixture`` (32 runs of the ladder 60, 15.3, 3.9, 1 with 500 + 500
   draws a rung and 24,000 kept, 11 rings, jump probability 0.05, proposal
   0.35 I, a 512-entry reservoir, on the two-mode mixture of variance
   0.1), ``pt_mixture`` (256 ladders of 6 temperatures to 60, adapted,
   HMC inner moves at step 0.12 with 5 leapfrogs, 1000 + 3000 draws, the
   same mixture), ``smc_mixture`` (16,384 particles, 5 mutation steps,
   initial scale 4, de_mixture's mixture), ``stretch_correlated`` (256
   walkers, 2000 + 6000 sweeps, rho 0.95) and ``demcz_correlated_10d`` (64
   runs of 6 walkers, 2500 + 4500 generations, rho 0.8 in 10 dims): the
   suite's row keys and host syncs per draw (as in phase 14); gated on
   finite draws, and for the four chain rows on max rank R-hat <= 1.01,
   each mean within 5 MC standard errors of the exact 0 and no host sync
   per draw, PT also on a round-trip rate above 0; SMC on the suite's own
   gates (|log Z| <= 0.05, |mode mass - 0.5| <= 0.05) and on exactly one
   host sync a stage. Then, printed: an AEES draw's time with the full
   history at the row's length;
16. the suite's rows of the remaining chain samplers and two more lines,
   each through its entry point from numpy inputs with no ``device=``:
   ``barker_logreg_25d`` (256 chains, 1000 + 2000 draws, step 0.5, pooled
   step and preconditioner adaptation, on mala_logreg_25d's posterior),
   ``elliptical_latent_gp_64d`` (64 chains, 1500 + 12000 draws, the prior
   ``rbf_kernel(linspace(0, 4, 64), 0.5)``, y = sin(2x), noise variance
   0.25), ``slice_gaussian_2d`` (256 chains from (2, 2), 500 + 1000 draws
   on the (mu, sigma) posterior) and ``gibbs_hierarchical`` (256 chains,
   1000 + 1000 sweeps, J = 16, an exact theta block and an HMC hyperblock
   at step 0.1 with 8 leapfrogs, its data numpy-seeded); the ellipse's,
   slice's and Gibbs's draws cut from the suite's 3000 + 12000, 1000 + 4000
   and 2000 + 4000 to hold the script's time, each printing its cut and its
   margin under the R-hat gate; then the SGLD line
   (``examples/sgld_logreg.py``'s settings: N 65,536, D 16, B 512, step
   2e-5, decay 0.33 / 1000, 32 chains, 2000 + 4000 draws, in shared and
   per-chain minibatch mode, and ``sghmc`` shared with its defaults at B
   512) and the mMALA line (rmhmc_fisher's posterior and
   ``normal_fisher_metric(1000)``, 1024 chains, 500 + 1000 draws, cut from
   1500 + 4000, adapted step): the suite's row keys and host
   syncs per draw (as in phase 14); gated on finite draws, and for the
   chain rows on max rank R-hat <= 1.01, no host sync per draw (but slice
   and ellipse, whose loops test their end once an iteration: printed, and
   over a few draws of the kernel CUDA's sync debug mode must see the
   kernel's own count) and each mean within 5 combined MC standard errors
   of a reference: Barker of phase 14's hmc reference, the ellipse of the
   exact posterior mean, slice and mMALA of the (mu, sigma) posterior's
   closed-form mean (their distance from ``rmhmc_fisher``'s, which is
   biased, printed), Gibbs of a converged ``nuts`` run on its log-kernel
   from its final draws (32 chains, depth cap 4); the SGLD lines on a
   finite-update rate of 1, no host sync per draw and max |mean - a
   full-data ``hmc`` reference's mean| <= ``SGLD_MEAN_TOL``;
17. the one-call workflow on the flagship posterior, from numpy with no
   ``device=``: ``pathfinder`` as ``fit`` calls it (timed on its own: its
   seconds, line-search host syncs and chosen iterates), then ``fit`` with
   NUTS and fit's defaults from a Pathfinder start (1024 chains, 300 + 300
   draws, rank R-hat target 1.01, at most 3 rounds); ``map_laplace`` at its
   defaults (gated on its ``grad_norm`` and max |mode - posterior mean| /
   sd against phase 9's ``hmc`` reference, under bounds from
   ``scripts/jax_workflow_tolerance.py``), then ``fit`` with ChEES from a
   Laplace start (200 + 300 draws); each fit gated on converging, finite
   draws and each mean within 5 combined MC standard errors of the ``hmc``
   reference. Then over the NUTS fit's last 300 draws of its first 64
   chains (19,200 draws x 1,000 outcomes, in chunks): the posterior
   predictive of the Bernoulli outcomes (its mean within 5 binomial
   standard errors of ``generated_quantities``' mean fitted probability;
   the predictive p-value of mean(y) printed), ``psis_loo`` and ``waic``
   (every Pareto k <= 0.7, |elpd_loo - elpd_waic| under its bound, the
   card's ``psis_loo`` equal to the CPU's), and ``compare`` against a
   reduced model (the first 50 columns, a ChEES fit): the full model ranks
   first and its elpd difference agrees with the JAX package's;
18. evidence, approximate inference and durability, each entry point from
   numpy with no ``device=``, each step timed by the port's ``PhaseTimer``:
   ``thermo_evidence`` on the flagship posterior split into its normalised
   N(0, 10^2) prior and Bernoulli likelihood (16 ladders of 24 rungs, 500 +
   500 draws, cut from 1000 + 1000), gated on its stepping-stone log Z
   within 5 combined standard errors of the JAX package's on the same data
   and settings (``scripts/jax_evidence_tolerance.py``), every rung's
   acceptance above 0.2 and every pair's swap rate above 0.02, TI and the
   Laplace evidence printed beside it; ``advi`` (mean-field and full-rank)
   and ``svgd`` (256 particles) at their defaults, each ELBO at most log Z +
   3 standard errors of the difference (SS's and the ELBO's own), each
   mean within the script's bound of phase 9's
   ``hmc`` reference, and no host sync per step (CUDA's sync debug mode at
   two lengths); ``examples/evidence_bayes_factor.py``'s two polynomial
   models, whose log Z is exact, through ``thermo_evidence`` (16 ladders of
   24 rungs, 250 + 250 draws; within 5 standard errors),
   ``nested_sampling`` (512 live points, within 3 error
   bars; its rounds and host syncs a round printed) and ``map_laplace``
   (within 1e-2), the Bayes factor favouring the quadratic model; and
   ``checkpoint_dir=`` on the card: ``hmc`` at 1,024 chains (100 + 500 draws
   of 6 leapfrogs, 204.8 MB of draws, checkpointed every 100 under
   ``chiprun_out/``, removed after) bit-equal to the in-memory run, a
   subprocess killed with SIGKILL after two chunks and resumed here
   bit-equal, the sink native, and the durability tax of
   ``benchmarks/checkpoint_overhead.py`` printed (max(t_compute, bytes /
   pinned D2H bandwidth) / t_checkpointed, the bandwidth measured here);
20. multi-device sampling (``mcmc_tpu_torch.parallel``) on the one card, run
   before the profiles: (a) a world of one under NCCL, whose all-reduce is
   the identity, with NUTS (1,024 chains, 100 + 200 draws) and the flagship
   ``hmc`` (16,384 chains, 50 transitions) bit-equal with and without the
   mesh; (b) two ranks sharing the card over Gloo, started by the phase
   (``chip_smoke.py --mesh-rank FILE``): the flagship through chain-sharded
   ``hmc`` (2 x 8,192 chains) and pooled NUTS (2 x 512), ``de``, ``stretch``
   and ``smc`` population-sharded, two-rung ``pt_sharded`` and
   ``aees_sharded``, ``data_parallel_kernel`` on a (1, 2) grid against the
   unsharded kernel; every line's statistics equal on both ranks and its
   means within 5 combined MC standard errors of its reference (phase 9's
   hmc reference; the exact 0 of phases 14-15's targets), its seconds and
   collectives per draw printed; (c) ``dryrun_multichip(2)``. The cuts that
   pay for it are printed first;
19. printed and not gated: the Gaussian kernel's time at other chain counts,
   and for both fused transitions (``make_fused_hmc_step``,
   ``make_fused_gaussian_hmc_step``), a steady NUTS draw at 1024 chains and
   a steady transition of ChEES (1024 chains), GHMC and MCLMC (4096), MALA
   (256) and RM-HMC (1024) at the suite rows' shapes, a steady draw of AEES
   (32 runs) and PT (256 ladders), and a steady slice sweep (256 chains),
   ellipse draw (64) and Gibbs sweep (256) at theirs, the time per step,
   the card's busy share of it and the device time of each kernel by name,
   under ``torch.profiler``; then one fused GLM step captured by the port's
   ``observability.capture_trace`` as a Chrome trace under ``chiprun_out/``,
   gated on not being empty. It runs last: once the profiler has run in a
   process, launches stay slower.

Before the last two lines it prints each kernel's bound beside its time: for
the GLM kernel, per link, the largest of the tensor operations, the link's
special-function operations and the bytes. The last two lines of output are
the kernels' JSON record and the result line ``{"ok": true, "device":
{...}}``. Imports nothing of JAX. Matmuls run in full FP32 (no TF32)
throughout, NUTS's gradients included.
"""

import dataclasses
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_CHAINS = 16384
DIM = 100
N_DATA = 1000
N_LEAP = 4
STEP_SIZE = 0.01
PRIOR_SCALE = 10.0
LINKS = ("logistic", "poisson", "linear", "probit", "studentt")
STUDENTT_NU = 4.0
# kernel vs plain version: only the summation order differs, but at these
# shapes the two f32 sums round z to different bf16 neighbours at a few of
# the ~8M rounding points, and the chain where that happens then differs by
# one bf16 step of z times the curvature (largest for poisson). Errors are
# taken per chain relative to each output's scale (max|dz| / max(1,
# max|z|), likewise p; |dU| / max|U|): 99% of chains must agree to TOL_BULK
# (a wrong rounding point or a wrong link moves every chain), and every
# chain to TOL_MAX (the bound of those rare bf16 neighbours).
TOL_BULK = 1e-5
TOL_MAX = 1e-2
N_BURNIN, N_KEEP, STEPS_PER_DRAW = 100, 200, 2
HMC_CHAINS = 1024
MEAN_ATOL = 0.3
RT_CALLS = 10
# steady transitions profiled in the last phase (printed, not gated): cut to
# a quarter when the evidence phase joined the script, to hold its time: a
# host that ran phases 14-16 in 700 s took about 1,180 s for the whole
# script, the profiles 135.4 s of it (71.1 s at half the transitions on a
# slower host); their time goes mostly to the profiler's own processing
PROFILE_WARM, PROFILE_STEPS = 25, 25

# the suite's ill-conditioned row (benchmarks/suite.py
# hmc_ill_conditioned_100d_fused): 100-d Gaussian, variances logspace(0, 4)
G_CHAINS, G_DIM, G_COND = 2048, 100, 1e4
G_STEP, G_LEAP, G_JITTER, G_INIT_SCALE = 0.9, 157, 0.3, 1.0
G_BURNIN, G_KEEP, G_STEPS_PER_DRAW = 600, 600, 2
# Gaussian kernel vs plain version: both f32, the same roundings in the
# update; only the summation order of the 158 dependent products (and of
# U's row sum) differs, and that difference grows about linearly over the
# steps. Per chain, relative to each output's scale as above: 99% of chains
# within G_TOL_BULK, every chain within G_TOL_MAX. On the diagonal precision
# every product has one non-zero term, so to 1,024 padded columns z and p
# must be bit-equal. Measured on the dense precision: 1.1e-5 and 2.4e-5.
G_TOL_BULK = 5e-5
G_TOL_MAX = 2e-4
# past 1,024 padded columns K2's products are 3xTF32 on the tensor cores:
# its largest per-chain scaled error against the plain version in float64
# at most this many times the f32 plain version's (phase 7)
G_F64_RATIO = 4.0
# the path against the analytic answer (mean 0, variances logspace(0, 4))
# over 600 x 2048 draws: max |mean| / sd and max |var / variance - 1|
# (measured 0.003 and 0.005 at a min ESS of 4e5; a kernel that integrates
# another precision, or a biased accept test, misses by far more)
G_MEAN_TOL = 0.02
G_VAR_TOL = 0.03
G_SWEEP_CHAINS = (256, 1024, 4096, 16384)

# the widths past 128 padded columns (phases 3-8's additions, one lap): K1
# logistic against its plain version at phase 3's chains, protocol and
# tolerances on make_logistic_regression_data's models of these (columns,
# rows), seeded by their width: 256, 384 and 896 padded columns (784 is an
# MNIST image's pixel count); every link at 384; K3 at 384 (phase 6).
WIDE_GLM = ((200, 1000), (300, 1000), (784, 2000))
WIDE_LINK_DIM = 300
# K2 against its plain version at phase 7's protocol and tolerances on
# ill_conditioned_gaussian(dim, 1e4)'s spectrum, diagonal and densely
# rotated: 256, 512 and 1,024 padded columns
WIDE_GAUSS_DIMS = (250, 500, 1000)
# the wide GLM path (phases 4-5): fused_glm_hmc on the 784 x 2,000 model at
# 16,384 chains, 4 leapfrogs at step WG_STEP (acceptance 0.9986 on 128
# chains of the plain version on the CPU); the posterior is broad (sd 1-3),
# so 600 transitions of 4 x 0.02 do not converge, and the generic hmc at
# 1,024 chains runs the same transitions from the same start distribution
WG_DIM, WG_DATA, WG_STEP = 784, 2000, 0.02
WG_BURNIN, WG_KEEP, WG_STEPS_PER_DRAW = 100, 100, 3
# the wide Gaussian path (phase 8): fused_gaussian_hmc on the dense rotation
# Q of ill_conditioned_gaussian(250, 1e4) at phase 8's protocol (the 250-d
# MVN of the NUTS paper at the suite's condition number). In the eigenbasis
# (draws @ Q) each coordinate k is N(0, variance_k); its mean is held to 0
# within WGA_SIGMAS MC standard errors, sd_k / sqrt(ESS of x_k), and its
# second moment to variance_k within WGA_SIGMAS of sqrt(2 / ESS of
# x_k^2 / variance_k) (a Gaussian's); 500 gates at 5 leave a false alarm
# near 3e-4. Phase 8's absolute figures (G_MEAN_TOL, G_VAR_TOL) printed.
WGA_DIM = 250
WGA_BURNIN, WGA_KEEP = 300, 300
WGA_SIGMAS = 5.0
# past 1,024 padded columns, in the same lap: K1 logistic at 1,152 (1,100
# x 1,000), 2,048 (2,000 x 1,000), 3,072 (the GLM path's model) and 8,192
# (8,100 x 512: 8,000 columns would pad to 8,064) padded columns at phase
# 3's 16,384 chains; every link, the traced cloglog link and K3 at 2,048;
# K2 at 1,152, 2,048 and 4,096, where P (67 MB) no longer fits the 50 MB L2
XWIDE_GLM = ((1100, 1000), (2000, 1000), (3072, 2000), (8100, 512))
XWIDE_LINK_DIM = 2000
XWIDE_GAUSS_DIMS = (1100, 2000, 4096)
# the GLM path past 1,024 (phases 4-5): fused_glm_hmc on a 3,072-feature
# logistic model (a CIFAR-10 image's 32 x 32 x 3 values; 2,000 synthetic
# rows) at 16,384 chains, 4 leapfrogs at WG_STEP (acceptance 0.9996 on 128
# chains of the plain version on the CPU over 20 transitions), against the
# generic hmc at 1,024 chains over the same transitions from the same start
# distribution. A third of the columns (3,072 - 2,000) are the prior's
# alone, where both chains random-walk (0.08 a transition) from 0.05 N(0, 1),
# so the generic hmc's mean carries about 0.08 sqrt(transitions) / 32 of MC
# error a coordinate: 225 transitions keep its largest of 3,072 near half
# of MEAN_ATOL. 25 kept draws of 16,384 x 3,072 are 5 GB on the card.
WG3_DIM, WG3_DATA = 3072, 2000
WG3_BURNIN, WG3_KEEP = 50, 25
# the Gaussian path past 1,024 (phase 8): fused_gaussian_hmc on the dense
# rotation of ill_conditioned_gaussian(2000, 1e4) at phase 8's protocol,
# gated as the 250-d path. At 2,000 dims the step's energy error, summed
# over eight times the narrow directions, leaves about 0.4 of the
# transitions accepted (0.04 over the first 50 from the start), and the
# ensemble's second moments approach their values at a rate of about 1/140
# a transition in every band of the spectrum (3-5% low over transitions
# 401-450 in exact float64 arithmetic: scripts/torch_gaussian_path_burnin.py),
# so 150 + 150 transitions failed the variance gate (11.4 MC standard
# errors) and 500 + 150 passed it (3.3); 600 burn-in transitions halve the
# bias left at 500
WGA2_DIM = 2000
WGA2_BURNIN, WGA2_KEEP = 600, 150
# the paths' acceptance floors: 0.5 at 250 dims (measured 0.77); at 2,000
# dims measured 0.35-0.43 over 300-650 transitions, and a wrong gradient
# accepts next to nothing
WGA_ACCEPT_MIN, WGA2_ACCEPT_MIN = 0.5, 0.3

# adapted NUTS at the bench's protocol (bench.py:45-58, :128-243)
NUTS_CHAINS, NUTS_BIG_CHAINS = 1024, 4096
# kept draws of the NUTS 1024-chain, ChEES, MAMS and MCLMC lines: the
# bench's BENCH_KEEP until the workflow (phase 17) joined the script, halved
# then to hold its run time (their margins under the R-hat gate were 0.0084
# and more: rank R-hat 1.0016, 1.0026, split 0.9997, 0.9994); each line
# prints its cut and its margin
BENCH_KEEP = 1000
NUTS_WARMUP, NUTS_KEEP = 500, 500
# kept draws of the 4096-chain line: 1000 until the suite's rows (phase 14)
# joined the script, halved then to hold its run time
NUTS_BIG_KEEP = 250
NUTS_TARGET_ACCEPT = 0.65
NUTS_INIT_SCALE = 0.05
NUTS_RHAT_MAX = 1.01
NUTS_DIV_MAX = 0.01          # divergences, as a share of kept draws
NUTS_ESS_CHUNK = 512
# two independent converged runs: each dimension's mean difference within
# this many combined MC standard errors (sd / sqrt(ESS)); 100 dims at 5
# sigma leave a false alarm under 1e-4
NUTS_MEAN_SIGMAS = 5.0
# the reference for NUTS's posterior: generic HMC from NUTS's final draws,
# mass matrix 1 / NUTS's adapted inverse mass, this fraction of its step size
# and a fixed path of REF_LEAP steps (about 1.9 in NUTS's metric, short of a
# half period, so no resonance)
REF_STEP_FRACTION, REF_LEAP = 0.5, 6
REF_BURNIN, REF_KEEP = 100, 1000
NUTS_PROFILE_WARM, NUTS_PROFILE_DRAWS = 3, 3

# the bench's other quality lines (bench.py:246-487), at its widths and
# protocols: warmup and kept draws as NUTS's, starts 0.05 N(0, 1)
CHEES_CHAINS = 1024
GHMC_CHAINS, GHMC_STEP, GHMC_ALPHA, GHMC_LEAP = 4096, 0.05, 0.98, 3
GHMC_JITTER, GHMC_TARGET, GHMC_THIN, GHMC_WARM = 0.2, 0.95, 4, 1000
# warmup sweeps and kept draws of the GHMC line (1000 each, the bench's,
# until the suite's rows joined the script, then 500; 250 since the workflow
# (phase 17) joined it, at a margin of 0.0116 under the split R-hat gate);
# dual averaging spans the first GHMC_WARM transitions, all of warmup
GHMC_WARM_SWEEPS, GHMC_KEEP = 250, 250
GHMC_ESS_CHUNK = 256
MC_CHAINS, MC_ESS_CHUNK = 4096, 512
# kept draws of the MAMS and MCLMC lines: NUTS_KEEP until the mesh phase
# (20) joined the script (split R-hat 0.99x at 500, margins above 0.009)
MC_KEEP = 250
MC_THIN = {"mams": 1, "mclmc": 2}
# MCLMC's bias audit against MAMS. tests/test_mclmc.py:66-85 holds the
# unadjusted chain's variance bias under 5% at the default energy target:
# so each dimension's sd ratio within sqrt(1.05) - 1, and, since a mean
# shift d raises the second moment about the exact mean by d^2, each mean
# within sqrt(0.05) sd of MAMS's; each bound plus 5 combined MC standard
# errors of the two lines (of a mean: sd / sqrt(ESS); of an sd ratio:
# sqrt(1 / (2 ESS)) per line, as for a Gaussian)
MC_VAR_BIAS = 0.05
SYNC_PROBE_DRAWS = 3          # draws run under CUDA's sync debug mode
SAMPLER_PROFILE = {"chees": (3, 3), "ghmc": (10, 12), "mclmc": (10, 12),
                   "mala": (10, 12), "rmhmc": (3, 3), "aees": (10, 12),
                   "pt": (5, 6), "slice": (3, 3), "ellipse": (5, 6),
                   "gibbs": (3, 3)}

# the suite's rows of the reference library's samplers at their full (not
# --quick) settings: rwmh_gaussian_2d and mala_logreg_25d
# (benchmarks/suite.py:72-88), de_mixture (:186-196), rmhmc_fisher
# (:317-330); the suite's gate is max rank R-hat <= 1.01 (:380)
SUITE_RHAT_MAX = 1.01
SUITE_N_DATA = 1000           # the (mu, sigma) rows' data, 2 + 2 N(0, 1)
RWMH_ROW = {"chains": 256, "warm": 2000, "keep": 4000, "par_scale": 0.1}
MALA_ROW = {"chains": 256, "warm": 1000, "keep": 2000, "step": 0.05,
            "n_data": 500, "dim": 25}
DE_ROW = {"n_pop": 200, "warm": 1000, "keep": 2000, "box": 4.0}
# rmhmc_fisher's warmup (no adaptation: a burn-in from (2.5, 2.5), about 20
# autocorrelation times at 500) is cut from the suite's 1500 to hold the
# script's time (PR 8, beside phase 16); its 4000 kept draws stay (2000
# read rank R-hat 1.01000 in PR 7). "full" keeps the suite's (warm, keep)
RMHMC_ROW = {"chains": 1024, "warm": 500, "keep": 4000, "full": (1500, 4000),
             "step": 0.15,
             "leap": 3, "fp": 3}
# MALA's reference on the same posterior: generic HMC with dual averaging
# and windowed diagonal mass, started where MALA starts
MALA_REF = {"chains": 256, "warm": 1000, "keep": 500, "leap": 4,
            "step": 0.05}
# each entry point is also run whole at two lengths (n warmup + n kept
# draws) under CUDA's sync debug mode: the difference of the syncs over the
# difference of the draws is its syncs per draw, its set-up's cancelled
SYNC_PROBE_LENGTHS = (2, 6)
# SoftAbs on Neal's funnel, a short run for the sync count: torch's eigh
# reads its info back, EIGH_SYNCS host syncs per metric evaluation, and a
# draw evaluates the metric leap * (fp + dim) times
SOFTABS_ROW = {"chains": 256, "dim": 3, "leap": 2, "fp": 2, "step": 0.5,
               "n": 5}
EIGH_SYNCS = 1

# the suite's tempering and ensemble rows at their full settings
# (benchmarks/suite.py:198-316), seeds the suite's keys: aees_mixture and
# pt_mixture on the hard mixture (modes at +-2, variance 0.1), smc_mixture
# on de_mixture's (variance 0.5), stretch_correlated (rho 0.95, 2 dims),
# demcz_correlated_10d (rho 0.8, 10 dims). The chain rows gate on rank
# R-hat (SUITE_RHAT_MAX) and on each mean within NUTS_MEAN_SIGMAS MC
# standard errors of the exact 0; smc_mixture on the suite's own gates.
AEES_ROW = {"runs": 32, "initial": 500, "burnin": 500, "keep": 24000,
            "rings": 11, "ee_prob": 0.05, "temps": (60.0, 15.3, 3.9),
            "cov": 0.35, "capacity": 512, "key": 8}
PT_ROW = {"chains": 256, "warm": 1000, "keep": 3000, "temps": 6,
          "max_temp": 60.0, "step": 0.12, "leap": 5, "key": 11}
SMC_ROW = {"particles": 16384, "mcmc": 5, "init_scale": 4.0, "key": 12,
           "log_z_gate": 0.05, "mass_gate": 0.05}
STRETCH_ROW = {"walkers": 256, "warm": 2000, "keep": 6000, "rho": 0.95,
               "key": 13}
DEMCZ_ROW = {"n_pop": 6, "runs": 64, "warm": 2500, "keep": 4500, "dim": 10,
             "rho": 0.8, "key": 16}
# AEES with the full history (no reservoir): a few draws timed at the end of
# the aees_mixture row's length, where each rung sorts a window of about
# n_total entries
AEES_FULL_DRAWS = 10

# the suite's rows of the remaining chain samplers at their full settings
# (benchmarks/suite.py), seeds the suite's keys: barker_logreg_25d (:89-94,
# on mala_logreg_25d's posterior), elliptical_latent_gp_64d (:280-292),
# slice_gaussian_2d (:296-300, on the (mu, sigma) posterior) and
# gibbs_hierarchical (:331-362, its data made with numpy here, where the
# suite draws it from a JAX key); then an SGLD line (examples/
# sgld_logreg.py's settings) and an mMALA line (rmhmc_fisher's posterior).
# Slice and mMALA, on rmhmc_fisher's (mu, sigma) posterior, are gated on its
# closed-form mean (``suite_rows``' ``ms_exact``), not on rmhmc_fisher's
# means: on the card that row sits 4.6-6.0 of its own MC standard errors
# from the closed form (sigma about 5e-4 low: its generalized leapfrog's 3
# fixed-point iterations leave it short of reversible), which put mMALA at
# 6.6 combined standard errors from it while 0.7 from the exact mean
BARKER_ROW = {"chains": 256, "warm": 1000, "keep": 2000, "step": 0.5,
              "key": 23}
# Depth cut to hold the script's time (under half of its 1200 s on the
# hosts seen; one host ran the uncut script 2x slower, in 1,389 s): the
# rows with the widest margins at the suite's settings (rank R-hat 1.0002,
# 1.0011 and 1.0004 at 0.96, 0.19 and 0.59 ESS per draw) keep a quarter of
# their draws; the ellipse, at rank R-hat 1.0073 and 0.012 ESS per draw,
# only loses half its burn-in. "full" is the suite's (warm, keep); each row
# prints its cut and its margin under the R-hat gate
ELLIPSE_ROW = {"chains": 64, "warm": 1500, "keep": 12000, "n": 64,
               "full": (3000, 12000),
               "length_scale": 0.5, "noise_var": 0.25, "key": 14}
SLICE_ROW = {"chains": 256, "warm": 250, "keep": 500, "full": (1000, 4000),
             "key": 15}
GIBBS_ROW = {"chains": 256, "warm": 1000, "keep": 1000, "full": (2000, 4000),
             "J": 16,
             "step": 0.1, "leap": 8, "key": 26, "data_seed": 42}
# the gibbs row's reference: adapted NUTS on the same log-kernel, started
# from the row's final draws (as phase 9's hmc reference starts from NUTS's)
# with its own per-chain adaptation, at 32 chains and a depth cap of 4. From
# 0 at 256 chains some chain reached depth 6-7 every draw and the lockstep
# batch paid its tree (318 s for 1,500 draws); pooled adaptation left chains
# stuck in the funnel's neck (split R-hat 4.2); at 64 chains capped at
# depth 5, 1,000 draws took 69 s (rank R-hat 1.0030), at depth 4 800 took
# 49 s (1.0049)
GIBBS_REF = {"chains": 32, "warm": 250, "keep": 400, "depth": 4, "key": 27}
SGLD_ROW = {"n_data": 65536, "dim": 16, "batch": 512, "step": 2e-5,
            "decay_gamma": 0.33, "decay_b": 1000.0, "chains": 32,
            "warm": 1000, "keep": 2000, "seed": 0}
# the SGLD lines' gate, max |mean - the full-data hmc reference's mean|:
# scripts/jax_sgld_tolerance.py's tolerance, three times the largest
# difference of the JAX package's sgld (shared 0.0043, per-chain 0.0016)
# and sghmc (shared 0.0316) from its full-data hmc on the same data, on the
# CPU (the posterior's sd is about 0.009; dropping the N/B scaling would
# pull the means toward 0 by up to |beta| ~ 1)
SGLD_MEAN_TOL = 0.095
# the full-data reference starts at the data's coefficients, and takes 3
# leapfrogs: the posterior is nearly isotropic (X ~ N(0, 1)), so a fixed
# trajectory of 16 adapted steps turns every direction by about the same
# angle, near a multiple of 2 pi, and the chains barely move (rank R-hat
# 1.057 at 256 chains, from 0 1.071); with 3 the CPU's 32 chains read rank
# R-hat 1.0008 and 0.50 ESS per draw
SGLD_REF = {"chains": 256, "warm": 500, "keep": 500, "step": 0.005,
            "leap": 3, "key": 33}
MMALA_ROW = {"chains": 1024, "warm": 250, "keep": 500, "full": (1500, 4000),
             "key": 31}
# kernel-level sync audit of the looping samplers: draws run under CUDA's
# sync debug mode, against the kernel's own count
LOOP_SYNC_DRAWS = 10
# Phases 14-16 held the script past its 1,200 s on slow hosts (774 s of a
# 1,292 s run on an H100 80GB HBM3 at 700 W). No cut of depth pays there: a
# row's max rank R-hat sits near 1 + (tau - 1) / n_keep, tau its integrated
# autocorrelation time, whatever its chain count (more chains and fewer
# draws keep the ESS but raise R-hat), and the long rows are the slow-mixing
# ones: rmhmc_fisher (tau about 18: rank R-hat 1.0046 at 4,000 kept),
# elliptical_latent_gp_64d (about 90: 1.0076 at 12,000), aees_mixture
# (1.0077 at 24,000), pt_mixture (about 16: 1.0052 at 3,000) and
# gibbs_hierarchical with its NUTS reference (about 4 at 1,000 and 3 at 400:
# 1.0040, 1.0074). Each runs at its depth in a worker process of its own
# (spawned, one generator per row), beside the others and the main
# process's rows: each is launch-bound, the card 5-16% busy, one host core.
# Every row of phases 14-16 says so (SHARED_HOST): its seconds and draws/s
# were measured sharing the host and the card.
SHARED_HOST = {"host": "shared: phases 14-16's rows run at once, the main "
                       "process's beside the worker processes'"}
WORKER_TIMEOUT_S = 900.0

# the one-call workflow (phase 17) on the flagship posterior: fit() with a
# Pathfinder start (NUTS, fit's defaults), map_laplace and a Laplace-started
# ChEES fit, the posterior predictive of the Bernoulli outcomes and PSIS-LOO
# / WAIC over the last 300 draws of the first 64 chains (19,200 draws x
# 1,000 observations, in chunks of PP_BATCH draws), and a reduced model
# (the first 50 columns) ranked below the full one by compare()
WF_NUTS = {"chains": 1024, "warm": 300, "keep": 300, "rhat": 1.01,
           "rounds": 3, "key": 170}
WF_CHEES = {"chains": 1024, "warm": 200, "keep": 300, "rhat": 1.01,
            "rounds": 3, "key": 171}
WF_REDUCED = {"cols": 50, "key": 172}
WF_PP = {"chains": 64, "draws": 300, "batch": 4800, "key": 173}
WF_PF_DRAWS = 256             # fit(init="pathfinder")'s pathfinder draws
# bounds fixed before the first chip run from
# scripts/jax_workflow_tolerance.py (the JAX package on the CPU, the same
# numpy data), each three times the JAX package's own number rounded up to
# two digits: map_laplace's grad_norm at its defaults (JAX 0.00476), max
# |mode - posterior mean| / posterior sd against its adapted hmc reference
# (JAX 0.436: the posterior is skewed, its mode is not its mean), |elpd_loo
# - elpd_waic| on 19,200 of the reference's draws (JAX 1.233, elpd_loo
# -685.96, max Pareto k 0.411)
WF_GRAD_NORM_MAX = 0.015
WF_MODE_SD_MAX = 1.4
WF_LOO_WAIC_MAX = 3.7
# the reduced model's elpd_diff behind the full one: the JAX package's
# mean over three reference seeds (17.71, 17.14, 15.75) and three times its
# largest distance from it. Not "elpd_diff > 2 paired standard errors":
# with the weak N(0, 10^2) prior the full model overfits (p_loo about 118),
# so its predictive lead is real but small, 1.1-1.3 of its paired standard
# error (about 14) in the JAX package at every seed
WF_DIFF_JAX, WF_DIFF_TOL = 16.87, 3.4
WF_PARETO_K_MAX = 0.7         # PSIS-LOO's reliability threshold
WF_PP_SIGMAS = 5.0            # binomial standard errors

# evidence, approximate inference and durability (phase 18). (a) The
# flagship posterior split into the normalised N(0, 10^2) prior and the
# Bernoulli likelihood, thermo_evidence with EvidenceSettings' ladder (16
# ladders of 24 rungs, 384 rows) and its burn-in and kept draws cut from
# 1000 + 1000 to 500 + 500 to hold the phase's 90 s (the line prints its
# margins); gated on its stepping-stone log Z within EV_SIGMAS combined
# standard errors of the JAX package's on the same data and settings
# (scripts/jax_evidence_tolerance.py on the CPU: -828.600 +- 0.471, TI
# -827.035 +- 0.351, per-rung accept >= 0.625, swap >= 0.0707), every
# rung's acceptance above EV_ACCEPT_MIN and every pair's swap rate above
# EV_SWAP_MIN (about a third of the JAX package's smallest)
EV_FLAG = {"chains": 16, "n_temps": 24, "burnin": 500, "keep": 500, "key": 7}
EV_SS_JAX, EV_SS_SE_JAX = -828.600, 0.471
EV_SIGMAS, EV_ACCEPT_MIN, EV_SWAP_MIN = 5.0, 0.2, 0.02
# (b) ADVI (mean-field and full-rank) and SVGD (256 particles) at their
# defaults: each ELBO at most log Z (SS) + EV_ELBO_SE standard errors of
# the difference (a lower bound; the ELBO is itself a Monte Carlo estimate,
# the mean of its last n_steps / 20 steps, whose standard error joins SS's:
# with SS's alone the full-rank ELBO reads +3.16 on an H100, 0.43 below
# TI, the SS being biased low at this cut as the JAX
# package's is: its full-rank ELBO sits 1.07 of SS's standard errors above
# its SS), and each max |mean - phase 9's hmc reference mean| / its sd under
# three times the JAX package's own on the same data (same script, against
# its adapted hmc reference), rounded up to two digits
EV_ELBO_SE = 3.0
APPROX_KEYS = {"advi_mean_field": 181, "advi_full_rank": 182, "svgd": 183}
# (JAX 0.0451, 0.0445 and 0.408: SVGD's 256 particles in 100 dims shrink
# the cloud, and its mean moves with it)
APPROX_DEV_MAX = {"advi_mean_field": 0.14, "advi_full_rank": 0.14,
                  "svgd": 1.3}
SVGD_PARTICLES = 256
APPROX_SYNC_STEPS = (20, 40)  # no host sync per step: equal syncs at both
# (c) examples/evidence_bayes_factor.py's two models (n 60, degrees 1 and 2,
# known noise variance 0.25, N(0, 2^2) coefficients; its data drawn with
# numpy here), whose log Z is exact: y ~ N(0, 0.25 I + 4 F F^T).
# thermo_evidence within EV_SIGMAS of its standard error, nested sampling
# within NS_SIGMAS of its error bar, the Laplace evidence within
# LAPLACE_EV_TOL (the posterior is Gaussian)
# (800 + 800 draws cut to 250 + 250 to hold the phase's 90 s: at 400 + 400
# the models took 14.1 and 15.0 s on an H100, 1.23 and 1.75 standard errors
# from the exact log Z, and the phase 83.1 s on a host that ran phases 14-16
# in 430 s; the line prints its margins)
EV_POLY = {"chains": 16, "n_temps": 24, "burnin": 250, "keep": 250, "key": 1}
POLY_N, POLY_SIG2, POLY_PRIOR_VAR = 60, 0.25, 4.0
NS_LIVE, NS_SIGMAS, NS_KEY = 512, 3.0, 4
LAPLACE_EV_TOL = 1e-2
# (d) durability: hmc at 1,024 chains on the flagship posterior, 6
# leapfrogs, 100 + 500 draws (500 x 1024 x 100 float32: 204.8 MB of draws),
# checkpointed every 100 under chiprun_out/ (removed after the phase); a
# subprocess killed with SIGKILL after DUR_KILL_AFTER chunks, resumed here
DUR = {"chains": 1024, "leap": 6, "step": 0.05, "burnin": 100, "keep": 500,
       "every": 100, "key": 190}
DUR_KILL_AFTER = 2
EV_PHASE_BUDGET_S = 90.0

# peaks of one H100 SXM (NVIDIA's data sheet, dense): the bounds below are
# the largest of operations over the peak of their type and bytes over the
# memory rate, each input read once and each output written once
PEAK_BF16, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12
# TF32 on the tensor cores (dense); an f32-accurate product there is three
# TF32 products (3xTF32: each f32 operand split into a TF32 high and low
# part, hi . hi + hi . lo + lo . hi), 165 TFLOP/s of f32 products, the
# least time the card needs for one
PEAK_TF32 = 495e12
# special-function operations (exponential, logarithm, reciprocal): 16 per
# clock and SM (CUDA documentation, arithmetic instruction throughput, compute
# capability 9.0) on 132 SMs at the 1.98 GHz the data sheet's FP32 rate
# implies (67e12 / (132 SMs * 128 lanes * 2))
PEAK_SFU = 16 * 132 * 1.98e9
# the least special-function operations of one link evaluation: for the
# residual (every gradient), and more for the log-likelihood term (the last
# gradient only). logistic: exp, reciprocal; + exp, log. poisson: exp.
# probit: exp (density), exp and reciprocal (the erf polynomial), two
# quotients; + two logs. Student-t: one quotient; + quotient, log.
LINK_SFU = {"logistic": (2, 2), "poisson": (1, 0), "linear": (0, 0),
            "probit": (5, 2), "studentt": (1, 2)}
# links traced from torch into K1 and K3 (ops/link_codegen.py): a
# complementary log-log Bernoulli link on responses drawn from it for the
# flagship's X and beta_true (numpy, seeded by CLOGLOG_SEED plus the
# model's columns), and the JAX package's logistic hook
# (tests/test_fused_logreg.py test_fused_trajectory_custom_link_hook) on
# the flagship's own. Their special-function counts come from the traced
# graph (TracedLink.sfu). Kernel against plain version at phase 3's
# tolerances and tests/test_torch_kernels_cuda.py's _close_but_rare
# bounds; cloglog's fused_glm_hmc at the flagship's chains under phases
# 4-5's protocol; K3 at 128 and 384; K1 at 896 with a short path there
CLOGLOG_SEED = 60
TRACED_WIDE_K1, TRACED_WIDE_K3 = (784, 2000), (300, 1000)
TRACED_XWIDE_K1 = (2000, 1000)   # K1 on the traced link past 1,024
TRACED_WIDE_PATH = 20         # transitions of the short path at 896


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fns, reps=10, calls=10):
    """Median over ``reps`` CUDA-event windows of ``calls`` back-to-back
    calls, per call, for each of ``fns`` after one warm call each; the
    windows run in turns (a, b, b, a, ...) so that drift hits both alike."""
    times = [[] for _ in fns]
    for f in fns:
        f()
    order = list(range(len(fns)))
    for r in range(reps):
        for i in (order if r % 2 == 0 else order[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fns[i]()
            end.record()
            end.synchronize()
            times[i].append(start.elapsed_time(end) / calls)
    return [float(np.median(t)) for t in times]


def bound_ms(flop, peak, n_bytes):
    """``(ms, "operations" or "bytes")``: the least time the card could
    take for ``flop`` operations at ``peak`` and ``n_bytes`` of traffic."""
    ops, mem = 1e3 * flop / peak, 1e3 * n_bytes / PEAK_BYTES
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def glm_bound_ms(n_chains, dim, n_rows, n_leap, rt, link="logistic"):
    """``(ms, "operations" or "bytes", which)`` for the GLM trajectory on
    ``dim`` columns and ``n_rows`` data rows: the largest of the tensor
    operations (n_leap + 1 gradients of two bf16 products each), the link's
    special-function operations (``LINK_SFU``) and the bytes (z, p in, z,
    p, U out, X in bf16, y and mask, and eps, inv_mass for the run-time
    entry); ``which`` names the largest. ``link`` is a built-in link's name
    or a traced link's ``(per gradient, per log-likelihood)``
    special-function counts. With the model's own sizes this is
    the work the function needs; with the padded ones, the work the kernel
    is handed."""
    flop = (n_leap + 1) * 2 * 2 * n_chains * dim * n_rows
    n_bytes = 4 * (4 * n_chains * dim + n_chains) + 2 * n_rows * dim \
        + 4 * 2 * n_rows + (4 * (dim + 1) if rt else 0)
    per_grad, per_ll = LINK_SFU[link] if isinstance(link, str) else link
    sfu = n_chains * n_rows * ((n_leap + 1) * per_grad + per_ll)
    ms, by = bound_ms(flop, PEAK_BF16, n_bytes)
    which = "tensor operations" if by == "operations" else "bytes"
    if 1e3 * sfu / PEAK_SFU > ms:
        ms, by, which = 1e3 * sfu / PEAK_SFU, "operations", \
            "special-function operations"
    return ms, by, which


def gaussian_bound_ms(n_chains, dim, n_leap):
    """The Gaussian trajectory on ``dim`` columns: n_leap + 1 f32 products
    of the chain block with P (the potential reuses the last one), each at
    the tensor cores' f32-accurate rate (three TF32 products over
    PEAK_TF32), at every width; z, p in, z, p, U out, P, mean and eps.
    Model's or padded size, as above."""
    flop = (n_leap + 1) * 2 * n_chains * dim * dim
    n_bytes = 4 * (4 * n_chains * dim + n_chains + dim * dim + dim + 1)
    return bound_ms(3 * flop, PEAK_TF32, n_bytes)


def profile_transitions(paths):
    """Print, for each ``(name, step, gen, state, n_warm, n)`` of ``paths``,
    over ``n`` steady transitions after ``n_warm`` warm ones: the wall time
    of each without and with ``torch.profiler``, the card's busy share, and
    the device time of each kernel by name. Every path is timed before any
    is profiled: once the profiler has run in a process, launches stay
    slower."""
    from torch.profiler import ProfilerActivity, profile

    def run(step, gen, state, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            for _ in range(n):
                state, _info = step(gen, state)
        torch.cuda.synchronize()
        return state, time.perf_counter() - t0

    timed = []
    for name, step, gen, state, n_warm, n in paths:
        state, _ = run(step, gen, state, n_warm)
        timed.append(run(step, gen, state, n))
    for (name, step, gen, _, _, n), (state, plain_s) in zip(paths, timed):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, prof_s = run(step, gen, state, n)
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        device_us = sum(e.self_device_time_total for e in events)
        print(f"{name}: {n} steady transitions, {1e3 * plain_s / n:.4f} ms "
              f"each without the profiler, {1e3 * prof_s / n:.4f} ms with "
              f"it; device time {device_us / n:.1f} us per transition, busy "
              f"{100 * device_us / (1e6 * prof_s):.1f}% of the profiled wall "
              f"time ({100 * device_us / (1e6 * plain_s):.1f}% of the "
              f"unprofiled); {sum(e.count for e in events) / n:.1f} device "
              f"operations per transition")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
            print(f"  {e.self_device_time_total / n:9.2f} us/transition "
                  f"{e.count / n:5.1f} launches  {e.key[:90]}")


def scaled_errors(got, want):
    """Per-chain error of ``(z, p, U)`` relative to each output's scale,
    and the max absolute error of z and p."""
    (zk, pk, uk), (zp, pp, up) = got, want
    per_chain = torch.stack([
        (zk - zp).abs().amax(dim=1) / zp.abs().max().clamp_min(1),
        (pk - pp).abs().amax(dim=1) / pp.abs().max().clamp_min(1),
        (uk - up).abs() / up.abs().max()]).amax(dim=0)
    abs_err = max(float((zk - zp).abs().max()), float((pk - pp).abs().max()))
    return per_chain, abs_err


def link_data(name, X, beta, rng):
    """Responses of each family for the data ``X`` and coefficients
    ``beta`` (logistic uses the data's own)."""
    eta = X.cpu().double() @ beta.cpu().double()
    n = X.shape[0]
    if name == "probit":
        y = rng.uniform(size=n) < torch.special.ndtr(eta).numpy()
    elif name == "poisson":
        y = rng.poisson(np.exp(eta.numpy()))
    elif name == "studentt":
        y = eta.numpy() + 0.5 * rng.standard_t(STUDENTT_NU, size=n)
    else:
        y = eta.numpy() + 0.5 * rng.standard_normal(n)
    return torch.tensor(np.asarray(y, np.float64), dtype=torch.float32,
                        device=X.device)


def cloglog(eta, y):
    """The complementary log-log Bernoulli link, P(y = 1) = 1 - exp(-e^eta),
    as a user writes it in torch: ``(mu_eff, ll_terms)`` with mu_eff = y -
    d ll / d eta."""
    m = torch.exp(eta)
    p = -torch.expm1(-m)
    score = y * m * torch.exp(-m) / p - (1 - y) * m
    return y - score, y * torch.log(p) - (1 - y) * m


def logistic_hook(eta, yv):
    """The JAX package's logistic hook, in torch."""
    return torch.sigmoid(eta), \
        yv * eta - torch.nn.functional.softplus(eta)


TRACED_LINKS = {"cloglog": cloglog, "logistic_hook": logistic_hook}


def cloglog_y(X, beta, seed):
    """Responses y ~ Bernoulli(1 - exp(-exp(X beta))), drawn with numpy."""
    eta = (X.cpu().double() @ beta.cpu().double()).numpy()
    rng = np.random.default_rng(seed)
    y = rng.uniform(size=eta.shape[0]) < -np.expm1(-np.exp(eta))
    return torch.tensor(y.astype(np.float32), device=X.device)


def close_but_rare(what, got, want, chains):
    """tests/test_torch_kernels_cuda.py's ``_close_but_rare`` as gates: z
    and p to atol 1e-4 up to 65 chains, past it all to 1e-3 and all but one
    in 100,000 to 1e-4; U to rtol 1e-4, past 65 chains all to 1e-3 and all
    but one chain in 1,000 to 1e-4. Returns the max |dz|, |dp| and the max
    relative |dU|."""
    (zk, pk, uk), (zp, pp, up) = got, want
    dzp = max(float((zk - zp).abs().max()), float((pk - pp).abs().max()))
    rel = (uk - up).abs() / up.abs()
    for a, b, name in ((zk, zp, "z"), (pk, pp, "p")):
        diff = (a - b).abs()
        if chains <= 65:
            check(float(diff.max()) <= 1e-4, f"{what}: {name} within 1e-4")
        else:
            check(float(diff.max()) <= 1e-3, f"{what}: {name} within 1e-3")
            check(float((diff > 1e-4).float().mean()) <= 1e-5,
                  f"{what}: all but 1e-5 of {name} within 1e-4")
    if chains <= 65:
        check(float(rel.max()) <= 1e-4, f"{what}: U within rtol 1e-4")
    else:
        check(float(rel.max()) <= 1e-3, f"{what}: U within rtol 1e-3")
        check(float((rel > 1e-4).float().mean()) <= 1e-3,
              f"{what}: all but 1e-3 of U within rtol 1e-4")
    return dzp, float(rel.max())


def ptxas_entries(log, kernel):
    """ptxas's report of each instantiation of ``kernel`` (a substring of
    its mangled name) in a build log: ``{"registers", "spill_stores",
    "spill_loads"}`` (bytes) per entry function."""
    out, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = {} if kernel in line else None
            if cur is not None:
                out.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
    return out


def sass_calls(so):
    """The ``CALL`` instructions in a library's SASS (``cuobjdump -sass``):
    a slow path the compiler left out of line. None without cuobjdump."""
    from mcmc_tpu_torch.ops import _cuda

    tool = shutil.which("cuobjdump") or str(
        os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump"))
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, timeout=600).stdout
    return len(re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?CALL\b",
                          sass))


def traced_builds(_cuda):
    """Print each traced link's build (nvcc seconds; ptxas's registers,
    spills and wgmma notes; the CALLs in its SASS) and gate on no wgmma
    advisory (the traced link sits under no branch, so ptxas must pipeline
    its products as it does the built-in links') and on no CALL (every
    quotient is ``div_rn``, which has no slow path). Returns the CALL count
    of each library by name."""
    calls = {}
    for path, (seconds, log) in _cuda.link_builds.items():
        print(f"  traced link {path.name}: nvcc {seconds:.1f} s")
        notes = []
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("    ptxas:", line.strip())
            if "wgmma" in line or "C75" in line:
                notes.append(line.strip())
                print("    ptxas advisory:", line.strip())
        check(not notes, f"ptxas serialises or fences {path.name}'s wgmma")
        calls[path.name] = sass_calls(path)
        print(f"    SASS: {calls[path.name]} CALL instructions "
              "(cuobjdump -sass)")
        check(calls[path.name] in (0, None),
              f"{path.name}'s SASS holds no slow-path CALL")
    return calls


def xwide_build_report(_cuda):
    """ptxas's registers and spills of the two-pass body's instantiations
    (the library's and the traced links'), printed and gated on no spills.
    Returns them by library."""
    logs = {"library": _cuda.build_log}
    logs.update({path.name: log
                 for path, (_s, log) in _cuda.link_builds.items()})
    report = {}
    for name, log in logs.items():
        entries = ptxas_entries(log, "fused_glm_xwide_kernel")
        if not entries:
            continue
        report[name] = entries
        for e in entries:
            print(f"  two-pass body ({name}): {e.get('registers')} "
                  f"registers, {e.get('spill_stores')} bytes spill stores, "
                  f"{e.get('spill_loads')} bytes spill loads")
        check(all(e.get("spill_stores") == 0 and e.get("spill_loads") == 0
                  for e in entries),
              f"the two-pass body ({name}) builds without spills")
    return report


def glm_compare(what, fns, got, want, dim, reps=10, calls=10):
    """Check a GLM kernel's outputs against its plain version's at phase
    3's tolerances, padded columns exactly zero; time ``fns`` (the kernel,
    then the plain version) over ``reps`` windows of ``calls``; print one
    line. Returns ``(ms, plain ms, max abs error, max scaled error)``."""
    check(all(bool(torch.isfinite(t).all()) for t in got),
          f"{what}: kernel output finite")
    per_chain, abs_err = scaled_errors(got, want)
    err_q99 = float(torch.quantile(per_chain, 0.99))
    err_max = float(per_chain.max())
    pad_zero = bool((got[0][:, dim:] == 0).all() and
                    (got[1][:, dim:] == 0).all())
    ms, plain_ms = median_ms(fns, reps, calls)
    print(f"{what}: max abs error of z, p {abs_err:.3e}; per-chain scaled "
          f"error: 99th percentile {err_q99:.3e} (tol {TOL_BULK:g}), max "
          f"{err_max:.3e} (tol {TOL_MAX:g}); padded columns zero: "
          f"{pad_zero}; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms per "
          f"trajectory (median of {reps} windows of {calls} calls)")
    check(err_q99 <= TOL_BULK, f"{what}: 99% of chains within {TOL_BULK}")
    check(err_max <= TOL_MAX, f"{what}: every chain within {TOL_MAX}")
    check(pad_zero, f"{what}: padded columns exactly zero")
    return ms, plain_ms, abs_err, err_max


def wgmma_advisories(_cuda):
    """Every line of ptxas's output that mentions ``wgmma`` (its notes
    C7510-C7520: a serialised or fenced ``wgmma`` pipeline). The build's own
    log when this process built the library; otherwise the wide GLM source
    is compiled once more, alone, to read its notes."""
    log = _cuda.build_log
    if not log:
        src = _cuda.CSRC / "fused_glm_trajectory_wide.cu"
        with tempfile.TemporaryDirectory() as tmp:
            out = subprocess.run(
                [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-c", "-o",
                 os.path.join(tmp, "wide.o"), str(src)],
                capture_output=True, text=True, timeout=600)
        log = out.stdout + out.stderr
    return [line.strip() for line in log.splitlines() if "wgmma" in line]


def wide_widths(dev, fl, lc, wgmma_notes):
    """Phases 3-8's additions at the widths past 128 padded columns (one
    lap): the kernels against their plain versions and timed at each width,
    then the wide GLM and Gaussian paths, to 1,024 padded columns and past
    it. ``wgmma_notes`` are ptxas's ``wgmma`` advisories from the build:
    none may name the wide GLM kernel, whose time rests on its products'
    pipeline (the two-pass body's are printed). Returns each kernel's
    per-width records for the kernels' JSON line."""
    check(not any("fused_glm_wide_kernel" in line for line in wgmma_notes),
          "ptxas serialises or fences the wide GLM kernel's wgmma: "
          + "; ".join(wgmma_notes))
    from mcmc_tpu_torch import fused_glm_hmc
    from mcmc_tpu_torch.models import make_logistic_regression_data

    rec = {k: {"ms": {}, "plain_ms": {}, "bound_ms": {}, "launches": {},
               "max_abs_err": 0.0, "max_scaled_err": 0.0}
           for k in ("K1", "K3", "K2")}
    rec["K1"]["ms_by_link"], rec["K1"]["plain_ms_by_link"] = {}, {}
    rec["K1"]["traced"], rec["K3"]["traced"] = {}, {}
    rec["K2"]["dense_ms"] = {}
    rec["K2"]["float64_ratio"] = {}
    rec["K2"]["grid"] = {}

    def note(k, dp, ms, plain_ms, bound, abs_err, scaled_err):
        r = rec[k]
        r["ms"][str(dp)], r["plain_ms"][str(dp)] = ms, plain_ms
        r["bound_ms"][str(dp)] = bound
        r["max_abs_err"] = max(r["max_abs_err"], abs_err)
        r["max_scaled_err"] = max(r["max_scaled_err"], scaled_err)

    def windows(dp):
        """median_ms's windows at a width: fewer past 1,024 columns, where a
        plain version takes 10-50 ms."""
        return (6, 5) if dp > 1024 else (10, 10)

    # phase 3: K1 at 256, 384, 896, 1,152, 2,048, 3,072 and 8,192 padded
    # columns, every link at 384 and 2,048
    gen = torch.Generator(device=dev).manual_seed(50)
    data = {}
    k3_in = {}
    for dim, n in WIDE_GLM + XWIDE_GLM:
        X, y, beta = make_logistic_regression_data(dim, n, dim)
        data[dim] = (X, y, beta)
        rng = np.random.default_rng(dim)
        by_link = dim in (WIDE_LINK_DIM, XWIDE_LINK_DIM)
        for name in LINKS if by_link else ("logistic",):
            yl = y if name == "logistic" else link_data(name, X, beta, rng)
            link = fl.studentt_link(STUDENTT_NU) if name == "studentt" \
                else name
            traj = fl.make_fused_trajectory(X, yl, PRIOR_SCALE, STEP_SIZE,
                                            N_LEAP, link=link)
            dp = traj.dim_padded
            z = torch.zeros((N_CHAINS, dp), device=dev)
            p = torch.zeros((N_CHAINS, dp), device=dev)
            z[:, :dim] = beta + 0.3 * torch.randn((N_CHAINS, dim),
                                                  generator=gen, device=dev)
            p[:, :dim] = torch.randn((N_CHAINS, dim), generator=gen,
                                     device=dev)
            args = (traj.Xb, traj.y, traj.mask, traj.inv_pv, STEP_SIZE,
                    N_LEAP, link)
            got = fl.fused_trajectory_cuda(z, p, *args)
            want = fl._fused_trajectory_plain(z, p, *args)
            fns = [lambda: fl.fused_trajectory_cuda(z, p, *args),
                   lambda: fl._fused_trajectory_plain(z, p, *args)]
            torch.cuda.synchronize()
            ms, plain_ms, abs_err, err = glm_compare(
                f"K1 {name} at {dp} ({dim} x {n})", fns, got, want, dim,
                *windows(dp))
            bound = glm_bound_ms(N_CHAINS, dim, n, N_LEAP, False, name)
            print(f"  bound {bound[0]:.4f} ms ({bound[2]}), "
                  f"{100 * bound[0] / ms:.1f}% of it")
            if name == "logistic":
                note("K1", dp, ms, plain_ms, bound[0], abs_err, err)
            else:
                rec["K1"]["max_abs_err"] = max(rec["K1"]["max_abs_err"],
                                               abs_err)
                rec["K1"]["max_scaled_err"] = max(
                    rec["K1"]["max_scaled_err"], err)
            if by_link:
                rec["K1"]["ms_by_link"].setdefault(str(dp), {})[name] = ms
                rec["K1"]["plain_ms_by_link"].setdefault(
                    str(dp), {})[name] = plain_ms
            if by_link and name == "logistic":
                k3_in[dim] = (z, p, args, got)
            del z, p, got, want, fns

    # phase 6: K3 at 384 and 2,048, against its plain version and at
    # inverse mass 1 bit-equal to K1, then through its factory
    for dim in (WIDE_LINK_DIM, XWIDE_LINK_DIM):
        z, p, args, k1_out = k3_in.pop(dim)
        Xb, yr, mask, inv_pv = args[:4]
        dp = z.shape[1]
        eps_t = torch.tensor(STEP_SIZE, dtype=torch.float32, device=dev)
        im = torch.ones((dp,), device=dev)
        im[:dim] = torch.linspace(0.5, 2.0, dim, device=dev)
        rt_args = (Xb, yr, mask, inv_pv, eps_t, N_LEAP, "logistic", im)
        got = fl.fused_trajectory_rt_cuda(z, p, *rt_args)
        want = fl._fused_trajectory_plain(z, p, *rt_args)
        one = fl.fused_trajectory_rt_cuda(z, p, *rt_args[:-1],
                                          torch.ones_like(im))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(one, k1_out))
        ms, plain_ms, abs_err, err = glm_compare(
            f"K3 logistic at {dp}, inverse mass 0.5..2",
            [lambda: fl.fused_trajectory_rt_cuda(z, p, *rt_args),
             lambda: fl._fused_trajectory_plain(z, p, *rt_args)], got, want,
            dim, *windows(dp))
        bound = glm_bound_ms(N_CHAINS, dim, 1000, N_LEAP, True)
        print(f"  at inverse mass 1 bit-equal to K1: {same}; bound "
              f"{bound[0]:.4f} ms, {100 * bound[0] / ms:.1f}% of it")
        check(same, f"K3 at {dp}, inverse mass 1 and K1's step: K1's bits")
        note("K3", dp, ms, plain_ms, bound[0], abs_err, err)
        X, y = data[dim][:2]
        traj_rt = fl.make_fused_trajectory_rt(X.cpu().numpy(),
                                              y.cpu().numpy(), PRIOR_SCALE,
                                              N_LEAP)
        fl.fused_trajectory_rt_cuda.launches = 0
        zc, pc = z, p
        for _ in range(RT_CALLS):
            zc, pc, uc = traj_rt(zc, pc, eps_t, im)
            eps_t = eps_t * 1.01
        torch.cuda.synchronize()
        launches = fl.fused_trajectory_rt_cuda.launches
        check(launches == RT_CALLS, f"{launches} launches of K3 at {dp} for "
              f"{RT_CALLS} calls of its factory's trajectory")
        check(bool(torch.isfinite(zc).all() and torch.isfinite(uc).all()),
              f"K3 path at {dp}: output finite")
        rec["K3"]["launches"][str(dp)] = launches
        del z, p, got, want, one, k1_out, zc, pc

    # phases 3 and 6 on the traced cloglog link: K1 at 896 with a short
    # fused_glm_hmc path there, and at 2,048; K3 at 384, at inverse mass 1
    # bit-equal to K1, and through its factory
    sfu = lc.trace_link(cloglog).sfu
    for k, (dim, n), path in (("K1", TRACED_WIDE_K1, True),
                              ("K1", TRACED_XWIDE_K1, False),
                              ("K3", TRACED_WIDE_K3, False)):
        X, _y, beta = data[dim]
        ycl = cloglog_y(X, beta, CLOGLOG_SEED + dim)
        traj = fl.make_fused_trajectory(X, ycl, PRIOR_SCALE, STEP_SIZE,
                                        N_LEAP, link=cloglog)
        dp = traj.dim_padded
        z = torch.zeros((N_CHAINS, dp), device=dev)
        p = torch.zeros((N_CHAINS, dp), device=dev)
        z[:, :dim] = beta + 0.3 * torch.randn((N_CHAINS, dim), generator=gen,
                                              device=dev)
        p[:, :dim] = torch.randn((N_CHAINS, dim), generator=gen, device=dev)
        args = (traj.Xb, traj.y, traj.mask, traj.inv_pv, STEP_SIZE, N_LEAP,
                cloglog)
        what = f"{k} cloglog (traced) at {dp} ({dim} x {n})"
        if k == "K1":
            launch = lambda: fl.fused_trajectory_cuda(z, p, *args)
            plain = lambda: fl._fused_trajectory_plain(z, p, *args)
        else:
            eps_t = torch.tensor(STEP_SIZE, dtype=torch.float32, device=dev)
            im = torch.ones((dp,), device=dev)
            im[:dim] = torch.linspace(0.5, 2.0, dim, device=dev)
            rt_args = (*args[:4], eps_t, N_LEAP, cloglog, im)
            launch = lambda: fl.fused_trajectory_rt_cuda(z, p, *rt_args)
            plain = lambda: fl._fused_trajectory_plain(z, p, *rt_args)
        got, want = launch(), plain()
        torch.cuda.synchronize()
        dzp, du = close_but_rare(what, got, want, N_CHAINS)
        ms, plain_ms, abs_err, err = glm_compare(what, [launch, plain], got,
                                                 want, dim, *windows(dp))
        bound = glm_bound_ms(N_CHAINS, dim, n, N_LEAP, k == "K3", sfu)
        print(f"  max |dz|, |dp| {dzp:.3e}, max relative |dU| {du:.3e} "
              f"(_close_but_rare's bounds); bound {bound[0]:.4f} ms "
              f"({bound[2]}), {100 * bound[0] / ms:.1f}% of it")
        launches = None   # read only where a path ran, never from a compare
        if path:
            # a short path at 896: one launch a transition
            fl.fused_trajectory_cuda.launches = 0
            out = fused_glm_hmc(X.cpu().numpy(), ycl.cpu().numpy(),
                                link=cloglog, prior_scale=PRIOR_SCALE,
                                step_size=WG_STEP, n_leap=N_LEAP,
                                n_chains=N_CHAINS, n_burnin_draws=0,
                                n_keep_draws=TRACED_WIDE_PATH, key=58)
            torch.cuda.synchronize()
            launches = fl.fused_trajectory_cuda.launches
            check(launches == TRACED_WIDE_PATH, f"{launches} launches of K1 "
                  f"on the traced link at {dp} for {TRACED_WIDE_PATH} "
                  "transitions")
            check(bool(torch.isfinite(out.draws).all()),
                  f"traced cloglog path at {dp}: draws finite")
            accept = float(out.diagnostics["accept_rate_per_chain"].mean())
            print(f"  fused_glm_hmc(link=cloglog) at {dp}: "
                  f"{TRACED_WIDE_PATH} transitions, {launches} launches, "
                  f"accept {accept:.4f}")
            del out
        elif k == "K3":
            one = fl.fused_trajectory_rt_cuda(z, p, *rt_args[:-1],
                                              torch.ones_like(im))
            k1 = fl.fused_trajectory_cuda(z, p, *args)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(one, k1))
            check(same, f"{what}: at inverse mass 1 K1's bits")
            traj_rt = fl.make_fused_trajectory_rt(
                X.cpu().numpy(), ycl.cpu().numpy(), PRIOR_SCALE, N_LEAP,
                link=cloglog)
            fl.fused_trajectory_rt_cuda.launches = 0
            zc, pc = z, p
            for _ in range(RT_CALLS):
                zc, pc, uc = traj_rt(zc, pc, eps_t, im)
                eps_t = eps_t * 1.01
            torch.cuda.synchronize()
            launches = fl.fused_trajectory_rt_cuda.launches
            check(launches == RT_CALLS, f"{launches} launches of K3 on the "
                  f"traced link at {dp} for {RT_CALLS} factory calls")
            check(bool(torch.isfinite(uc).all()), f"{what}: path finite")
            print(f"  at inverse mass 1 bit-equal to K1: {same}; {RT_CALLS} "
                  f"chained trajectories through its factory, {launches} "
                  "launches")
            del one, k1, zc, pc
        rec[k]["traced"][str(dp)] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "max_abs_err": abs_err,
            "max_scaled_err": err,
            **({} if launches is None else {"launches": launches})}
        del z, p, got, want

    # phase 7: K2 at 256, 512, 1,024, 1,152, 2,048 and 4,096 padded columns
    gen = torch.Generator(device=dev).manual_seed(53)
    g_eps = torch.tensor(G_STEP, dtype=torch.float32, device=dev)
    rotations = {}
    for dim in WIDE_GAUSS_DIMS + XWIDE_GAUSS_DIMS:
        Q, dense_np, variances, m_np = dense_rotation(dim)
        rotations[dim] = (Q, dense_np, variances)
        prec_np = (1.0 / variances).cpu().numpy().astype(np.float64)
        for name, P_np, m_np in (("diagonal", prec_np, None),
                                 ("dense", dense_np, m_np)):
            traj = fl.make_fused_gaussian_trajectory(P_np, m_np, G_STEP,
                                                     G_LEAP)
            dp = traj.dim_padded
            z = torch.zeros((G_CHAINS, dp), device=dev)
            p = torch.zeros((G_CHAINS, dp), device=dev)
            z[:, :dim] = G_INIT_SCALE * torch.randn((G_CHAINS, dim),
                                                    generator=gen, device=dev)
            p[:, :dim] = torch.randn((G_CHAINS, dim), generator=gen,
                                     device=dev)
            gargs = (z, p, traj.P, traj.mean, g_eps, G_LEAP, dim)
            got = fl.fused_gaussian_trajectory_cuda(*gargs)
            again = fl.fused_gaussian_trajectory_cuda(*gargs)
            want = fl._fused_gaussian_trajectory_plain(*gargs)
            torch.cuda.synchronize()
            check(all(bool(torch.isfinite(t).all()) for t in got),
                  f"K2 {name} at {dp}: kernel output finite")
            per_chain, abs_err = scaled_errors(got, want)
            err_q99 = float(torch.quantile(per_chain, 0.99))
            err_max = float(per_chain.max())
            pad_zero = bool((got[0][:, dim:] == 0).all() and
                            (got[1][:, dim:] == 0).all())
            repeat = all(torch.equal(a, b) for a, b in zip(got, again))
            zp_equal = torch.equal(got[0], want[0]) and \
                torch.equal(got[1], want[1])
            if dp > 1024:
                # past 1,024 the products are 3xTF32 on the tensor cores
                # (the TPU kernel's own f32 product is a 3-pass bf16
                # decomposition, mcmc_tpu/ops/fused_logreg.py:344-350): no
                # bits to equal; both against the plain version in float64
                z64, p64, P64, m64 = (t.double() for t in gargs[:4])
                exact = fl._fused_gaussian_trajectory_plain(
                    z64, p64, P64, m64, G_STEP, G_LEAP, dim)
                f64_kernel = float(scaled_errors(
                    [t.double() for t in got], exact)[0].max())
                f64_plain = float(scaled_errors(
                    [t.double() for t in want], exact)[0].max())
                del z64, p64, P64, m64, exact
                grid = fl.gaussian_xwide_grid(G_CHAINS, dim)
                exact_note = (
                    f"against float64: kernel {f64_kernel:.3e}, f32 plain "
                    f"{f64_plain:.3e} ({f64_kernel / f64_plain:.2f}x, tol "
                    f"{G_F64_RATIO:g}x); grid {grid['blocks']} blocks "
                    f"({grid['tiles']} chain tiles x {grid['per_tile']}), "
                    f"{grid['waves']} wave(s) of at most {grid['capacity']}")
                rec["K2"]["float64_ratio"][f"{dp} {name}"] = \
                    f64_kernel / f64_plain
                rec["K2"]["grid"][str(dp)] = grid
            else:
                exact_note = f"z, p bit-equal to plain: {zp_equal}"
            reps, calls = (3, 1) if dp > 1024 else \
                (6, 5) if dp > 512 else (10, 10)
            ms, plain_ms = median_ms([
                lambda: fl.fused_gaussian_trajectory_cuda(*gargs),
                lambda: fl._fused_gaussian_trajectory_plain(*gargs)],
                reps=reps, calls=calls)
            bound = gaussian_bound_ms(G_CHAINS, dim, G_LEAP)
            print(f"K2 {name} precision at {dp} ({dim} dims): max abs error "
                  f"of z, p {abs_err:.3e}; per-chain scaled error: 99th "
                  f"percentile {err_q99:.3e} (tol {G_TOL_BULK:g}), max "
                  f"{err_max:.3e} (tol {G_TOL_MAX:g}); {exact_note}; "
                  f"padded columns zero: {pad_zero}; two "
                  f"launches bit-equal: {repeat}; kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms per trajectory (median of {reps} "
                  f"windows of {calls}); bound {bound[0]:.4f} ms, "
                  f"{100 * bound[0] / ms:.1f}% of it")
            check(err_q99 <= G_TOL_BULK,
                  f"K2 {name} at {dp}: 99% within {G_TOL_BULK}")
            check(err_max <= G_TOL_MAX,
                  f"K2 {name} at {dp}: every chain within {G_TOL_MAX}")
            check(pad_zero, f"K2 {name} at {dp}: padded columns exactly zero")
            check(repeat, f"K2 {name} at {dp}: two launches bit-equal")
            if dp > 1024:
                check(f64_kernel <= G_F64_RATIO * f64_plain,
                      f"K2 {name} at {dp}: against float64 within "
                      f"{G_F64_RATIO:g}x the f32 plain version's error")
            elif name == "diagonal":
                check(zp_equal, f"K2 diagonal at {dp}: z, p bit-equal to the "
                      "plain version")
            if name == "diagonal":
                note("K2", dp, ms, plain_ms, bound[0], abs_err, err_max)
            else:
                rec["K2"]["max_abs_err"] = max(rec["K2"]["max_abs_err"],
                                               abs_err)
                rec["K2"]["max_scaled_err"] = max(rec["K2"]["max_scaled_err"],
                                                  err_max)
                rec["K2"]["dense_ms"][str(dp)] = ms
            del z, p, got, again, want

    # phases 4-5 and 8: the GLM paths at 896 and 3,072 padded columns, the
    # Gaussian paths at 256 and 2,048
    for dim, n, burnin, keep, key in (
            (WG_DIM, WG_DATA, WG_BURNIN, WG_KEEP, 54),
            (WG3_DIM, WG3_DATA, WG3_BURNIN, WG3_KEEP, 59)):
        dp, launches = wide_glm_path(dev, fl, data[dim][:2], dim, n, burnin,
                                     keep, key)
        rec["K1"]["launches"][str(dp)] = launches
    for dim, burnin, keep, spd, floor, key in (
            (WGA_DIM, WGA_BURNIN, WGA_KEEP, G_STEPS_PER_DRAW, WGA_ACCEPT_MIN,
             57),
            (WGA2_DIM, WGA2_BURNIN, WGA2_KEEP, 1, WGA2_ACCEPT_MIN, 61)):
        dp, launches = wide_gaussian_path(dev, fl, rotations[dim], dim,
                                          burnin, keep, spd, floor, key)
        rec["K2"]["launches"][str(dp)] = launches
    return rec


def dense_rotation(dim):
    """``(Q, P, variances, mean)``: ill_conditioned_gaussian(dim, G_COND)'s
    spectrum densely rotated by the orthogonal Q of a QR of numpy normals
    seeded by ``dim`` (the QR and the product in float64 on the card: at
    4,096 dimensions the host's LAPACK takes seconds), P = Q diag(1 /
    variances) Q^T made symmetric, as numpy arrays; and a mean of numpy
    normals drawn after them."""
    from mcmc_tpu_torch.models import ill_conditioned_gaussian

    variances = ill_conditioned_gaussian(dim, G_COND).variances
    rng = np.random.default_rng(dim)
    A = torch.tensor(rng.standard_normal((dim, dim)), dtype=torch.float64,
                     device=variances.device)
    Q, _ = torch.linalg.qr(A)
    dense = (Q / variances.double()) @ Q.T
    dense = 0.5 * (dense + dense.T)
    return (Q.cpu().numpy(), dense.cpu().numpy(), variances,
            rng.standard_normal(dim))


def wide_glm_path(dev, fl, Xy, dim, n, burnin, keep, key):
    """Phases 4-5 on a wide model: fused_glm_hmc at N_CHAINS chains, 4
    leapfrogs at WG_STEP, ``burnin`` burn-in and ``keep`` kept draws of
    WG_STEPS_PER_DRAW transitions, then the generic hmc at HMC_CHAINS chains
    over the same transitions from the same start distribution, their means
    within MEAN_ATOL. Returns ``(dim_padded, launches)``."""
    from mcmc_tpu_torch import HMCSettings, fused_glm_hmc, hmc
    from mcmc_tpu_torch.models import logistic_regression_model

    X, y = Xy
    X_np, y_np = X.cpu().numpy(), y.cpu().numpy()
    n_trans = (burnin + keep) * WG_STEPS_PER_DRAW
    fl.fused_trajectory_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fused_glm_hmc(X_np, y_np, prior_scale=PRIOR_SCALE,
                        step_size=WG_STEP, n_leap=N_LEAP, n_chains=N_CHAINS,
                        n_burnin_draws=burnin, n_keep_draws=keep,
                        steps_per_draw=WG_STEPS_PER_DRAW, key=key)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fl.fused_trajectory_cuda.launches
    dp = fl._round_up(dim, 128)
    check(launches == n_trans, f"{launches} kernel launches at {dp} for "
          f"{n_trans} transitions")
    check(out.draws.is_cuda and tuple(out.draws.shape) ==
          (keep, N_CHAINS, dim), f"wide GLM draws at {dp} on the card, shape")
    check(bool(torch.isfinite(out.draws).all()),
          f"wide GLM draws at {dp} finite")
    accept = float(out.diagnostics["accept_rate_per_chain"].mean())
    check(0.5 < accept <= 1.0,
          f"wide GLM accept rate at {dp} {accept} in (0.5, 1]")
    fused_mean = out.draws.mean(dim=(0, 1))
    del out
    gen = torch.Generator(device=dev).manual_seed(key + 1)
    init = 0.05 * torch.randn((HMC_CHAINS, dim), generator=gen, device=dev)
    settings = HMCSettings(n_burnin_draws=burnin * WG_STEPS_PER_DRAW,
                           n_keep_draws=keep * WG_STEPS_PER_DRAW,
                           step_size=WG_STEP, n_leap_steps=N_LEAP)
    t1 = time.perf_counter()
    ref = hmc(init, logistic_regression_model(X, y, PRIOR_SCALE), settings,
              key=key + 2)
    torch.cuda.synchronize()
    diff = float((ref.draws.mean(dim=(0, 1)) - fused_mean).abs().max())
    print(f"fused_glm_hmc at {dp} ({dim} x {n}): {N_CHAINS} chains, "
          f"{n_trans} transitions in {seconds:.3f} s "
          f"({1e3 * seconds / n_trans:.3f} ms each), {launches} kernel "
          f"launches; step {WG_STEP}, accept {accept:.4f}; "
          f"{n_trans * N_LEAP * N_CHAINS / seconds:.4e} leapfrog steps/s; "
          f"hmc at {HMC_CHAINS} chains over the same transitions "
          f"{time.perf_counter() - t1:.3f} s, accept "
          f"{float(ref.accept_rate.mean()):.4f}, max |mean - fused mean| "
          f"{diff:.4f} (tol {MEAN_ATOL})")
    check(diff <= MEAN_ATOL, f"wide hmc mean at {dp} within {MEAN_ATOL} of "
          "the fused mean")
    return dp, launches


def wide_gaussian_path(dev, fl, rotation, dim, burnin, keep, spd, floor,
                       key):
    """Phase 8 on a wide model: fused_gaussian_hmc on the dense rotation of
    ill_conditioned_gaussian(dim, 1e4) at G_CHAINS chains, G_LEAP jittered
    leapfrogs of G_STEP, ``burnin`` and ``keep`` draws of ``spd``
    transitions, its acceptance above ``floor`` and its eigenbasis moments
    gated at WGA_SIGMAS MC standard errors. Returns ``(dim_padded,
    launches)``."""
    from mcmc_tpu_torch import diagnostics, fused_gaussian_hmc

    Q, dense_np, variances = rotation
    g_trans = (burnin + keep) * spd
    fl.fused_gaussian_trajectory_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fused_gaussian_hmc(dense_np, step_size=G_STEP, n_leap=G_LEAP,
                             n_chains=G_CHAINS, n_burnin_draws=burnin,
                             n_keep_draws=keep, init_scale=G_INIT_SCALE,
                             step_jitter=G_JITTER, steps_per_draw=spd,
                             key=key)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fl.fused_gaussian_trajectory_cuda.launches
    dp = fl._round_up(dim, 128)
    check(launches == g_trans, f"{launches} launches of K2 at {dp} for "
          f"{g_trans} transitions")
    check(out.draws.is_cuda and tuple(out.draws.shape) ==
          (keep, G_CHAINS, dim), f"wide Gaussian draws at {dp} on the card")
    check(bool(torch.isfinite(out.draws).all()),
          f"wide Gaussian draws at {dp} finite")
    accept = float(out.diagnostics["accept_rate_per_chain"].mean())
    check(floor < accept <= 1.0,
          f"wide Gaussian accept rate at {dp} {accept} in ({floor}, 1]")
    var = variances.double()
    eig = out.draws @ torch.tensor(Q, dtype=torch.float32, device=dev)
    del out
    ess_x = diagnostics.ess(eig, chain_chunk=256).double()
    ess_sq = diagnostics.ess(eig * eig / variances, chain_chunk=256).double()
    flat = eig.reshape(-1, dim).double()
    mean_z = float((flat.mean(dim=0).abs() / (var.sqrt() / ess_x.sqrt()))
                   .max())
    var_z = float(((flat.square().mean(dim=0) / var - 1.0).abs()
                   / (2.0 / ess_sq).sqrt()).max())
    mean_err = float((flat.mean(dim=0).abs() / var.sqrt()).max())
    var_err = float((flat.var(dim=0) / var - 1.0).abs().max())
    del eig, flat
    print(f"fused_gaussian_hmc at {dp} ({dim} dims, dense): {G_CHAINS} "
          f"chains, {g_trans} transitions of {G_LEAP} leapfrogs in "
          f"{seconds:.3f} s ({1e3 * seconds / g_trans:.3f} ms each), "
          f"{launches} launches of K2; accept {accept:.4f}; in the "
          f"eigenbasis max |mean| / MC standard error {mean_z:.3f}, max "
          f"|E x^2 / variance - 1| / MC standard error {var_z:.3f} (tol "
          f"{WGA_SIGMAS:g}); min ESS of x {float(ess_x.min()):.1f}, of x^2 "
          f"{float(ess_sq.min()):.1f}; phase 8's figures: max |mean|/sd "
          f"{mean_err:.4f} (its tol {G_MEAN_TOL}), max |var/variance - 1| "
          f"{var_err:.4f} (its tol {G_VAR_TOL})")
    check(mean_z <= WGA_SIGMAS, f"wide Gaussian means at {dp} within "
          f"{WGA_SIGMAS:g} MC standard errors of 0")
    check(var_z <= WGA_SIGMAS, f"wide Gaussian variances at {dp} within "
          f"{WGA_SIGMAS:g} MC standard errors")
    return dp, launches


def nuts_line(X, y, n_chains, prefix, seed, full_diag, n_keep=NUTS_KEEP):
    """One NUTS quality line at the bench's protocol: warmup (pooled dual
    averaging, windowed diagonal mass, learned depth budget), the sampling
    kernel rebuilt at the learned cap, ``n_keep`` timed draws kept on the
    card. Prints the bench's ``{prefix}_*`` keys and gates on convergence.
    ``full_diag`` adds bulk/tail ESS and rank R-hat (the 1024-chain line);
    otherwise only ESS (chunked over chains) and split R-hat are computed,
    on the card. Returns the summary, the sampling kernel, its generator
    and its last state."""
    import dataclasses
    from mcmc_tpu_torch import NUTSSettings, diagnostics, integrators
    from mcmc_tpu_torch.models import logistic_regression_model
    from mcmc_tpu_torch.samplers import common
    from mcmc_tpu_torch.samplers.nuts import build_nuts_kernel

    dev = X.device
    lk = logistic_regression_model(X, y, PRIOR_SCALE)
    s = NUTSSettings(n_burnin_draws=NUTS_WARMUP, n_keep_draws=n_keep,
                     n_adapt_draws=NUTS_WARMUP,
                     target_accept_rate=NUTS_TARGET_ACCEPT)
    args = (lk, integrators.grad_of(lk),
            common.make_spd(None, DIM, torch.float32, dev))
    init, step = build_nuts_kernel(*args, s, NUTS_WARMUP,
                                   pooled_adaptation=True,
                                   adapt_mass_matrix=True, adapt_depth=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pos0 = NUTS_INIT_SCALE * torch.randn((n_chains, DIM), generator=gen,
                                         device=dev)
    collect = lambda st: st.position

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = init(gen, pos0)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, _, _ = common.run_sampler_loop(gen, state, step, NUTS_WARMUP, 0,
                                          collect)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    warm_counts = dict(step.counts)

    # the sampling kernel, rebuilt at the learned budget (one host sync)
    cap = int(state.depth_cap.max())
    _init, step2 = build_nuts_kernel(
        *args, dataclasses.replace(s, max_tree_depth=cap), NUTS_WARMUP,
        pooled_adaptation=True, adapt_mass_matrix=True)
    state = state._replace(
        depth_hist=state.depth_hist.new_zeros((n_chains, cap + 1)),
        depth_cap=torch.clamp_max(state.depth_cap, cap))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, draws, infos = common.run_sampler_loop(gen, state, step2, 0,
                                                  n_keep, collect)
    torch.cuda.synchronize()
    t_samp = time.perf_counter() - t0
    samp_counts = dict(step2.counts)

    check(draws.is_cuda and tuple(draws.shape) == (n_keep, n_chains, DIM),
          f"{prefix}: draws on the card, shape (keep, chains, dim)")
    finite = bool(torch.isfinite(draws).all())
    t0 = time.perf_counter()
    ess = diagnostics.ess(draws, chain_chunk=NUTS_ESS_CHUNK)
    ess_min = float(ess.min())
    rhat = float(diagnostics.split_rhat(draws).max())
    p = prefix
    n_div = int(infos["diverged"].sum())
    res = {
        f"{p}_min_ess_per_sec": ess_min / t_samp,
        f"{p}_draws_per_sec": n_keep * n_chains / t_samp,
        f"{p}_max_split_rhat": rhat,
        f"{p}_converged": rhat <= NUTS_RHAT_MAX,
        f"{p}_mean_tree_depth": float(infos["tree_depth"].float().mean()),
        f"{p}_n_divergent": n_div,
        f"{p}_warmup_seconds": t_warm,
        f"{p}_sample_seconds": t_samp,
        f"{p}_chains": n_chains,
        f"{p}_adapted_step_size": float(state.epsilon_bar[0]),
        f"{p}_target_accept": NUTS_TARGET_ACCEPT,
        f"{p}_static_depth_cap": cap,
    }
    if full_diag:
        rank_rhat = float(diagnostics.rank_normalized_rhat(draws).max())
        res.update({
            f"{p}_bulk_ess_per_sec":
                float(diagnostics.bulk_ess(draws).min()) / t_samp,
            f"{p}_tail_ess_per_sec":
                float(diagnostics.tail_ess(draws).min()) / t_samp,
            f"{p}_max_rank_rhat": rank_rhat,
        })
        res[f"{p}_converged"] = res[f"{p}_converged"] and \
            rank_rhat <= NUTS_RHAT_MAX
    torch.cuda.synchronize()
    t_diag = time.perf_counter() - t0
    res.update({
        f"{p}_init_seconds": t_init,
        f"{p}_min_ess_per_sec_with_warmup": ess_min / (t_init + t_warm
                                                       + t_samp),
        f"{p}_warmup_leaves_per_draw": warm_counts["leaves"] / NUTS_WARMUP,
        f"{p}_warmup_syncs_per_draw": warm_counts["syncs"] / NUTS_WARMUP,
        f"{p}_sample_leaves_per_draw": samp_counts["leaves"] / n_keep,
        f"{p}_sample_syncs_per_draw": samp_counts["syncs"] / n_keep,
        f"{p}_ms_per_leaf_warmup": 1e3 * t_warm / warm_counts["leaves"],
        f"{p}_ms_per_leaf_sample": 1e3 * t_samp / samp_counts["leaves"],
        f"{p}_diagnostics_seconds": t_diag,
        f"{p}_draws_cut_from": BENCH_KEEP,
        f"{p}_rhat_margin": NUTS_RHAT_MAX - max(
            rhat, res.get(f"{p}_max_rank_rhat", rhat)),
    })
    print(f"{prefix}: {n_chains} chains, {NUTS_WARMUP} warmup draws in "
          f"{t_warm:.3f} s, {n_keep} draws in {t_samp:.3f} s at cap {cap} "
          f"(FP32 matmuls, no TF32); {json.dumps(res)}")
    check(finite, f"{prefix}: every draw finite")
    check(rhat <= NUTS_RHAT_MAX, f"{prefix}: max split R-hat {rhat:.4f} <= "
          f"{NUTS_RHAT_MAX}")
    if full_diag:
        check(rank_rhat <= NUTS_RHAT_MAX, f"{prefix}: max rank R-hat "
              f"{rank_rhat:.4f} <= {NUTS_RHAT_MAX}")
        check(n_div < NUTS_DIV_MAX * n_keep * n_chains,
              f"{prefix}: {n_div} divergences, under {NUTS_DIV_MAX:.0%} of "
              "draws")
    summary = {"mean": draws.mean(dim=(0, 1)),
               "mcse": draws.std(dim=(0, 1)) / torch.sqrt(ess)}
    del draws, infos
    return summary, step2, gen, state


def nuts_reference(X, y, nuts_state):
    """The generic ``hmc`` from NUTS's final draws (one per chain) with NUTS's
    adapted inverse mass: ``REF_BURNIN + REF_KEEP`` transitions of
    ``REF_LEAP`` leapfrogs. Gated on max split R-hat <= 1.01; returns each
    dimension's mean and MC standard error."""
    from mcmc_tpu_torch import HMCSettings, diagnostics, hmc
    from mcmc_tpu_torch.models import logistic_regression_model

    inv_mass = nuts_state.inv_mass[0]            # pooled: one for all chains
    step = REF_STEP_FRACTION * float(nuts_state.epsilon_bar[0])
    settings = HMCSettings(n_burnin_draws=REF_BURNIN, n_keep_draws=REF_KEEP,
                           step_size=step, n_leap_steps=REF_LEAP,
                           precond_mat=1.0 / inv_mass)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = hmc(nuts_state.position, logistic_regression_model(X, y, PRIOR_SCALE),
              settings, key=42)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    draws = ref.draws
    rhat = float(diagnostics.split_rhat(draws).max())
    ess = diagnostics.ess(draws, chain_chunk=NUTS_ESS_CHUNK)
    print(f"hmc reference: {draws.shape[1]} chains from NUTS's final draws, "
          f"{REF_BURNIN} + {REF_KEEP} transitions of {REF_LEAP} leapfrogs at "
          f"step {step:.4f} in {seconds:.3f} s; accept "
          f"{float(ref.accept_rate.mean()):.4f}; max split R-hat {rhat:.4f}; "
          f"min ESS {float(ess.min()):.1f}")
    check(bool(torch.isfinite(draws).all()), "hmc reference: draws finite")
    check(rhat <= NUTS_RHAT_MAX, f"hmc reference: max split R-hat {rhat:.4f} "
          f"<= {NUTS_RHAT_MAX}")
    sd = draws.std(dim=(0, 1))
    return {"mean": draws.mean(dim=(0, 1)), "sd": sd,
            "mcse": sd / torch.sqrt(ess)}


def sync_warnings(fn):
    """``(syncs, fn())``: the host synchronisations CUDA's sync debug mode
    reports while ``fn`` runs (each blocking copy or wait is one warning;
    the mode's own notice that it is a prototype is not one)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with torch.no_grad():
                out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum(str(w.message).startswith("called a synchronizing CUDA")
               for w in caught), out


def count_syncs(step, gen, state, n):
    """Host synchronisations that CUDA's sync debug mode reports over ``n``
    transitions of ``step``. Returns the count and the state after them."""
    def run(state):
        for _ in range(n):
            state, _info = step(gen, state)
        return state
    return sync_warnings(lambda: run(state))


def entry_syncs_per_draw(run, draws_of=lambda n: 2 * n):
    """``(syncs per draw, syncs of the shorter call)`` of an entry point:
    ``run(n)`` calls it with ``n`` warmup and ``n`` kept draws (or, with
    ``draws_of``, ``draws_of(n)`` draws in all); it is run at both
    ``SYNC_PROBE_LENGTHS`` under CUDA's sync debug mode, and the difference
    of the syncs over the difference of the draws is counted per draw, the
    set-up's syncs cancelled."""
    a, b = SYNC_PROBE_LENGTHS
    sa, _ = sync_warnings(lambda: run(a))
    sb, _ = sync_warnings(lambda: run(b))
    return (sb - sa) / (draws_of(b) - draws_of(a)), sa


def sampler_line(prefix, step, gen, init, n_warm, n_keep, thin=1):
    """``init()``, warmup (``n_warm`` kept-draw steps, nothing collected),
    then the one timed sampling call of ``n_keep`` draws kept on the card,
    each timed with CUDA synchronised before the clock starts and before it
    stops. ``step`` is the unthinned kernel, whose ``counts`` are read
    around the sampling call. Returns the state, draws, infos, init, warmup
    and sampling seconds and the sampling call's counts per kept draw."""
    from mcmc_tpu_torch.samplers import common
    stepk = common.thin_step(step, thin)
    collect = lambda st: st.position
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = init()
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, _, _ = common.run_sampler_loop(gen, state, stepk, n_warm, 0,
                                          collect)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    before = dict(step.counts)
    t0 = time.perf_counter()
    state, draws, infos = common.run_sampler_loop(gen, state, stepk, 0,
                                                  n_keep, collect)
    torch.cuda.synchronize()
    t_samp = time.perf_counter() - t0
    per_draw = {k: (step.counts[k] - before[k]) / n_keep for k in before}
    check(draws.is_cuda and tuple(draws.shape) == (n_keep,) +
          tuple(state.position.shape), f"{prefix}: draws on the card, shape "
          "(keep, chains, dim)")
    return state, draws, infos, (t_init, t_warm, t_samp), per_draw


def line_stats(prefix, draws, seconds, per_draw, chunk, rank=False):
    """The keys every quality line prints: min, bulk and tail ESS/s (ESS
    chunked over ``chunk`` chains, on the card), max split R-hat (and rank
    R-hat with ``rank``), draws/s, warmup-inclusive min ESS/s, host syncs
    and leapfrogs per kept draw. Returns them and the draws' summary: each
    dimension's mean, sd, ESS and MC standard error."""
    from mcmc_tpu_torch import diagnostics
    p = prefix
    t_init, t_warm, t_samp = seconds
    n_keep, n_chains = draws.shape[:2]
    t0 = time.perf_counter()
    ess = diagnostics.ess(draws, chain_chunk=chunk)
    ess_min = float(ess.min())
    rhat = float(diagnostics.split_rhat(draws).max())
    res = {
        f"{p}_min_ess_per_sec": ess_min / t_samp,
        f"{p}_bulk_ess_per_sec":
            float(diagnostics.bulk_ess(draws, chain_chunk=chunk).min())
            / t_samp,
        f"{p}_tail_ess_per_sec":
            float(diagnostics.tail_ess(draws, chain_chunk=chunk).min())
            / t_samp,
        f"{p}_max_split_rhat": rhat,
        f"{p}_converged": rhat <= NUTS_RHAT_MAX,
        f"{p}_chains": n_chains,
        f"{p}_init_seconds": t_init,
        f"{p}_warmup_seconds": t_warm,
        f"{p}_sample_seconds": t_samp,
        f"{p}_draws_per_sec": n_keep * n_chains / t_samp,
        f"{p}_min_ess_per_sec_with_warmup": ess_min / (t_init + t_warm
                                                       + t_samp),
        f"{p}_syncs_per_draw": per_draw["syncs"],
        f"{p}_leapfrogs_per_draw": per_draw["leapfrogs"],
    }
    if rank:
        rank_rhat = float(diagnostics.rank_normalized_rhat(draws).max())
        res[f"{p}_max_rank_rhat"] = rank_rhat
        res[f"{p}_converged"] = res[f"{p}_converged"] and \
            rank_rhat <= NUTS_RHAT_MAX
    torch.cuda.synchronize()
    res[f"{p}_diagnostics_seconds"] = time.perf_counter() - t0
    if n_keep < BENCH_KEEP:
        res[f"{p}_draws_cut_from"] = BENCH_KEEP
    res[f"{p}_rhat_margin"] = NUTS_RHAT_MAX - max(
        rhat, res.get(f"{p}_max_rank_rhat", rhat))
    sd = draws.std(dim=(0, 1))
    summary = {"mean": draws.mean(dim=(0, 1)), "sd": sd, "ess": ess,
               "mcse": sd / torch.sqrt(ess)}
    return res, summary


def gate_line(prefix, res, draws, summary, ref, syncs, probe, rank=False):
    """The gates each of phases 11-13 shares: finite draws, split (and
    rank) R-hat, the host syncs per draw as counted and as CUDA's debug
    mode saw them over ``SYNC_PROBE_DRAWS`` draws, and, given ``ref``, each
    dimension's mean within ``NUTS_MEAN_SIGMAS`` combined MC standard errors
    of the reference's."""
    p = prefix
    check(bool(torch.isfinite(draws).all()), f"{p}: every draw finite")
    rhat = res[f"{p}_max_split_rhat"]
    check(rhat <= NUTS_RHAT_MAX, f"{p}: max split R-hat {rhat:.4f} <= "
          f"{NUTS_RHAT_MAX}")
    if rank:
        rr = res[f"{p}_max_rank_rhat"]
        check(rr <= NUTS_RHAT_MAX, f"{p}: max rank R-hat {rr:.4f} <= "
              f"{NUTS_RHAT_MAX}")
    check(res[f"{p}_syncs_per_draw"] == syncs, f"{p}: "
          f"{res[f'{p}_syncs_per_draw']} host syncs per draw counted, "
          f"{syncs} expected")
    check(probe == syncs * SYNC_PROBE_DRAWS, f"{p}: CUDA's sync debug mode "
          f"saw {probe} syncs in {SYNC_PROBE_DRAWS} draws, "
          f"{syncs * SYNC_PROBE_DRAWS} expected")
    if ref is not None:
        z = float(((summary["mean"] - ref["mean"]).abs()
                   / torch.hypot(summary["mcse"], ref["mcse"])).max())
        print(f"{p} vs hmc reference: max |mean difference| / combined MC "
              f"standard error {z:.3f} over {DIM} dims (tol "
              f"{NUTS_MEAN_SIGMAS:g})")
        check(z <= NUTS_MEAN_SIGMAS, f"{p}'s posterior means agree with the "
              f"hmc reference's within {NUTS_MEAN_SIGMAS:g} MC standard "
              "errors")


def chees_line(X, y, ref):
    """Phase 11: the bench's ``chees`` line (module docstring). Returns the
    kernel, its generator and last state, for the profile."""
    from mcmc_tpu_torch import ChEESSettings, adaptation, integrators
    from mcmc_tpu_torch.models import logistic_regression_model
    from mcmc_tpu_torch.samplers.chees import build_chees_kernel

    t_phase = time.perf_counter()
    dev = X.device
    lk = logistic_regression_model(X, y, PRIOR_SCALE)
    s = ChEESSettings(n_burnin_draws=NUTS_WARMUP, n_keep_draws=NUTS_KEEP)
    init, step = build_chees_kernel(
        lk, integrators.grad_of(lk), s, NUTS_WARMUP, adapt_mass=True,
        mass_cfg=adaptation.make_precond_cfg(NUTS_WARMUP, pooled=True,
                                             device=dev))
    gen = torch.Generator(device=dev).manual_seed(50)
    pos0 = NUTS_INIT_SCALE * torch.randn((CHEES_CHAINS, DIM), generator=gen,
                                         device=dev)
    state, draws, infos, seconds, per_draw = sampler_line(
        "chees", step, gen, lambda: init(pos0), NUTS_WARMUP, NUTS_KEEP)
    res, summ = line_stats("chees", draws, seconds, per_draw, None, rank=True)
    res.update({
        "chees_mean_n_leap": float(infos["n_leap"].float().mean()),
        "chees_trajectory_length": float(torch.exp(state.log_T[0])),
        "chees_adapted_step_size": float(torch.exp(state.da.log_eps_bar[0])),
        "chees_accept_rate": float(infos["accepted"].float().mean()),
    })
    probe, state = count_syncs(step, gen, state, SYNC_PROBE_DRAWS)
    print(f"chees: {CHEES_CHAINS} chains, {NUTS_WARMUP} warmup draws in "
          f"{seconds[1]:.3f} s, {NUTS_KEEP} draws in {seconds[2]:.3f} s; "
          f"CUDA's sync "
          f"debug mode saw {probe} syncs in {SYNC_PROBE_DRAWS} draws; "
          f"{json.dumps(res)}")
    gate_line("chees", res, draws, summ, ref, 1, probe, rank=True)
    print(f"chees: phase seconds {time.perf_counter() - t_phase:.1f}")
    return step, gen, state


def ghmc_line(X, y, ref):
    """Phase 12: the bench's ``ghmc`` line (module docstring)."""
    from mcmc_tpu_torch import integrators
    from mcmc_tpu_torch.models import logistic_regression_model
    from mcmc_tpu_torch.samplers import common
    from mcmc_tpu_torch.samplers.ghmc import build_ghmc_kernel

    t_phase = time.perf_counter()
    dev = X.device
    lk = logistic_regression_model(X, y, PRIOR_SCALE)
    init, step = build_ghmc_kernel(
        lk, integrators.grad_of(lk),
        common.make_spd(None, DIM, torch.float32, dev), GHMC_STEP,
        GHMC_ALPHA, GHMC_LEAP, GHMC_JITTER,
        {"n_burnin": GHMC_WARM, "target": GHMC_TARGET})
    gen = torch.Generator(device=dev).manual_seed(51)
    pos0 = NUTS_INIT_SCALE * torch.randn((GHMC_CHAINS, DIM), generator=gen,
                                         device=dev)
    state, draws, infos, seconds, per_draw = sampler_line(
        "ghmc", step, gen, lambda: init(pos0), GHMC_WARM_SWEEPS, GHMC_KEEP,
        GHMC_THIN)
    res, summ = line_stats("ghmc", draws, seconds, per_draw, GHMC_ESS_CHUNK)
    res.update({
        "ghmc_alpha": GHMC_ALPHA, "ghmc_thin": GHMC_THIN,
        "ghmc_n_leap": GHMC_LEAP,
        "ghmc_adapted_step_size": float(torch.exp(state.da.log_eps_bar[0])),
        "ghmc_mean_adapted_step_size":
            float(torch.exp(state.da.log_eps_bar).mean()),
        "ghmc_accept_rate":
            float(infos["accepted"].float().mean()) / GHMC_THIN,
    })
    probe, state = count_syncs(step, gen, state, SYNC_PROBE_DRAWS)
    print(f"ghmc: {GHMC_CHAINS} chains, {GHMC_WARM_SWEEPS} warmup sweeps of "
          f"{GHMC_THIN} transitions in {seconds[1]:.3f} s, {GHMC_KEEP} draws "
          f"in {seconds[2]:.3f} s; CUDA's sync debug mode saw {probe} syncs in "
          f"{SYNC_PROBE_DRAWS} transitions; {json.dumps(res)}")
    gate_line("ghmc", res, draws, summ, ref, 0, probe)
    print(f"ghmc: phase seconds {time.perf_counter() - t_phase:.1f}")
    return step, gen, state


def microcanonical_lines(X, y, ref):
    """Phase 13: the bench's ``mams`` and ``mclmc`` lines and MCLMC's bias
    audit (module docstring). Returns MCLMC's kernel, generator and last
    state, for the profile."""
    from mcmc_tpu_torch import MAMSSettings, MCLMCSettings
    from mcmc_tpu_torch.models import logistic_regression_model
    from mcmc_tpu_torch.samplers.mclmc import (build_mams_kernel,
                                               build_mclmc_kernel)

    dev = X.device
    lk = logistic_regression_model(X, y, PRIOR_SCALE)
    summ, out = {}, {}
    for kind, seed in (("mams", 52), ("mclmc", 53)):
        t_phase = time.perf_counter()
        if kind == "mams":
            init, step = build_mams_kernel(
                lk, MAMSSettings(n_burnin_draws=NUTS_WARMUP,
                                 n_keep_draws=MC_KEEP), NUTS_WARMUP,
                adapt_mass=True)
        else:
            init, step = build_mclmc_kernel(
                lk, MCLMCSettings(n_burnin_draws=NUTS_WARMUP,
                                  n_keep_draws=MC_KEEP), NUTS_WARMUP,
                adapt_mass=True)
        gen = torch.Generator(device=dev).manual_seed(seed)
        pos0 = NUTS_INIT_SCALE * torch.randn((MC_CHAINS, DIM), generator=gen,
                                             device=dev)
        state, draws, infos, seconds, per_draw = sampler_line(
            kind, step, gen, lambda: init(gen, pos0, DIM ** 0.5,
                                          0.1 * DIM ** 0.5),
            NUTS_WARMUP, MC_KEEP, MC_THIN[kind])
        res, summ[kind] = line_stats(kind, draws, seconds, per_draw,
                                     MC_ESS_CHUNK)
        res.update({
            f"{kind}_adapted_step_size":
                float(torch.exp(state.da.log_eps_bar[0])),
            f"{kind}_adapted_L": float(torch.exp(state.log_L[0])),
            f"{kind}_gradients_per_draw": per_draw["gradients"],
        })
        if kind == "mams":
            res["mams_accept_rate"] = float(infos["accepted"].float().mean())
            res["mams_mean_n_leap"] = float(infos["n_leap"].float().mean())
        else:
            res["mclmc_thin"] = MC_THIN[kind]
        probe, state = count_syncs(step, gen, state, SYNC_PROBE_DRAWS)
        print(f"{kind}: {MC_CHAINS} chains, {NUTS_WARMUP} warmup draws in "
              f"{seconds[1]:.3f} s, {MC_KEEP} draws of {MC_THIN[kind]} "
              f"transitions in {seconds[2]:.3f} s; CUDA's sync debug mode saw "
              f"{probe} syncs in {SYNC_PROBE_DRAWS} transitions; "
              f"{json.dumps(res)}")
        gate_line(kind, res, draws, summ[kind], ref if kind == "mams" else
                  None, 1 if kind == "mams" else 0, probe)
        out[kind] = (step, gen, state)
        del draws, infos
        print(f"{kind}: phase seconds {time.perf_counter() - t_phase:.1f}")

    # the bias audit: the unadjusted chain's moments against the exact one's
    mc, ma = summ["mclmc"], summ["mams"]
    dmean = (mc["mean"] - ma["mean"]).abs()
    ratio = mc["sd"] / ma["sd"]
    mean_tol = MC_VAR_BIAS ** 0.5 * ma["sd"] \
        + NUTS_MEAN_SIGMAS * torch.hypot(mc["mcse"], ma["mcse"])
    ratio_tol = (1.0 + MC_VAR_BIAS) ** 0.5 - 1.0 + NUTS_MEAN_SIGMAS \
        * torch.sqrt(0.5 / mc["ess"] + 0.5 / ma["ess"])
    audit = {"mclmc_bias_max_abs_mean_diff": float(dmean.max()),
             "mclmc_bias_max_rel_std_diff": float((ratio - 1.0).abs().max()),
             "mclmc_bias_max_mean_diff_over_sd":
                 float((dmean / ma["sd"]).max()),
             "mclmc_bias_max_mean_diff_over_bound":
                 float((dmean / mean_tol).max()),
             "mclmc_bias_max_std_diff_over_bound":
                 float(((ratio - 1.0).abs() / ratio_tol).max())}
    print(f"mclmc bias audit against mams (bounds per dimension: |mean "
          f"difference| <= sqrt({MC_VAR_BIAS}) sd + {NUTS_MEAN_SIGMAS:g} "
          f"combined MC standard errors, |sd ratio - 1| <= sqrt(1 + "
          f"{MC_VAR_BIAS}) - 1 + {NUTS_MEAN_SIGMAS:g} of its MC standard "
          f"error): {json.dumps(audit)}")
    check(audit["mclmc_bias_max_mean_diff_over_bound"] <= 1.0,
          "mclmc: every mean within its bias bound of mams's")
    check(audit["mclmc_bias_max_std_diff_over_bound"] <= 1.0,
          "mclmc: every sd within its bias bound of mams's")
    return out["mclmc"]


def suite_record(config, call):
    """The suite's row keys (``benchmarks/suite.py``'s ``record``) for one
    timed ``call()`` of an entry point, CUDA synchronised before the clock
    starts and stops: seconds, chain draws/s, min ESS/s, max split and rank
    R-hat, min bulk and tail ESS/s (ESS chunked over 256 chains where the
    suite chunks it). Returns the result, the row and each dimension's mean
    and MC standard error."""
    from mcmc_tpu_torch import diagnostics
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    el = time.perf_counter() - t0
    d = out.draws
    check(d.is_cuda and d.ndim == 3, f"{config}: draws on the card, (keep, "
          "chains, dim)")
    cc = 256 if d.shape[1] > 256 and d.shape[1] % 256 == 0 else None
    ess = diagnostics.ess(d, chain_chunk=cc)
    row = {
        "config": config,
        "seconds": el,
        "chain_draws_per_sec": d.shape[0] * d.shape[1] / el,
        "min_ess_per_sec": float(ess.min()) / el,
        "max_split_rhat": float(diagnostics.split_rhat(d).max()),
        "max_rank_rhat": float(diagnostics.rank_normalized_rhat(d).max()),
        "min_bulk_ess_per_sec":
            float(diagnostics.bulk_ess(d, chain_chunk=cc).min()) / el,
        "min_tail_ess_per_sec":
            float(diagnostics.tail_ess(d, chain_chunk=cc).min()) / el,
    }
    summ = {"mean": d.mean(dim=(0, 1)),
            "mcse": d.std(dim=(0, 1)) / torch.sqrt(ess)}
    return out, row, summ


def gate_row(row, out, syncs, setup_syncs, zero_syncs=True, cut=None,
             **extra):
    """Print a suite row with its host syncs per draw and ``extra``, and
    gate it on finite draws, max rank R-hat <= ``SUITE_RHAT_MAX`` (the
    suite's ``all_converged``) and, with ``zero_syncs``, no host sync per
    draw. ``cut``, a row's settings whose draws were cut from the suite's
    ``full`` (warm, keep), adds the cut. Every row carries its margin under
    the R-hat gate and ``SHARED_HOST``: its seconds were measured while the
    other rows of phases 14-16 ran."""
    name = row["config"]
    row = {**row, "syncs_per_draw": syncs, "setup_syncs": setup_syncs,
           **extra, "rank_rhat_margin": SUITE_RHAT_MAX - row["max_rank_rhat"],
           **SHARED_HOST}
    if cut is not None and "full" in cut:
        row["draws_cut_from"] = list(cut["full"])
        row["draws"] = [cut["warm"], cut["keep"]]
    print(f"{name}: {json.dumps(row)}")
    check(bool(torch.isfinite(out.draws).all()), f"{name}: every draw "
          "finite")
    check(row["max_rank_rhat"] <= SUITE_RHAT_MAX, f"{name}: max rank R-hat "
          f"{row['max_rank_rhat']:.4f} <= {SUITE_RHAT_MAX}")
    if zero_syncs:
        check(syncs == 0, f"{name}: {syncs} host syncs per draw, 0 "
              "expected")


def mean_z(a, b):
    """The largest |mean difference| over combined MC standard errors of two
    summaries (``b`` may be exact: MC standard error 0)."""
    return float(((a["mean"] - b["mean"]).abs()
                  / torch.hypot(a["mcse"], b["mcse"])).max())


def mean_gate(what, a, b, sigmas=NUTS_MEAN_SIGMAS):
    """Each dimension's mean of ``a`` within ``sigmas`` combined MC standard
    errors of ``b``'s (``b`` may be exact: MC standard error 0)."""
    z = mean_z(a, b)
    print(f"{what}: max |mean difference| / combined MC standard error "
          f"{z:.3f} (tol {sigmas:g})")
    check(z <= sigmas, f"{what}: means within {sigmas:g} combined MC "
          "standard errors")


def ms_model():
    """``(x2, lk_ms)``: the (mu, sigma) rows' data, 2 + 2 N(0, 1), and its
    likelihood."""
    from mcmc_tpu_torch.models import gaussian_mean_scale_model
    x2 = 2.0 + 2.0 * np.random.default_rng(0).standard_normal(SUITE_N_DATA)
    return x2, gaussian_mean_scale_model(x2)


def rmhmc_settings(warm, keep):
    from mcmc_tpu_torch import RMHMCSettings
    r = RMHMC_ROW
    return RMHMCSettings(n_burnin_draws=warm, n_keep_draws=keep,
                         step_size=r["step"], n_leap_steps=r["leap"],
                         n_fp_steps=r["fp"])


def row_rmhmc_fisher(dev):
    """Phase 14's rmhmc_fisher row (module docstring), in a worker process.
    Returns its means and MC standard errors, for the gate against
    rwmh_gaussian_2d's on the same posterior."""
    from mcmc_tpu_torch import rmhmc
    from mcmc_tpu_torch.models import normal_fisher_metric
    r = RMHMC_ROW
    _x2, lk_ms = ms_model()
    metric = normal_fisher_metric(SUITE_N_DATA)
    run = lambda w, k: rmhmc(np.array([2.5, 2.5]), lk_ms, metric,
                             rmhmc_settings(w, k), n_chains=r["chains"],
                             key=9)
    out, row, summ = suite_record("rmhmc_fisher",
                                  lambda: run(r["warm"], r["keep"]))
    gate_row(row, out, *entry_syncs_per_draw(lambda n: run(n, n)), cut=r,
             accept_rate=float(out.accept_rate.mean()),
             leapfrogs_per_draw=r["leap"],
             metric_evaluations_per_draw=r["leap"] * (r["fp"] + 2))
    return {"summ": summ}


def hard_mixture():
    """``(mu, lk_hard)``: the tempering rows' two-mode mixture, modes at
    +-2, variance 0.1."""
    from mcmc_tpu_torch.models import gaussian_mixture_model
    mu = np.array([[-2.0, -2.0], [2.0, 2.0]])
    return mu, gaussian_mixture_model(mu, np.array([0.1, 0.1]),
                                      np.array([0.5, 0.5]))


def aees_settings(initial, burnin, keep):
    from mcmc_tpu_torch import AEESSettings
    r = AEES_ROW
    return AEESSettings(
        n_initial_draws=initial, n_burnin_draws=burnin, n_keep_draws=keep,
        n_rings=r["rings"], ee_prob_par=r["ee_prob"],
        temper_vec=np.array(r["temps"]), cov_mat=r["cov"] * np.eye(2))


def suite_rows(dev):
    """Phase 14: the suite's rows of RWMH, MALA, DE and RM-HMC at their full
    settings, through the entry points from numpy inputs with no
    ``device=`` (module docstring), then the SoftAbs sync count. Returns
    MALA's and RM-HMC's kernels, generators and states at the rows' shapes,
    for the profile."""
    from mcmc_tpu_torch import (AlgoSettings, DESettings, HMCSettings,
                                MALASettings, RMHMCSettings, RWMHSettings,
                                de, hmc, mala, rmhmc, rwmh, softabs_metric)
    from mcmc_tpu_torch.convert import glm_data
    from mcmc_tpu_torch.models import (gaussian_mixture_model,
                                       logistic_regression_model,
                                       make_logistic_regression_data,
                                       neals_funnel, normal_fisher_metric)
    from mcmc_tpu_torch.samplers import common
    from mcmc_tpu_torch.samplers.mala import build_mala_kernel
    from mcmc_tpu_torch.samplers.rmhmc import build_rmhmc_kernel

    t_phase = time.perf_counter()
    x2, lk_ms = ms_model()

    # rwmh_gaussian_2d
    r = RWMH_ROW
    run = lambda w, k: rwmh(np.array([2.0, 2.0]), lk_ms, RWMHSettings(
        n_burnin_draws=w, n_keep_draws=k, par_scale=r["par_scale"]),
        n_chains=r["chains"], key=1)
    out, row, rw_summ = suite_record("rwmh_gaussian_2d",
                                     lambda: run(r["warm"], r["keep"]))
    gate_row(row, out, *entry_syncs_per_draw(lambda n: run(n, n)),
             accept_rate=float(out.accept_rate.mean()),
             evaluations_per_draw=1)

    # rmhmc_fisher runs in a worker process (row_rmhmc_fisher)
    metric = normal_fisher_metric(SUITE_N_DATA)

    # mala_logreg_25d, against generic HMC on the same posterior
    r = MALA_ROW
    X, y, _ = make_logistic_regression_data(2, r["n_data"], r["dim"],
                                            device="cpu")
    lk_lr = logistic_regression_model(*glm_data(X.numpy(), y.numpy()))
    run = lambda w, k: mala(np.zeros(r["dim"]), lk_lr, MALASettings(
        n_burnin_draws=w, n_keep_draws=k, step_size=r["step"]),
        n_chains=r["chains"], key=3, adapt_step_size=True)
    out, row, ma_summ = suite_record("mala_logreg_25d",
                                     lambda: run(r["warm"], r["keep"]))
    gate_row(row, out, *entry_syncs_per_draw(lambda n: run(n, n)),
             accept_rate=float(out.accept_rate.mean()),
             adapted_step_size=float(
                 out.diagnostics["adapted_step_size"].mean()),
             gradients_per_draw=1)
    m = MALA_REF
    ref, ref_row, ref_summ = suite_record("mala_logreg_25d hmc reference",
                                          lambda: hmc(
        np.zeros(r["dim"]), lk_lr, HMCSettings(
            n_burnin_draws=m["warm"], n_keep_draws=m["keep"],
            step_size=m["step"], n_leap_steps=m["leap"]),
        n_chains=m["chains"], key=4, adapt_step_size=True,
        adapt_mass_matrix=True))
    print(f"mala_logreg_25d hmc reference: {json.dumps(ref_row)}")
    check(bool(torch.isfinite(ref.draws).all()), "mala's hmc reference: "
          "draws finite")
    check(max(ref_row["max_split_rhat"], ref_row["max_rank_rhat"])
          <= SUITE_RHAT_MAX, "mala's hmc reference converged (split and "
          f"rank R-hat <= {SUITE_RHAT_MAX})")
    mean_gate("mala_logreg_25d vs hmc reference", ma_summ, ref_summ)

    # de_mixture, against the exact mean 0
    r = DE_ROW
    lk_mix = gaussian_mixture_model(np.array([[-2.0, -2.0], [2.0, 2.0]]),
                                    np.array([0.5, 0.5]),
                                    np.array([0.5, 0.5]))
    box = np.full(2, r["box"])
    run = lambda w, k: de(np.zeros(2), lk_mix, DESettings(
        n_pop=r["n_pop"], n_burnin_draws=w, n_keep_draws=k,
        initial_lb=-box, initial_ub=box), key=7)
    out, row, de_summ = suite_record("de_mixture",
                                     lambda: run(r["warm"], r["keep"]))
    gate_row(row, out, *entry_syncs_per_draw(lambda n: run(n, n)),
             accept_rate=int(out.n_accept_draws)
             / (r["keep"] * r["n_pop"]),
             mode_share=float((out.draws[..., 0] > 0).float().mean()))
    zero = {"mean": torch.zeros(2, device=dev),
            "mcse": torch.zeros(2, device=dev)}
    mean_gate("de_mixture vs the exact mean 0", de_summ, zero)

    # SoftAbs on Neal's funnel: eigh's host syncs, counted
    r = SOFTABS_ROW
    lk_f = neals_funnel(r["dim"], 3.0)
    metric_f = softabs_metric(lk_f, 1.0)
    run = lambda n: rmhmc(np.zeros(r["dim"]), lk_f, metric_f, RMHMCSettings(
        n_burnin_draws=n, n_keep_draws=n, step_size=r["step"],
        n_leap_steps=r["leap"], n_fp_steps=r["fp"]), n_chains=r["chains"],
        key=11)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run(r["n"])
    torch.cuda.synchronize()
    el = time.perf_counter() - t0
    syncs, setup = entry_syncs_per_draw(run)
    evals = r["leap"] * (r["fp"] + r["dim"])
    print(f"rmhmc softabs funnel: {r['chains']} chains, {2 * r['n']} draws "
          f"in {el:.3f} s ({1e3 * el / (2 * r['n']):.1f} ms a draw), accept "
          f"{float(out.accept_rate.mean()):.4f}; {syncs} host syncs per draw "
          f"({setup} in the set-up of the shorter probe) for {evals} metric "
          f"evaluations (each one eigh) per draw")
    check(bool(torch.isfinite(out.draws).all()), "softabs: draws finite")
    check(syncs == EIGH_SYNCS * evals, f"softabs: {syncs} host syncs per "
          f"draw, {EIGH_SYNCS} per eigh expected ({EIGH_SYNCS * evals})")
    print(f"suite rows: phase seconds {time.perf_counter() - t_phase:.1f}")

    # steady transitions at the rows' shapes, for the profile
    gen = torch.Generator(device=dev).manual_seed(54)
    prob = common.setup_problem(torch.zeros((MALA_ROW["chains"],
                                             MALA_ROW["dim"]), device=dev),
                                lk_lr, AlgoSettings(), None)
    init, mala_step = build_mala_kernel(
        prob, common.make_spd(None, MALA_ROW["dim"], torch.float32, dev),
        MALA_ROW["step"], "reference",
        {"n_burnin": MALA_ROW["warm"], "target": 0.574})
    mala_path = (mala_step, gen, init(prob.first_draw))
    prob = common.setup_problem(torch.full((RMHMC_ROW["chains"], 2), 2.5,
                                           device=dev), lk_ms, AlgoSettings(),
                                None)
    init, rm_step = build_rmhmc_kernel(
        prob, metric, rmhmc_settings(RMHMC_ROW["warm"], RMHMC_ROW["keep"]))
    # the (mu, sigma) posterior's exact mean under its flat prior: mu's is
    # the data's mean; sigma's, E[s] = sqrt(S / 2) G(a - 1/2) / G(a) with S
    # the sum of squared deviations and a = (n - 2) / 2
    x32 = x2.astype(np.float32).astype(np.float64)
    S, a = float(((x32 - x32.mean()) ** 2).sum()), (SUITE_N_DATA - 2) / 2.0
    e_sigma = math.sqrt(S / 2.0) * math.exp(math.lgamma(a - 0.5)
                                            - math.lgamma(a))
    refs = {"lk_ms": lk_ms, "lk_lr": lk_lr, "mala_ref": ref_summ,
            "rwmh": rw_summ, "x2": x2,
            "ms_exact": {"mean": torch.tensor([x32.mean(), e_sigma],
                                              dtype=torch.float32,
                                              device=dev),
                         "mcse": torch.zeros(2, device=dev)}}
    return mala_path, (rm_step, gen, init(prob.first_draw)), refs


def tempering_rows(dev):
    """Phase 15: the suite's rows of SMC, the stretch ensemble and DE-MC(Z)
    at their full settings, through the entry points from numpy inputs with
    no ``device=`` (module docstring); AEES's and PT's run in worker
    processes (``row_aees_mixture``, ``row_pt_mixture``). Returns AEES's
    and PT's kernels, generators and states at the rows' shapes, for the
    profile."""
    from mcmc_tpu_torch import (DEMCZSettings, PTSettings, SMCSettings,
                                StretchSettings, demcz, smc, stretch)
    from mcmc_tpu_torch.models import gaussian_mixture_model
    from mcmc_tpu_torch.samplers.aees import build_aees_kernel, make_temps
    from mcmc_tpu_torch.samplers.pt import build_pt_kernel

    t_phase = time.perf_counter()
    mu, lk_hard = hard_mixture()
    zero = lambda d: {"mean": torch.zeros(d, device=dev),
                      "mcse": torch.zeros(d, device=dev)}

    # aees_mixture and pt_mixture run in worker processes
    # (row_aees_mixture, row_pt_mixture)

    # smc_mixture: one cloud, the suite's own gates (benchmarks/suite.py
    # :234-264), and one host sync a stage
    r = SMC_ROW
    lk_mix = gaussian_mixture_model(mu, np.array([0.5, 0.5]),
                                    np.array([0.5, 0.5]))
    run = lambda m: smc(np.zeros(2), lk_mix, SMCSettings(
        n_particles=r["particles"], n_mcmc_steps=r["mcmc"],
        init_scale=r["init_scale"], max_stages=m), key=r["key"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run(100)
    torch.cuda.synchronize()
    el = time.perf_counter() - t0
    cloud = out.draws
    check(cloud.is_cuda and tuple(cloud.shape) == (r["particles"], 2),
          "smc_mixture: the cloud on the card, (particles, 2)")
    check(bool(torch.isfinite(cloud).all()), "smc_mixture: every particle "
          "finite")
    n_stages = out.diagnostics["n_stages"]
    log_z_err = abs(float(out.diagnostics["log_z"]))
    mass_err = abs(float((cloud[:, 0] > 0).float().mean()) - 0.5)
    s1, _ = sync_warnings(lambda: run(1))
    s2, _ = sync_warnings(lambda: run(2))
    s_all, _ = sync_warnings(lambda: run(100))
    row = {"config": "smc_mixture", "seconds": el,
           "particles_per_sec": r["particles"] / el, "n_stages": n_stages,
           "ms_per_stage": 1e3 * el / n_stages,
           "abs_log_z_error": log_z_err, "abs_log_z_gate": r["log_z_gate"],
           "mode_mass_error": mass_err, "mode_mass_gate": r["mass_gate"],
           "lambdas": out.diagnostics["lambdas"].tolist(),
           "mutation_accept_rate":
               out.diagnostics["mutation_accept_rate"].tolist(),
           "syncs_per_stage": s2 - s1, "syncs_one_stage_run": s1,
           "syncs_whole_run": s_all, **SHARED_HOST}
    row["passed"] = log_z_err <= r["log_z_gate"] and mass_err <= r["mass_gate"]
    print(f"smc_mixture: {json.dumps(row)}")
    check(out.diagnostics["completed"], "smc_mixture: lambda reached 1")
    check(log_z_err <= r["log_z_gate"], f"smc_mixture: |log Z| "
          f"{log_z_err:.4f} <= {r['log_z_gate']}")
    check(mass_err <= r["mass_gate"], f"smc_mixture: |mode mass - 0.5| "
          f"{mass_err:.4f} <= {r['mass_gate']}")
    # a run stopped by max_stages tests no lambda after its last stage; one
    # that reaches lambda 1 tests it once more, to end
    check(s2 - s1 == 1, f"smc_mixture: {s2 - s1} host syncs for a stage, 1 "
          "expected")
    check(s_all - s1 == n_stages, f"smc_mixture: {s_all - s1} host syncs "
          f"for {n_stages - 1} more stages and the end, {n_stages} expected")

    # stretch_correlated
    r = STRETCH_ROW
    prec = torch.tensor(np.linalg.inv([[1.0, r["rho"]], [r["rho"], 1.0]]),
                        dtype=torch.float32, device=dev)
    lk_c = lambda v: -0.5 * ((v @ prec) * v).sum(-1)
    run = lambda w, k: stretch(np.zeros(2), lk_c, StretchSettings(
        n_walkers=r["walkers"], n_burnin_draws=w, n_keep_draws=k),
        key=r["key"])
    out, row, summ = suite_record("stretch_correlated",
                                  lambda: run(r["warm"], r["keep"]))
    gate_row(row, out, *entry_syncs_per_draw(lambda n: run(n, n)),
             ms_per_sweep=1e3 * row["seconds"] / (r["warm"] + r["keep"]),
             accept_rate=int(out.n_accept_draws)
             / (r["keep"] * r["walkers"]),
             correlation=float(torch.corrcoef(out.draws.reshape(-1, 2).T)
                               [0, 1]))
    mean_gate("stretch_correlated vs the exact mean 0", summ, zero(2))

    # demcz_correlated_10d
    r = DEMCZ_ROW
    d = r["dim"]
    cov = r["rho"] * np.ones((d, d)) + (1 - r["rho"]) * np.eye(d)
    P = torch.tensor(np.linalg.inv(cov), dtype=torch.float32, device=dev)
    lk_z = lambda v: -0.5 * ((v @ P) * v).sum(-1)
    run = lambda w, k: demcz(np.zeros(d), lk_z, DEMCZSettings(
        n_pop=r["n_pop"], n_burnin_draws=w, n_keep_draws=k),
        n_runs=r["runs"], key=r["key"])
    out, row, summ = suite_record("demcz_correlated_10d",
                                  lambda: run(r["warm"], r["keep"]))
    gate_row(row, out, *entry_syncs_per_draw(lambda n: run(n, n)),
             ms_per_generation=1e3 * row["seconds"] / (r["warm"] + r["keep"]),
             accept_rate=int(out.n_accept_draws)
             / (r["keep"] * r["runs"] * r["n_pop"]),
             min_variance=float(out.draws.reshape(-1, d).var(dim=0).min()),
             max_variance=float(out.draws.reshape(-1, d).var(dim=0).max()))
    mean_gate("demcz_correlated_10d vs the exact mean 0", summ, zero(d))

    print(f"tempering rows: phase seconds {time.perf_counter() - t_phase:.1f}")

    # steady draws at the rows' shapes, for the profile
    r = AEES_ROW
    K = len(r["temps"]) + 1
    s = aees_settings(r["initial"], r["burnin"], r["keep"])
    first = torch.tensor(mu[0], dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(55)
    make0, aees_step = build_aees_kernel(lk_hard, make_temps(s), s, 2,
                                         torch.float32, dev, r["capacity"])
    st = make0(first, lk_hard(first[None])[0], r["runs"])
    st = st._replace(draw_ind=K * (r["initial"] + r["burnin"]) + 600)
    r = PT_ROW
    make0, pt_step = build_pt_kernel(lk_hard, PTSettings(
        n_temps=r["temps"], max_temp=r["max_temp"], adapt_temps=True,
        inner="hmc", step_size=r["step"], n_leap_steps=r["leap"]), 2,
        torch.float32, dev, r["warm"])
    x0 = first.expand(r["chains"], 2)
    pst = make0(x0, lk_hard(x0))._replace(draw_ind=r["warm"])
    return (aees_step, gen, st), (pt_step, gen, pst)


def row_aees_mixture(dev):
    """Phase 15's aees_mixture row (module docstring) and the cost of an
    AEES draw with the full history at the row's length, in a worker
    process."""
    from mcmc_tpu_torch import aees
    from mcmc_tpu_torch.samplers.aees import build_aees_kernel, make_temps
    mu, lk_hard = hard_mixture()
    zero = lambda d: {"mean": torch.zeros(d, device=dev),
                      "mcse": torch.zeros(d, device=dev)}
    # K * (n_initial + n_burnin) discarded draws, then kept
    r = AEES_ROW
    K = len(r["temps"]) + 1
    run = lambda i, b, k: aees(mu[0], lk_hard, aees_settings(i, b, k),
                               key=r["key"],
                               n_runs=r["runs"],
                               history_capacity=r["capacity"])
    out, row, summ = suite_record(
        "aees_mixture", lambda: run(r["initial"], r["burnin"], r["keep"]))
    n_draws = K * (r["initial"] + r["burnin"]) + r["keep"]
    gate_row(row, out, *entry_syncs_per_draw(lambda n: run(n, 0, n),
                                             lambda n: (K + 1) * n),
             draws=n_draws, ms_per_draw=1e3 * row["seconds"] / n_draws,
             temperatures=out.diagnostics["temperatures"].tolist(),
             ee_accept_rate=out.diagnostics["ee_accept_rate"].tolist(),
             mode_share=float((out.draws[..., 0] > 0).float().mean()))
    mean_gate("aees_mixture vs the exact mean 0", summ, zero(2))

    # AEES's full history at the row's length: each rung sorts its window
    s = aees_settings(r["initial"], r["burnin"], r["keep"])
    make0, full_step = build_aees_kernel(
        lk_hard, make_temps(s), s, 2, torch.float32, dev, None)
    first = torch.tensor(mu[0], dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(55)
    st = make0(first, lk_hard(first[None])[0], r["runs"])
    st = st._replace(draw_ind=full_step.H - AEES_FULL_DRAWS - 1)
    with torch.no_grad():
        st, _ = full_step(gen, st)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(AEES_FULL_DRAWS):
            st, _ = full_step(gen, st)
        torch.cuda.synchronize()
    full_ms = 1e3 * (time.perf_counter() - t0) / AEES_FULL_DRAWS
    print(f"aees full history: {r['runs']} runs, windows of about "
          f"{full_step.H} entries a rung: {full_ms:.3f} ms a draw (the row "
          f"keeps a reservoir of {r['capacity']})")
    return {}


def row_pt_mixture(dev):
    """Phase 15's pt_mixture row (module docstring), in a worker process."""
    from mcmc_tpu_torch import PTSettings, pt
    mu, lk_hard = hard_mixture()
    zero = lambda d: {"mean": torch.zeros(d, device=dev),
                      "mcse": torch.zeros(d, device=dev)}
    r = PT_ROW
    run = lambda w, k: pt(mu[0], lk_hard, PTSettings(
        n_burnin_draws=w, n_keep_draws=k, n_temps=r["temps"],
        max_temp=r["max_temp"], adapt_temps=True, inner="hmc",
        step_size=r["step"], n_leap_steps=r["leap"]), n_chains=r["chains"],
        key=r["key"])
    out, row, summ = suite_record("pt_mixture",
                                  lambda: run(r["warm"], r["keep"]))
    trips = out.diagnostics["round_trip_rate"]
    gate_row(row, out, *entry_syncs_per_draw(lambda n: run(n, n)),
             ms_per_draw=1e3 * row["seconds"] / (r["warm"] + r["keep"]),
             accept_rate=float(out.accept_rate.mean()),
             temperatures=out.diagnostics["temperatures"].tolist(),
             swap_accept_rate=out.diagnostics["swap_accept_rate"]
             .mean(dim=0).tolist(),
             round_trip_rate=float(trips.mean()),
             min_round_trip_rate=float(trips.min()),
             mode_share=float((out.draws[..., 0] > 0).float().mean()))
    check(float(trips.mean()) > 0, "pt_mixture: round_trip_rate > 0")
    mean_gate("pt_mixture vs the exact mean 0", summ, zero(2))
    return {}


def sgld_data(seed, n_data, dim):
    """The SGLD line's tall logistic regression, made with numpy (the same
    as ``scripts/jax_sgld_tolerance.py``'s): X ~ N(0, 1), beta ~ 0.5 N(0,
    1), y ~ Bernoulli(sigmoid(X beta))."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n_data, dim)).astype(np.float32)
    beta = (0.5 * rng.standard_normal(dim)).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-(X.astype(np.float64) @ beta)))
    y = (rng.uniform(size=n_data) < p).astype(np.float32)
    return X, y, beta


def loop_sync_audit(name, step, gen, state, per_draw_evals):
    """Run ``LOOP_SYNC_DRAWS`` draws of a looping kernel (slice, ellipse)
    under CUDA's sync debug mode: the syncs it sees must be the kernel's
    own count. Prints syncs and evaluations per draw; returns the state."""
    before = dict(step.counts)
    seen, state = count_syncs(step, gen, state, LOOP_SYNC_DRAWS)
    own = step.counts["syncs"] - before["syncs"]
    evals = (step.counts["evaluations"] - before["evaluations"]) \
        / LOOP_SYNC_DRAWS
    print(f"{name} kernel: {own / LOOP_SYNC_DRAWS:.2f} host syncs and "
          f"{evals:.2f} batched evaluations per draw over "
          f"{LOOP_SYNC_DRAWS} draws ({per_draw_evals})")
    check(seen == own, f"{name}: CUDA's sync debug mode saw {seen} syncs, "
          f"the kernel counted {own}")
    return state


def remaining_rows(dev, refs):
    """Phase 16: the suite's rows of Barker and slice at their full settings
    and the SGLD and mMALA lines, through the entry points from numpy inputs
    with no ``device=`` (module docstring); the ellipse's and Gibbs's rows
    run in worker processes (``row_elliptical``, ``row_gibbs``). Returns
    the slice kernel, its generator and state at the row's shape, for the
    profile, and adds slice's and mMALA's summaries to ``refs``."""
    from mcmc_tpu_torch import (BarkerSettings, HMCSettings, MMALASettings,
                                SGHMCSettings, SGLDSettings, SliceSettings,
                                barker, hmc, mmala, sghmc, sgld,
                                slice_sampler)
    from mcmc_tpu_torch.models import normal_fisher_metric
    from mcmc_tpu_torch.samplers.slice import build_slice_kernel

    t_phase = time.perf_counter()
    lk_ms, lk_lr = refs["lk_ms"], refs["lk_lr"]
    gen = torch.Generator(device=dev).manual_seed(56)

    # barker_logreg_25d, against phase 14's hmc reference on its posterior
    r = BARKER_ROW
    run = lambda w, k: barker(np.zeros(MALA_ROW["dim"]), lk_lr,
                              BarkerSettings(n_burnin_draws=w,
                                             n_keep_draws=k,
                                             step_size=r["step"]),
                              n_chains=r["chains"], key=r["key"],
                              adapt_step_size=True, adapt_precond=True,
                              pooled_adaptation=True)
    out, row, summ = suite_record("barker_logreg_25d",
                                  lambda: run(r["warm"], r["keep"]))
    gate_row(row, out, *entry_syncs_per_draw(lambda n: run(n, n)),
             accept_rate=float(out.accept_rate.mean()),
             adapted_step_size=float(
                 out.diagnostics["adapted_step_size"].mean()),
             gradients_per_draw=1)
    mean_gate("barker_logreg_25d vs mala_logreg_25d's hmc reference", summ,
              refs["mala_ref"])

    # elliptical_latent_gp_64d and gibbs_hierarchical run in worker
    # processes (row_elliptical, row_gibbs)

    # slice_gaussian_2d, against rmhmc_fisher's means on the same posterior
    r = SLICE_ROW
    run = lambda w, k: slice_sampler(np.array([2.0, 2.0]), lk_ms,
                                     SliceSettings(n_burnin_draws=w,
                                                   n_keep_draws=k),
                                     n_chains=r["chains"], key=r["key"])
    out, row, summ = suite_record("slice_gaussian_2d",
                                  lambda: run(r["warm"], r["keep"]))
    gate_row(row, out, *entry_syncs_per_draw(lambda n: run(n, n)), cut=r,
             zero_syncs=False, accept_rate=float(out.accept_rate.mean()),
             mean_kernel_evals_per_draw=float(
                 out.diagnostics["mean_kernel_evals"].mean()),
             ms_per_draw=1e3 * row["seconds"] / (r["warm"] + r["keep"]))
    mean_gate("slice_gaussian_2d vs the exact posterior mean", summ,
              refs["ms_exact"])
    refs["slice"] = summ    # against rmhmc_fisher's once its worker is done
    init, sl_step = build_slice_kernel(lk_ms, 2, torch.float32, 1.0, 8, 32)
    sl_state = loop_sync_audit(
        "slice_gaussian_2d", sl_step, gen, init(out.draws[-1].clone()),
        "per coordinate: the stepping-out's iterations, then the "
        "shrinkage's, each one sync and one or two evaluations")

    # the SGLD line: sgld shared and per-chain, sghmc shared, against a
    # full-data hmc reference
    r = SGLD_ROW
    X_np, y_np, beta = sgld_data(r["seed"], r["n_data"], r["dim"])
    Xs, ys = torch.tensor(X_np, device=dev), torch.tensor(y_np, device=dev)
    prior = lambda b: -0.5 * (b * b).sum(-1) / 100.0

    def lik(theta, batch):
        Xb, yb = batch
        eta = (Xb @ theta[:, :, None])[..., 0]
        return (yb * eta - torch.nn.functional.softplus(eta)).sum(-1)

    def full(b):
        eta = b @ Xs.T
        return (ys * eta - torch.nn.functional.softplus(eta)).sum(-1) \
            + prior(b)

    g = SGLD_REF
    ref, ref_row, ref_summ = suite_record("sgld full-data hmc reference",
                                          lambda: hmc(
        beta, full, HMCSettings(
            n_burnin_draws=g["warm"], n_keep_draws=g["keep"],
            step_size=g["step"], n_leap_steps=g["leap"]),
        n_chains=g["chains"], key=g["key"], adapt_step_size=True,
        adapt_mass_matrix=True))
    off = float((ref_summ["mean"].cpu() - torch.from_numpy(beta)).abs().max())
    print(f"sgld full-data hmc reference: {json.dumps(ref_row)}; max |mean "
          f"- beta_true| {off}")
    check(max(ref_row["max_split_rhat"], ref_row["max_rank_rhat"])
          <= SUITE_RHAT_MAX, "sgld's hmc reference converged (split and "
          f"rank R-hat <= {SUITE_RHAT_MAX})")
    sg_settings = {
        "sgld": SGLDSettings(step_size=r["step"], batch_size=r["batch"],
                             decay_gamma=r["decay_gamma"],
                             decay_b=r["decay_b"]),
        "sghmc": SGHMCSettings(batch_size=r["batch"])}

    def sg_run(name, n_warm=None, n_keep=None, key=1):
        """One SG-MCMC line: sgld shared or per-chain with the example's
        settings (``n_warm`` and ``n_keep`` its own unless given), sghmc
        shared with its defaults at B 512."""
        kind, mb = name.split("_")
        s = sg_settings[kind]
        if kind == "sgld" and n_warm is None:
            n_warm, n_keep = r["warm"], r["keep"]
        if n_warm is not None:
            s = dataclasses.replace(s, n_burnin_draws=n_warm,
                                    n_keep_draws=n_keep)
        return (sgld if kind == "sgld" else sghmc)(
            np.zeros(r["dim"]), prior, lik, (X_np, y_np), s,
            n_chains=r["chains"], key=key, minibatch=mb)

    for name in ("sgld_shared", "sgld_per-chain", "sghmc_shared"):
        out, row, summ = suite_record(name, lambda: sg_run(name))
        s = sg_settings[name.split("_")[0]]
        n_draws = s.n_burnin_draws + s.n_keep_draws \
            if name.startswith("sghmc") else r["warm"] + r["keep"]
        diff = float((summ["mean"] - ref_summ["mean"]).abs().max())
        rate = float(out.accept_rate.mean())
        syncs, setup = entry_syncs_per_draw(
            lambda n: sg_run(name, n, n, key=3))
        row = {**row, "finite_update_rate": rate,
               "max_abs_mean_diff_vs_hmc": diff, "tolerance": SGLD_MEAN_TOL,
               "draws_per_sec_with_warmup": n_draws * r["chains"]
               / row["seconds"], "syncs_per_draw": syncs,
               "setup_syncs": setup, **SHARED_HOST}
        print(f"{name}: {json.dumps(row)}")
        check(bool(torch.isfinite(out.draws).all()), f"{name}: draws finite")
        check(rate == 1.0, f"{name}: finite-update rate {rate} == 1.0")
        check(diff <= SGLD_MEAN_TOL, f"{name}: max |mean - hmc mean| "
              f"{diff:.5f} <= {SGLD_MEAN_TOL}")
        check(syncs == 0, f"{name}: {syncs} host syncs per draw, 0 "
              "expected")

    # the mMALA line, against rmhmc_fisher's means on the same posterior
    r = MMALA_ROW
    metric = normal_fisher_metric(SUITE_N_DATA)
    run = lambda w, k: mmala(np.array([2.5, 2.5]), lk_ms, metric,
                             MMALASettings(n_burnin_draws=w,
                                           n_keep_draws=k),
                             n_chains=r["chains"], key=r["key"],
                             adapt_step_size=True)
    out, row, summ = suite_record("mmala_fisher",
                                  lambda: run(r["warm"], r["keep"]))
    gate_row(row, out, *entry_syncs_per_draw(lambda n: run(n, n)), cut=r,
             accept_rate=float(out.accept_rate.mean()),
             adapted_step_size=float(
                 out.diagnostics["adapted_step_size"].mean()),
             ms_per_draw=1e3 * row["seconds"] / (r["warm"] + r["keep"]))
    mean_gate("mmala_fisher vs the exact posterior mean", summ,
              refs["ms_exact"])
    refs["mmala"] = summ
    print(f"remaining rows: phase seconds {time.perf_counter() - t_phase:.1f}")
    return sl_step, gen, sl_state


def ellipse_model(dev):
    """``(xs, K, lik)`` of the elliptical_latent_gp_64d row: the inputs,
    the prior covariance ``rbf_kernel(xs, 0.5)`` and the Gaussian
    likelihood of y = sin(2x) at noise variance 0.25."""
    from mcmc_tpu_torch.models import rbf_kernel
    r = ELLIPSE_ROW
    xs = np.linspace(0.0, 4.0, r["n"])
    K = rbf_kernel(xs, r["length_scale"])
    y = torch.tensor(np.sin(2.0 * xs), dtype=torch.float32, device=dev)
    noise_var = r["noise_var"]
    return xs, K, lambda f: -0.5 * ((y - f) ** 2).sum(-1) / noise_var


def row_elliptical(dev):
    """Phase 16's elliptical_latent_gp_64d row (module docstring), in a
    worker process. Returns its last draws (the profile's start)."""
    from mcmc_tpu_torch import EllipticalSettings, elliptical_slice
    from mcmc_tpu_torch.models import (gp_regression_exact_posterior,
                                       rbf_kernel)
    r = ELLIPSE_ROW
    xs, K, lik = ellipse_model(dev)
    run = lambda w, k: elliptical_slice(
        np.zeros(r["n"]), lik, EllipticalSettings(n_burnin_draws=w,
                                                  n_keep_draws=k),
        prior_cov=K.cpu().numpy(), n_chains=r["chains"], key=r["key"])
    out, row, summ = suite_record("elliptical_latent_gp_64d",
                                  lambda: run(r["warm"], r["keep"]))
    shrink = float(out.diagnostics["mean_shrink_steps"].mean())
    gate_row(row, out, *entry_syncs_per_draw(lambda n: run(n, n)), cut=r,
             zero_syncs=False, accept_rate=float(out.accept_rate.mean()),
             mean_shrink_steps_per_draw=shrink,
             ms_per_draw=1e3 * row["seconds"] / (r["warm"] + r["keep"]))
    K64 = rbf_kernel(xs, r["length_scale"], dtype=torch.float64)
    exact, _ = gp_regression_exact_posterior(K64, np.sin(2.0 * xs),
                                             r["noise_var"])
    mean_gate("elliptical_latent_gp_64d vs the exact posterior mean", summ,
              {"mean": exact.float(), "mcse": torch.zeros_like(summ["mcse"])})
    return {"last": out.draws[-1]}


def gibbs_model(dev):
    """``(lk_gibbs, blocks, J)`` of the gibbs_hierarchical row: the eight-
    schools-like hierarchy on numpy-seeded data, its exact theta block and
    its HMC hyperblock."""
    r = GIBBS_ROW
    J = r["J"]
    rng = np.random.default_rng(r["data_seed"])
    theta_true = 4.0 + 6.0 * rng.standard_normal(J)
    y_np = theta_true + 4.0 * rng.standard_normal(J)
    yg = torch.tensor(y_np, dtype=torch.float32, device=dev)
    sg = torch.full((J,), 4.0, device=dev)

    def lk_gibbs(v):
        theta, mu_h, log_tau = v[:, :J], v[:, J], v[:, J + 1]
        tau = torch.exp(log_tau)
        lp = -0.5 * ((yg - theta) ** 2 / sg ** 2).sum(-1)
        lp = lp - 0.5 * ((theta - mu_h[:, None]) ** 2).sum(-1) / tau ** 2 \
            - J * log_tau
        lp = lp - 0.5 * mu_h ** 2 / 25.0
        return lp - 0.5 * tau ** 2 / 64.0 + log_tau

    def cond_theta(g, full):
        mu_h, tau = full[:, J:J + 1], torch.exp(full[:, J + 1:J + 2])
        prec = 1.0 / sg ** 2 + 1.0 / tau ** 2
        mean = (yg / sg ** 2 + mu_h / tau ** 2) / prec
        return mean + torch.randn(mean.shape, generator=g,
                                  device=full.device) / torch.sqrt(prec)

    blocks = [(list(range(J)), cond_theta),
              ([J, J + 1], "hmc", {"step_size": r["step"],
                                   "n_leap_steps": r["leap"]})]
    return lk_gibbs, blocks, J


def row_gibbs(dev):
    """Phase 16's gibbs_hierarchical row and its NUTS reference (module
    docstring), in a worker process. Returns its last draws (the profile's
    start)."""
    from mcmc_tpu_torch import GibbsSettings, NUTSSettings, gibbs, nuts
    r = GIBBS_ROW
    lk_gibbs, blocks, J = gibbs_model(dev)
    run = lambda w, k: gibbs(np.zeros(J + 2), lk_gibbs,
                             GibbsSettings(n_burnin_draws=w, n_keep_draws=k),
                             blocks=blocks, n_chains=r["chains"],
                             key=r["key"])
    out, row, summ = suite_record("gibbs_hierarchical",
                                  lambda: run(r["warm"], r["keep"]))
    gate_row(row, out, *entry_syncs_per_draw(lambda n: run(n, n)), cut=r,
             block_accept_rate=out.diagnostics["block_accept_rate"]
             .mean(dim=0).tolist(),
             ms_per_sweep=1e3 * row["seconds"] / (r["warm"] + r["keep"]),
             data="numpy-seeded (default_rng(42)); the suite draws it "
                  "from a JAX key")
    g = GIBBS_REF
    ref, ref_row, ref_summ = suite_record(
        "gibbs_hierarchical nuts reference", lambda: nuts(
            out.draws[-1, :g["chains"]].clone(), lk_gibbs, NUTSSettings(
                n_burnin_draws=g["warm"], n_keep_draws=g["keep"],
                n_adapt_draws=g["warm"], max_tree_depth=g["depth"]),
            key=g["key"], adapt_mass_matrix=True))
    print(f"gibbs_hierarchical nuts reference: {json.dumps(ref_row)}")
    check(bool(torch.isfinite(ref.draws).all()), "gibbs's nuts reference: "
          "draws finite")
    check(max(ref_row["max_split_rhat"], ref_row["max_rank_rhat"])
          <= SUITE_RHAT_MAX, "gibbs's nuts reference converged (split and "
          f"rank R-hat <= {SUITE_RHAT_MAX})")
    mean_gate("gibbs_hierarchical vs nuts reference", summ, ref_summ)
    return {"last": out.draws[-1]}


# phases 14-16's rows that run in worker processes, by name
WORKER_ROWS = {"rmhmc_fisher": row_rmhmc_fisher,
               "elliptical_latent_gp_64d": row_elliptical,
               "aees_mixture": row_aees_mixture,
               "gibbs_hierarchical": row_gibbs,
               "pt_mixture": row_pt_mixture}


def _numpy(tree):
    """Tensors of a dict (nested) as numpy arrays, to cross processes."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy() if torch.is_tensor(tree) else tree


def _row_worker(name, conn):
    """A worker process's body: row ``name`` of ``WORKER_ROWS`` on the card,
    its printed lines captured; sends ``(ok, lines, payload or the
    traceback, seconds)``."""
    import contextlib
    import io
    import traceback
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)   # six processes share the host's cores
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            payload = _numpy(WORKER_ROWS[name](torch.device("cuda")))
        conn.send((True, buf.getvalue(), payload, time.perf_counter() - t0))
    except Exception:   # noqa: BLE001 -- reported by the main process
        conn.send((False, buf.getvalue(), traceback.format_exc(),
                   time.perf_counter() - t0))
    finally:
        conn.close()


def start_row_workers():
    """One spawned process for each of ``WORKER_ROWS``, all started
    together; returns ``{name: (process, receiving end)}``."""
    import torch.multiprocessing as tmp
    ctx = tmp.get_context("spawn")
    workers = {}
    for name in WORKER_ROWS:
        recv, send = ctx.Pipe(duplex=False)
        proc = ctx.Process(target=_row_worker, args=(name, send),
                           daemon=True)
        proc.start()
        send.close()
        workers[name] = (proc, recv)
    return workers


def join_row_workers(workers, dev):
    """Wait for every worker row; print each one's lines under a heading
    with its seconds; raise if any failed. Returns ``{name: payload}``,
    arrays as tensors on ``dev``."""
    done, failed = {}, []
    deadline = time.perf_counter() + WORKER_TIMEOUT_S
    for name, (proc, recv) in workers.items():
        if not recv.poll(max(1.0, deadline - time.perf_counter())):
            raise RuntimeError(f"worker row {name} did not finish within "
                               f"{WORKER_TIMEOUT_S} s")
        try:
            ok, lines, payload, seconds = recv.recv()
        except EOFError:   # the worker died before it could report
            ok, lines, payload, seconds = False, "", "no report", 0.0
        proc.join()
        print(f"[worker process: {name}, {seconds:.1f} s, sharing the host "
              f"and the card with {len(workers) - 1} other worker rows and "
              "the main process's rows]")
        print(lines, end="")
        if ok:
            done[name] = {k: ({kk: torch.as_tensor(vv, device=dev)
                               for kk, vv in v.items()}
                              if isinstance(v, dict)
                              else torch.as_tensor(v, device=dev))
                          for k, v in payload.items()}
        else:
            failed.append(f"{name}:\n{payload}")
    check(not failed, "worker rows failed: " + "\n".join(failed))
    return done


def stop_row_workers(workers):
    """Stop any worker still running (after a failure in the main
    process)."""
    for proc, recv in workers.values():
        if proc.is_alive():
            proc.terminate()
        proc.join()
        recv.close()


def worker_rows_after(dev, refs, done):
    """What phases 14-16 take from their worker rows once they are done:
    rmhmc_fisher's means against rwmh_gaussian_2d's (gated) and against
    slice's and mMALA's and the closed form (printed: that row is biased);
    the ellipse's kernel-level sync audit and the ellipse's and Gibbs's
    kernels, generators and states at the rows' shapes from their last
    draws, for the profile."""
    from mcmc_tpu_torch import AlgoSettings
    from mcmc_tpu_torch.samplers import common
    from mcmc_tpu_torch.samplers.ellipse import build_elliptical_kernel
    from mcmc_tpu_torch.samplers.gibbs import (_make_blocks, _parse_blocks,
                                               build_gibbs_kernel)
    rm, rw, x2 = done["rmhmc_fisher"]["summ"], refs["rwmh"], refs["x2"]
    mean_gate("rmhmc_fisher vs rwmh_gaussian_2d", rm, rw)
    print(f"(mu, sigma): data mean {x2.mean():.4f}, sd {x2.std():.4f}; rwmh "
          f"{rw['mean'].tolist()}, rmhmc {rm['mean'].tolist()}")
    ms_exact, sl = refs["ms_exact"], refs["slice"]
    print(f"(mu, sigma) exact posterior mean {ms_exact['mean'].tolist()}: "
          f"slice {sl['mean'].tolist()}, rmhmc_fisher {rm['mean'].tolist()} "
          f"({mean_z(rm, ms_exact):.3f} of its MC standard errors from it); "
          f"slice vs rmhmc_fisher {mean_z(sl, rm):.3f} combined MC standard "
          "errors, printed, not gated: that row is biased")
    print(f"mmala_fisher {refs['mmala']['mean'].tolist()}: vs rmhmc_fisher "
          f"{mean_z(refs['mmala'], rm):.3f} combined MC standard errors, "
          "printed, not gated: that row is biased")
    gen = torch.Generator(device=dev).manual_seed(57)
    r = ELLIPSE_ROW
    _xs, K, lik = ellipse_model(dev)
    init, ell_step = build_elliptical_kernel(
        lik, torch.zeros(r["n"], device=dev),
        common.make_spd(K, r["n"], torch.float32, dev), 64)
    ell_state = loop_sync_audit(
        "elliptical_latent_gp_64d", ell_step, gen,
        init(done["elliptical_latent_gp_64d"]["last"]), "each draw: one "
        "sync a shrink step short of the cap, the chains' largest shrink "
        "count in evaluations")
    lk_gibbs, blocks, J = gibbs_model(dev)
    prob = common.setup_problem(done["gibbs_hierarchical"]["last"], lk_gibbs,
                                AlgoSettings(), None)
    init, gibbs_step = build_gibbs_kernel(
        _make_blocks(_parse_blocks(blocks, J + 2), prob, GIBBS_ROW["warm"]),
        prob)
    return (ell_step, gen, ell_state), (gibbs_step, gen,
                                         init(prob.first_draw))


def workflow_phase(X_np, y_np, ref):
    """Phase 17: the one-call workflow through ``fit`` on the flagship
    posterior, from numpy with no ``device=``."""
    from mcmc_tpu_torch import (compare, fit, generated_quantities,
                                map_laplace, pathfinder, pointwise_log_lik,
                                posterior_predictive, psis_loo, waic)
    from mcmc_tpu_torch.convert import glm_data
    from mcmc_tpu_torch.models import logistic_regression_model

    t_phase = time.perf_counter()
    Xd, yd = glm_data(X_np, y_np)
    lk = logistic_regression_model(Xd, yd, PRIOR_SCALE)

    def bernoulli_ll(X):
        def ll(p):
            eta = p @ X.T
            return yd * eta - torch.nn.functional.softplus(eta)
        return ll
    x0 = np.zeros(DIM, np.float32)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def fit_line(name, out, seconds, extra):
        summ = out.diagnostics["summary"]
        ess = float(summ["ess_bulk"].min())
        rhat = float(summ["rhat_rank"].max())
        row = {"seconds": seconds, "n_rounds": out.diagnostics["n_rounds"],
               "converged": bool(out.diagnostics["converged"]),
               "max_rank_rhat": rhat, "min_bulk_ess": ess,
               "draws": list(out.draws.shape), **extra}
        print(f"{name}: {json.dumps(row)}")
        check(out.draws.is_cuda, f"{name}: draws on the card")
        check(bool(torch.isfinite(out.draws).all()), f"{name}: draws finite")
        check(row["converged"], f"{name}: converged (rank R-hat {rhat:.4f} "
              f"<= {WF_NUTS['rhat']})")
        mean_gate(f"{name} vs hmc reference", summ, ref)
        return ess

    # (a) the default fit from a Pathfinder start; Pathfinder as fit calls
    # it, timed on its own first
    pf, pf_s = timed(lambda: pathfinder(x0, lk, n_draws=WF_PF_DRAWS,
                                        key=WF_NUTS["key"]))
    print(f"pathfinder: {pf_s:.3f} s, {pf.host_syncs} line-search host "
          f"syncs, chosen iterates {pf.best_iter.tolist()}, ELBO "
          f"{[round(v, 3) for v in pf.elbo.tolist()]}, pareto k "
          f"{float(pf.pareto_k):.3f}")
    check(bool(torch.isfinite(pf.draws).all()), "pathfinder draws finite")
    w = WF_NUTS
    out, secs = timed(lambda: fit(
        x0, lk, n_chains=w["chains"], n_warmup=w["warm"], n_draws=w["keep"],
        key=w["key"], init="pathfinder", rhat_target=w["rhat"],
        max_rounds=w["rounds"]))
    ess = out.diagnostics["summary"]["ess_bulk"].min()
    fit_line("fit nuts (pathfinder start)", out, secs, {
        "min_ess_per_sec_after_search": float(ess) / (secs - pf_s),
        "min_ess_per_sec_with_search": float(ess) / secs})

    # (b) Laplace at its defaults, then a Laplace-started ChEES fit
    lap, lap_s = timed(lambda: map_laplace(x0, lk, key=WF_CHEES["key"]))
    dev_sd = float(((lap.mode - ref["mean"]).abs() / ref["sd"]).max())
    print(f"map_laplace: {lap_s:.3f} s, grad_norm {float(lap.grad_norm):.4g} "
          f"(tol {WF_GRAD_NORM_MAX}), log_post {float(lap.log_post):.4f}, "
          f"max |mode - reference mean| / reference sd {dev_sd:.4f} (tol "
          f"{WF_MODE_SD_MAX})")
    check(float(lap.grad_norm) <= WF_GRAD_NORM_MAX, "map_laplace grad_norm")
    check(dev_sd <= WF_MODE_SD_MAX, "map_laplace mode near the posterior")
    w = WF_CHEES
    ch, secs = timed(lambda: fit(
        x0, lk, algorithm="chees", init="laplace", n_chains=w["chains"],
        n_warmup=w["warm"], n_draws=w["keep"], key=w["key"],
        rhat_target=w["rhat"], max_rounds=w["rounds"]))
    fit_line("fit chees (laplace start)", ch, secs, {})

    # (c) the posterior predictive of the outcomes over (a)'s last draws of
    # its first chains, in chunks
    d = out.draws[-WF_PP["draws"]:, :WF_PP["chains"]]
    n_draws = d.shape[0] * d.shape[1]
    prob = lambda p: torch.sigmoid(p @ Xd.T)
    (gq, yrep), pp_s = timed(lambda: (
        generated_quantities(d, prob, batch_size=WF_PP["batch"]),
        posterior_predictive(
            d, lambda g, p: torch.bernoulli(prob(p), generator=g),
            key=WF_PP["key"], batch_size=WF_PP["batch"])))
    check(tuple(yrep.shape) == (d.shape[0], d.shape[1], N_DATA),
          "posterior predictive shape")
    p_bar = float(gq.double().mean())
    y_bar = float(yrep.double().mean())
    se = math.sqrt(float((gq.double() * (1 - gq.double())).mean())
                   / gq.numel())
    t_rep = yrep.mean(dim=-1)
    p_value = float((t_rep >= float(yd.mean())).double().mean())
    print(f"posterior predictive: {n_draws} draws x {N_DATA} outcomes in "
          f"{pp_s:.3f} s; mean replicated outcome {y_bar:.6f}, mean fitted "
          f"probability {p_bar:.6f}, {abs(y_bar - p_bar) / se:.3f} binomial "
          f"standard errors (tol {WF_PP_SIGMAS:g}); predictive p-value of "
          f"mean(y) {p_value:.4f}")
    check(abs(y_bar - p_bar) <= WF_PP_SIGMAS * se,
          "replicated outcomes match the fitted probabilities")

    # (d) PSIS-LOO and WAIC, the card against the port on the CPU, and a
    # reduced model ranked by compare()
    ll = pointwise_log_lik(d, bernoulli_ll(Xd))
    (loo, wa), loo_s = timed(lambda: (psis_loo(ll), waic(ll)))
    t0 = time.perf_counter()
    loo_cpu = psis_loo(ll.cpu())
    cpu_s = time.perf_counter() - t0
    k_max = float(loo["pareto_k"].max())
    gap = abs(float(loo["elpd"]) - float(wa["elpd"]))
    cpu_err = max(abs(float(loo[k]) - float(loo_cpu[k]))
                  / abs(float(loo_cpu[k])) for k in ("elpd", "p_eff", "se"))
    k_err = float((loo["pareto_k"].cpu() - loo_cpu["pareto_k"]).abs().max())
    print(f"psis_loo + waic on the card: {loo_s:.3f} s ({cpu_s:.3f} s for "
          f"psis_loo on the CPU); elpd_loo {float(loo['elpd']):.4f} (se "
          f"{float(loo['se']):.4f}, p_loo {float(loo['p_eff']):.4f}), "
          f"elpd_waic {float(wa['elpd']):.4f}, |difference| {gap:.4f} (tol "
          f"{WF_LOO_WAIC_MAX}); max Pareto k {k_max:.4f} (tol "
          f"{WF_PARETO_K_MAX}); card vs CPU: max relative error {cpu_err:.2e}"
          f", max |k difference| {k_err:.2e}")
    check(k_max <= WF_PARETO_K_MAX, "every Pareto k within 0.7")
    check(gap <= WF_LOO_WAIC_MAX, "elpd_loo and elpd_waic agree")
    check(cpu_err <= 1e-5 and k_err <= 2e-5,
          "psis_loo on the card equals the CPU's (rtol 1e-5, k 2e-5)")
    w = WF_REDUCED
    lk_red = logistic_regression_model(Xd[:, :w["cols"]], yd, PRIOR_SCALE)
    red, secs = timed(lambda: fit(
        np.zeros(w["cols"], np.float32), lk_red, algorithm="chees",
        n_chains=WF_CHEES["chains"], n_warmup=WF_CHEES["warm"],
        n_draws=WF_CHEES["keep"], key=w["key"]))
    check(bool(torch.isfinite(red.draws).all()), "reduced fit draws finite")
    ll_red = pointwise_log_lik(red.draws[-WF_PP["draws"]:, :WF_PP["chains"]],
                               bernoulli_ll(Xd[:, :w["cols"]]))
    ranking = compare({"full": loo, "reduced": psis_loo(ll_red)})
    print(f"compare: reduced chees fit {secs:.3f} s; "
          f"{json.dumps(ranking)}")
    diff = ranking[1]["elpd_diff"]
    print(f"compare: elpd_diff {diff:.4f} = {diff / ranking[1]['se_diff']:.3f}"
          f" paired standard errors; JAX {WF_DIFF_JAX} (tol {WF_DIFF_TOL})")
    check(ranking[0]["name"] == "full", "the full model ranks first")
    check(abs(diff - WF_DIFF_JAX) <= WF_DIFF_TOL,
          "the reduced model's elpd_diff agrees with the JAX package's")
    print(f"workflow: phase seconds {time.perf_counter() - t_phase:.1f}")



_DUR_CHILD = """
import os, signal, sys
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
from mcmc_tpu_torch import checkpoint
sys.path.insert(0, os.path.dirname(sys.argv[2]))
from chip_smoke import durability_run
orig, n = checkpoint.DrawSink.append, [0]
def killing(self, arr):
    orig(self, arr)
    n[0] += 1
    if n[0] >= int(sys.argv[3]):
        self.flush()
        os.kill(os.getpid(), signal.SIGKILL)
checkpoint.DrawSink.append = killing
durability_run(sys.argv[1])
"""


def durability_run(checkpoint_dir=None):
    """Phase 18 (d)'s ``hmc`` run on the flagship posterior, from numpy with
    no ``device=`` (in memory, or checkpointed into ``checkpoint_dir``)."""
    from mcmc_tpu_torch import HMCSettings, hmc
    from mcmc_tpu_torch.models import (logistic_regression_model,
                                       make_logistic_regression_data)
    X, y, _ = make_logistic_regression_data(0, N_DATA, DIM)
    s = HMCSettings(n_burnin_draws=DUR["burnin"], n_keep_draws=DUR["keep"],
                    step_size=DUR["step"], n_leap_steps=DUR["leap"])
    init = 0.05 * np.random.default_rng(DUR["key"]).standard_normal(
        (DUR["chains"], DIM)).astype(np.float32)
    return hmc(init, logistic_regression_model(X, y, PRIOR_SCALE), s,
               key=DUR["key"], checkpoint_dir=checkpoint_dir,
               checkpoint_every=DUR["every"])


def evidence_phase(X_np, y_np, ref):
    """Phase 18: evidence, approximate inference and durability, each entry
    point from numpy with no ``device=``, each step timed by the port's
    ``PhaseTimer``."""
    import os
    import shutil
    from mcmc_tpu_torch import (AlgoSettings, EvidenceSettings, advi,
                                map_laplace, nested_sampling, svgd,
                                thermo_evidence)
    from mcmc_tpu_torch.convert import glm_data
    from mcmc_tpu_torch.observability import PhaseTimer

    t_phase = time.perf_counter()
    timer = PhaseTimer()
    Xd, yd = glm_data(X_np, y_np)
    c_prior = 0.5 * DIM * math.log(2 * math.pi * PRIOR_SCALE ** 2)
    log_prior = lambda b: -0.5 * (b * b).sum(-1) / PRIOR_SCALE ** 2 - c_prior

    def log_lik(b):
        eta = b @ Xd.T
        return (yd * eta - torch.nn.functional.softplus(eta)).sum(-1)
    log_post = lambda b: log_prior(b) + log_lik(b)
    x0 = np.zeros(DIM, np.float32)

    def ev_settings(cfg):
        return AlgoSettings(evidence_settings=EvidenceSettings(
            n_burnin_draws=cfg["burnin"], n_keep_draws=cfg["keep"],
            n_temps=cfg["n_temps"]))

    # (a) evidence at full width
    with timer.phase("thermo_evidence", sync=True):
        ev = thermo_evidence(x0, log_prior, log_lik, ev_settings(EV_FLAG),
                             n_chains=EV_FLAG["chains"], key=EV_FLAG["key"])
    with timer.phase("map_laplace", sync=True):
        lap = map_laplace(x0, log_post, key=EV_FLAG["key"])
    ss, se = float(ev.log_z), float(ev.log_z_se)
    z_jax = abs(ss - EV_SS_JAX) / math.hypot(se, EV_SS_SE_JAX)
    acc_min = float(ev.accept_rate.min())
    swap_min = float(ev.swap_accept_rate.min())
    rows = EV_FLAG["chains"] * EV_FLAG["n_temps"]
    print(f"thermo_evidence (flagship, {EV_FLAG['chains']} ladders x "
          f"{EV_FLAG['n_temps']} rungs = {rows} rows, {EV_FLAG['burnin']} + "
          f"{EV_FLAG['keep']} draws, cut from 1000 + 1000): "
          f"{timer.timings['thermo_evidence']:.3f} s, "
          f"{1e3 * timer.timings['thermo_evidence'] / (EV_FLAG['burnin'] + EV_FLAG['keep']):.3f}"
          f" ms a draw; SS {ss:.4f} +- {se:.4f}, TI {float(ev.log_z_ti):.4f} "
          f"+- {float(ev.log_z_ti_se):.4f}, Laplace {float(lap.log_evidence):.4f}"
          f" ({timer.timings['map_laplace']:.3f} s); JAX SS {EV_SS_JAX} +- "
          f"{EV_SS_SE_JAX}: {z_jax:.3f} combined standard errors (tol "
          f"{EV_SIGMAS:g}, margin {EV_SIGMAS - z_jax:.3f}); per-rung accept "
          f">= {acc_min:.4f} (tol {EV_ACCEPT_MIN}), swap >= {swap_min:.4f} "
          f"(tol {EV_SWAP_MIN}); adapted steps {float(ev.step_sizes[0]):.4f}"
          f"..{float(ev.step_sizes[-1]):.4f}")
    check(math.isfinite(ss) and math.isfinite(se), "evidence finite")
    check(z_jax <= EV_SIGMAS, "SS within 5 combined standard errors of JAX's")
    check(acc_min > EV_ACCEPT_MIN, "every rung accepts above 0.2")
    check(swap_min > EV_SWAP_MIN, f"every pair swaps above {EV_SWAP_MIN}")

    # (b) ADVI and SVGD on the same posterior, and their host syncs
    approx = {}
    for name in APPROX_KEYS:
        key = APPROX_KEYS[name]
        if name == "svgd":
            run = lambda n=None: svgd(x0, log_post,
                                      n_particles=SVGD_PARTICLES, key=key,
                                      **({} if n is None else {"n_steps": n}))
        else:
            fr = name == "advi_full_rank"
            run = lambda n=None, fr=fr: advi(
                x0, log_post, full_rank=fr, key=key,
                **({} if n is None else {"n_steps": n}))
        with timer.phase(name, sync=True):
            out = run()
        syncs = [sync_warnings(lambda: run(n))[0] for n in APPROX_SYNC_STEPS]
        mean = out.particles.mean(0) if name == "svgd" else out.mean
        dev = float(((mean - ref["mean"]).abs() / ref["sd"]).max())
        tol = APPROX_DEV_MAX[name]
        line = {"seconds": timer.timings[name], "max_mean_dev_sd": dev,
                "tol": tol, "syncs_at_steps": dict(zip(APPROX_SYNC_STEPS,
                                                       syncs))}
        if name != "svgd":
            elbo = float(out.elbo)
            tail = out.elbo_trace[-out.elbo_trace.shape[0] // 20:]
            se_elbo = float(tail.std()) / math.sqrt(tail.shape[0])
            se_diff = math.hypot(se, se_elbo)
            line.update(elbo=elbo, elbo_se=se_elbo,
                        elbo_minus_log_z_se=(elbo - ss) / se_diff,
                        elbo_margin_se=EV_ELBO_SE - (elbo - ss) / se_diff,
                        elbo_minus_ti=elbo - float(ev.log_z_ti))
        else:
            line["bandwidth"] = float(out.bandwidth)
        print(f"{name}: {json.dumps(line)}")
        if name != "svgd":
            check(elbo <= ss + EV_ELBO_SE * se_diff,
                  f"{name}: ELBO at most log Z + {EV_ELBO_SE:g} SE")
        check(bool(torch.isfinite(mean).all()), f"{name}: mean finite")
        check(dev <= tol, f"{name}: mean within {tol} sd of the reference")
        check(syncs[0] == syncs[1], f"{name}: no host sync per step")
        approx[name] = line

    # (c) the closed-form models of examples/evidence_bayes_factor.py
    rng = np.random.default_rng(0)
    xp = rng.standard_normal(POLY_N)
    yp = 0.5 + 1.2 * xp + 0.8 * xp ** 2 + 0.5 * rng.standard_normal(POLY_N)
    xp, yp = xp.astype(np.float32), yp.astype(np.float32)
    ypt = torch.from_numpy(yp).to(Xd.device)
    log_zs = {}
    for name, degree in (("linear", 1), ("quadratic", 2)):
        F64 = np.stack([xp.astype(np.float64) ** k
                        for k in range(degree + 1)], 1)
        cov = POLY_SIG2 * np.eye(POLY_N) + POLY_PRIOR_VAR * F64 @ F64.T
        y64 = yp.astype(np.float64)
        exact = float(-0.5 * (POLY_N * math.log(2 * math.pi)
                              + np.linalg.slogdet(cov)[1]
                              + y64 @ np.linalg.solve(cov, y64)))
        F = torch.from_numpy(F64.astype(np.float32)).to(Xd.device)
        d = degree + 1
        lp = lambda t: (-0.5 * t * t / POLY_PRIOR_VAR - 0.5 * math.log(
            2 * math.pi * POLY_PRIOR_VAR)).sum(-1)
        ll = lambda t, F=F: (-0.5 * (ypt - t @ F.T) ** 2 / POLY_SIG2 - 0.5
                             * math.log(2 * math.pi * POLY_SIG2)).sum(-1)
        with timer.phase(f"thermo_{name}", sync=True):
            r = thermo_evidence(np.zeros(d, np.float32), lp, ll,
                                ev_settings(EV_POLY),
                                n_chains=EV_POLY["chains"],
                                key=EV_POLY["key"])
        with timer.phase(f"nested_{name}", sync=True):
            ns = nested_sampling(
                lambda u: math.sqrt(POLY_PRIOR_VAR) * torch.special.ndtri(u),
                ll, d, n_live=NS_LIVE, key=NS_KEY)
        with timer.phase(f"laplace_{name}", sync=True):
            la = map_laplace(np.zeros(d, np.float32),
                             lambda t, ll=ll: lp(t) + ll(t), n_steps=600,
                             learning_rate=0.1, key=EV_POLY["key"])
        ss_p, se_p = float(r.log_z), float(r.log_z_se)
        ns_z, ns_err = float(ns.log_z), float(ns.log_z_err)
        la_z = float(la.log_evidence)
        log_zs[name] = ss_p
        print(f"{name} model (exact log Z {exact:.4f}): thermo SS {ss_p:.4f} "
              f"+- {se_p:.4f} ({EV_POLY['burnin']} + {EV_POLY['keep']} draws, "
              f"cut from 800 + 800; {abs(ss_p - exact) / se_p:.3f} SE, tol "
              f"{EV_SIGMAS:g}, margin {EV_SIGMAS - abs(ss_p - exact) / se_p:.3f}"
              f"; {timer.timings[f'thermo_{name}']:.3f} s), TI "
              f"{float(r.log_z_ti):.4f}; nested {ns_z:.4f} +- {ns_err:.4f} "
              f"({abs(ns_z - exact) / ns_err:.3f} error bars, tol "
              f"{NS_SIGMAS:g}; {ns.n_rounds} rounds, "
              f"{ns.host_syncs / ns.n_rounds:.3f} host syncs a round, "
              f"{timer.timings[f'nested_{name}']:.3f} s); Laplace "
              f"{la_z:.5f} (|error| {abs(la_z - exact):.2e}, tol "
              f"{LAPLACE_EV_TOL:g}; {timer.timings[f'laplace_{name}']:.3f} s)")
        check(abs(ss_p - exact) <= EV_SIGMAS * se_p,
              f"{name}: thermo_evidence within 5 SE of the exact log Z")
        check(ns.converged and abs(ns_z - exact) <= NS_SIGMAS * ns_err,
              f"{name}: nested sampling within 3 error bars")
        check(abs(la_z - exact) <= LAPLACE_EV_TOL,
              f"{name}: the Laplace evidence within {LAPLACE_EV_TOL:g}")
    log_bf = log_zs["quadratic"] - log_zs["linear"]
    print(f"log Bayes factor, quadratic over linear: {log_bf:.4f}")
    check(log_bf > 0, "the Bayes factor favours the quadratic model")

    # (d) durability on the card
    root = os.path.join("chiprun_out", "phase18_checkpoint")
    shutil.rmtree(root, ignore_errors=True)
    with timer.phase("hmc_in_memory", sync=True):
        plain = durability_run()
    with timer.phase("hmc_checkpointed", sync=True):
        ck = durability_run(os.path.join(root, "a"))
    n_bytes = plain.draws.numel() * plain.draws.element_size()
    same = torch.equal(ck.draws, plain.draws.cpu())
    # the accept counts (the rates divide on the card by a reciprocal)
    same_rate = torch.equal(ck.n_accept_draws,
                            plain.n_accept_draws.cpu())
    from mcmc_tpu_torch.checkpoint import DrawSink
    with DrawSink(os.path.join(root, "probe.bin"), (1,)) as probe:
        native = probe.native
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", _DUR_CHILD, os.path.join(root, "b"),
         os.path.abspath(__file__), str(DUR_KILL_AFTER)],
        capture_output=True, text=True, timeout=300)
    t_child = time.perf_counter() - t0
    with timer.phase("hmc_resumed", sync=True):
        resumed = durability_run(os.path.join(root, "b"))
    same_resumed = torch.equal(resumed.draws, plain.draws.cpu())
    # pinned device-to-host bandwidth, in this process
    src = plain.draws.reshape(-1)
    dst = torch.empty(src.shape, dtype=src.dtype, pin_memory=src.is_cuda)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    bw = n_bytes / sorted(times)[1]
    t_c, t_k = timer.timings["hmc_in_memory"], timer.timings["hmc_checkpointed"]
    tax = max(t_c, n_bytes / bw) / t_k
    print(f"durability: hmc {DUR['chains']} chains, {DUR['burnin']} + "
          f"{DUR['keep']} draws of {DUR['leap']} leapfrogs, "
          f"{n_bytes / 1e6:.1f} MB of draws, checkpoint every {DUR['every']}"
          f": in memory {t_c:.3f} s, checkpointed {t_k:.3f} s, bit-equal "
          f"{same} (accept counts {same_rate}); the sink native {native}; child "
          f"killed with SIGKILL after {DUR_KILL_AFTER} chunks (exit "
          f"{child.returncode}, {t_child:.3f} s), resumed here in "
          f"{timer.timings['hmc_resumed']:.3f} s, bit-equal {same_resumed}; "
          f"pinned D2H {bw / 1e9:.2f} GB/s; durability tax max(t_compute, "
          f"bytes / D2H) / t_checkpointed = {tax:.4f}")
    shutil.rmtree(root, ignore_errors=True)
    check(same and same_rate, "checkpointed hmc bit-equal to in-memory")
    check(native, "the draw sink is native")
    check(child.returncode == -signal.SIGKILL,
          f"the child was killed ({child.returncode}): {child.stderr[-600:]}")
    check(same_resumed, "the SIGKILLed run resumed bit-equal")
    seconds = time.perf_counter() - t_phase
    print(f"evidence and durability: phase seconds {seconds:.1f} (budget "
          f"{EV_PHASE_BUDGET_S:g}); PhaseTimer {json.dumps(timer.timings)}")
    return approx


# what was cut to hold the script's time when phase 20 joined it, (before,
# after) of each; every row or line prints its margin under its gate (the
# profiles are not gated)
MESH_CUTS = {"nuts4096 keep": (500, NUTS_BIG_KEEP),
             "mams and mclmc keep": (500, MC_KEEP),
             "slice_gaussian_2d warm, keep": ((500, 1000), (250, 500)),
             "mmala_fisher warm, keep": ((500, 1000), (250, 500)),
             "mala_logreg_25d hmc reference keep": (1000, 500),
             "sgld lines warm, keep": ((2000, 4000), (1000, 2000)),
             "sgld full-data hmc reference keep": (1000, 500),
             "profiles' steady transitions": ("quarter", "eighth")}


# phase 20: multi-device sampling (mcmc_tpu_torch.parallel) on the one card.
# (a) a world of one under NCCL, bit-equal to no mesh: NUTS at phase 9's
# settings but MESH_NUTS_WARM + MESH_NUTS_KEEP draws, and the flagship hmc
# (phase 9's reference's step and mass) for MESH_HMC_TRANS transitions;
# (b) two ranks sharing the card over Gloo (NCCL refuses two ranks on one
# card), spawned here, each line's global statistics equal on both ranks
# and its means within NUTS_MEAN_SIGMAS combined MC standard errors of its
# reference (phase 9's hmc reference on the flagship; the exact 0 of
# phase 14's and 15's mixture and correlated rows); (c) the eleven paths of
# entry.dryrun_multichip(2). Budget MESH_PHASE_BUDGET_S, printed beside the
# phase's seconds
MESH_PHASE_BUDGET_S = 90.0
MESH_NUTS_CHAINS, MESH_NUTS_WARM, MESH_NUTS_KEEP = 1024, 100, 200
MESH_HMC_CHAINS, MESH_HMC_TRANS = 16384, 50
# (b)'s lines: every rank runs the whole batch's settings, half the chains
MESH_RANKS = 2
MESH_LINES = {
    # the flagship through chain-sharded hmc, 2 x 8192 chains from the hmc
    # reference's Gaussian (its mean and sd), the reference's step and mass
    "hmc": {"chains": 16384, "warm": 20, "keep": 60},
    # pooled NUTS, 2 x 512 chains from the same starts
    "nuts": {"chains": 1024, "warm": 80, "keep": 80},
    # de_mixture's target (phase 14), stretch_correlated's (phase 15),
    # smc_mixture's (phase 15), population-sharded
    "de": {"n_pop": 256, "warm": 200, "keep": 400},
    "stretch": {"n_walkers": 256, "warm": 200, "keep": 400},
    "smc": {"particles": 16384, "mcmc": 5, "init_scale": 4.0},
    # two-rung ladders on de_mixture's target
    "pt_sharded": {"temp": 8.0, "warm": 200, "keep": 600},
    "aees_sharded": {"temp": 8.0, "block": 200, "keep": 1200},
    # the flagship kernel on a (1, 2) grid: value and gradient at 16 points
    "data_parallel": {"points": 16, "tol": 2e-5},
}


def _mixture_target(dev):
    from mcmc_tpu_torch.models import gaussian_mixture_model
    return gaussian_mixture_model(np.array([[-2.0, -2.0], [2.0, 2.0]]),
                                  np.array([0.5, 0.5]), np.array([0.5, 0.5]),
                                  device=dev)


def _batch_summary(d):
    """Each dimension's mean and MC standard error by 20 batch means over
    the draw axis (a single chain: the ladder samplers' cold chain)."""
    d = d.double()
    b = d.reshape(20, -1, d.shape[-1]).mean(1)
    return {"mean": d.reshape(-1, d.shape[-1]).mean(0),
            "mcse": b.std(0) / math.sqrt(20)}


def _chain_summary(d):
    from mcmc_tpu_torch import diagnostics
    ess = diagnostics.ess(d, chain_chunk=256 if d.shape[1] % 256 == 0
                          else None)
    return {"mean": d.mean(dim=(0, 1)).double(),
            "mcse": (d.std(dim=(0, 1)) / torch.sqrt(ess)).double()}


def mesh_rank_main(path):
    """One rank of phase 20 (b): ``python chip_smoke.py --mesh-rank FILE``
    under :func:`mcmc_tpu_torch.parallel.launch_local`. Joins a Gloo group
    (the card shared with the other rank), runs every line of
    ``MESH_LINES`` through the entry points on a mesh of both ranks and
    prints one JSON line: each line's global statistics, seconds and
    collectives per draw."""
    import mcmc_tpu_torch as mt
    from mcmc_tpu_torch import parallel as par
    from mcmc_tpu_torch.models import logistic_regression_model
    from mcmc_tpu_torch.parallel import mesh as mesh_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    par.init_distributed(backend="gloo", timeout_s=300)
    dev = torch.device("cuda")
    inp = torch.load(path, map_location=dev)
    X = inp["X"].to(dev)
    y = inp["y"].to(dev)
    lk = logistic_regression_model(X, y, PRIOR_SCALE)
    mesh = par.make_mesh()
    out, timing = {}, {}

    def line(name, fn, n_draws):
        for k in mesh_mod.COUNTS:
            mesh_mod.COUNTS[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        timing[name] = {"seconds": time.perf_counter() - t0,
                        "collectives_per_draw": {
                            k: v / n_draws
                            for k, v in mesh_mod.COUNTS.items()}}
        return r

    def summ(name, s, extra=None):
        out[name] = {"mean": s["mean"].tolist(), "mcse": s["mcse"].tolist(),
                     **(extra or {})}

    gen = torch.Generator(device=dev).manual_seed(200)
    ref_mean, ref_sd = inp["ref_mean"], inp["ref_sd"]
    c = MESH_LINES["hmc"]
    starts = ref_mean + ref_sd * torch.randn((c["chains"], DIM),
                                             generator=gen, device=dev)
    hs = mt.HMCSettings(n_burnin_draws=c["warm"], n_keep_draws=c["keep"],
                        step_size=inp["ref_step"], n_leap_steps=REF_LEAP,
                        precond_mat=1.0 / inp["inv_mass"])
    r = line("hmc", lambda: mt.hmc(starts, lk, hs, key=201, mesh=mesh),
             c["warm"] + c["keep"])
    summ("hmc", _chain_summary(r.draws),
         {"accept": float(r.accept_rate.mean())})
    del r, starts

    c = MESH_LINES["nuts"]
    starts = ref_mean + ref_sd * torch.randn((c["chains"], DIM),
                                             generator=gen, device=dev)
    ns = mt.NUTSSettings(n_burnin_draws=c["warm"], n_keep_draws=c["keep"],
                         n_adapt_draws=c["warm"],
                         target_accept_rate=NUTS_TARGET_ACCEPT)
    r = line("nuts", lambda: mt.nuts(starts, lk, ns, key=202, mesh=mesh,
                                     pooled_adaptation=True,
                                     adapt_mass_matrix=True),
             c["warm"] + c["keep"])
    step = r.diagnostics["step_size"][-1]
    im = r.diagnostics["inv_mass_diag"]
    summ("nuts", _chain_summary(r.draws), {
        "step_size": float(step[0]),
        "pooled_equal": bool((step == step[0]).all()
                             and (im == im[0]).all())})
    del r, starts

    lk_mix = _mixture_target(dev)
    c = MESH_LINES["de"]
    box = np.full(2, 4.0)
    r = line("de", lambda: mt.de(np.zeros(2), lk_mix, mt.DESettings(
        n_pop=c["n_pop"], n_burnin_draws=c["warm"], n_keep_draws=c["keep"],
        initial_lb=-box, initial_ub=box), key=203, mesh=mesh, device=dev),
        c["warm"] + c["keep"])
    summ("de", _chain_summary(r.draws), {
        "mode_share": float((r.draws[..., 0] > 0).float().mean())})

    c = MESH_LINES["stretch"]
    cov = torch.tensor([[1.0, 0.95], [0.95, 1.0]], device=dev)
    prec = torch.linalg.inv(cov)
    lk_corr = lambda v: -0.5 * (v * (v @ prec)).sum(-1)
    r = line("stretch", lambda: mt.stretch(
        torch.zeros(2, device=dev), lk_corr, mt.StretchSettings(
            n_walkers=c["n_walkers"], n_burnin_draws=c["warm"],
            n_keep_draws=c["keep"]), key=204, mesh=mesh),
        c["warm"] + c["keep"])
    summ("stretch", _chain_summary(r.draws))

    c = MESH_LINES["smc"]
    r = line("smc", lambda: mt.smc(torch.zeros(2, device=dev), lk_mix,
                                   mt.SMCSettings(
                                       n_particles=c["particles"],
                                       n_mcmc_steps=c["mcmc"],
                                       init_scale=c["init_scale"]),
                                   key=205, mesh=mesh), 1)
    d = r.draws.double()
    summ("smc", {"mean": d.mean(0), "mcse": d.std(0) / math.sqrt(d.shape[0])},
         {"log_z": float(r.diagnostics["log_z"]),
          "mode_share": float((d[:, 0] > 0).double().mean()),
          "stages": int(r.diagnostics["n_stages"])})
    # SMC's collectives a stage
    timing["smc"]["collectives_per_draw"] = {
        k: v / max(out["smc"]["stages"], 1)
        for k, v in timing["smc"]["collectives_per_draw"].items()}

    c = MESH_LINES["pt_sharded"]
    r = line("pt_sharded", lambda: par.pt_sharded(
        torch.zeros(2, device=dev), lk_mix, mt.PTSettings(
            n_burnin_draws=c["warm"], n_keep_draws=c["keep"],
            temper_vec=[c["temp"]], inner="hmc", step_size=0.3,
            n_leap_steps=5), mesh=mesh, key=206), c["warm"] + c["keep"])
    summ("pt_sharded", _batch_summary(r.draws), {
        "swap": r.diagnostics["swap_accept_rate"].tolist(),
        "mode_share": float((r.draws[:, 0] > 0).float().mean())})

    c = MESH_LINES["aees_sharded"]
    r = line("aees_sharded", lambda: par.aees_sharded(
        torch.zeros(2, device=dev), lk_mix, mt.AEESSettings(
            n_initial_draws=c["block"] // 2, n_burnin_draws=c["block"] // 2,
            n_keep_draws=c["keep"], n_rings=5, ee_prob_par=0.1,
            temper_vec=[c["temp"]], cov_mat=0.5 * np.eye(2)),
        mesh=mesh, key=207), 2 * c["block"] + c["keep"])
    summ("aees_sharded", _batch_summary(r.draws), {
        "mode_share": float((r.draws[:, 0] > 0).float().mean())})

    c = MESH_LINES["data_parallel"]
    grid = par.make_grid_mesh(1, 2)

    def kernel_of_data(beta, data):
        Xa, ya = data
        eta = beta @ Xa.T
        ll = (ya * eta - torch.nn.functional.softplus(eta)).sum(-1)
        return ll - 0.5 * (beta * beta).sum(-1) / PRIOR_SCALE ** 2

    pts = ref_mean + ref_sd * torch.randn((c["points"], DIM), generator=gen,
                                          device=dev)
    dp = par.data_parallel_kernel(kernel_of_data, (X, y), grid)

    def value_grad(f):
        b = pts.clone().requires_grad_(True)
        v = f(b)
        (g,) = torch.autograd.grad(v.sum(), b)
        return v.detach(), g

    v1, g1 = line("data_parallel", lambda: value_grad(dp), 1)
    v0, g0 = value_grad(lambda b: kernel_of_data(b, (X, y)))
    out["data_parallel"] = {
        "value_err": float(((v1 - v0).abs() / v0.abs().max()).max()),
        "grad_err": float(((g1 - g0).abs() / g0.abs().max()).max()),
        "value_checksum": float(v1.double().sum())}
    print(json.dumps({"rank": torch.distributed.get_rank(), "lines": out,
                      "timing": timing}))
    torch.distributed.destroy_process_group()
    return 0


def mesh_phase(X_np, y_np, ref, nuts_state):
    """Phase 20 (see the constants above): (a) a world of one under NCCL,
    (b) two Gloo ranks sharing the card, (c) ``dryrun_multichip(2)``."""
    import os
    import mcmc_tpu_torch as mt
    from mcmc_tpu_torch import parallel as par
    from mcmc_tpu_torch.entry import dryrun_multichip
    from mcmc_tpu_torch.models import logistic_regression_model
    from mcmc_tpu_torch.parallel import mesh as mesh_mod

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    X = torch.as_tensor(X_np, device=dev)
    y = torch.as_tensor(y_np, device=dev)
    lk = logistic_regression_model(X, y, PRIOR_SCALE)

    # (a) a world of one under NCCL: one all-reduce, then bit-equality
    mesh = par.make_mesh()
    backend = torch.distributed.get_backend()
    ax = mesh_mod.mesh_axis(mesh, "chains")
    one = mesh_mod.all_reduce(torch.ones(3, device=dev), ax.group)
    check(backend == "nccl" and bool((one == 1).all()),
          f"(a) a world of one under {backend}, its all-reduce the identity")
    gen = torch.Generator(device=dev).manual_seed(210)
    starts = NUTS_INIT_SCALE * torch.randn((MESH_NUTS_CHAINS, DIM),
                                           generator=gen, device=dev)
    ns = mt.NUTSSettings(n_burnin_draws=MESH_NUTS_WARM,
                         n_keep_draws=MESH_NUTS_KEEP,
                         n_adapt_draws=MESH_NUTS_WARM,
                         target_accept_rate=NUTS_TARGET_ACCEPT)
    step = REF_STEP_FRACTION * float(nuts_state.epsilon_bar[0])
    inv_mass = nuts_state.inv_mass[0]
    hs = mt.HMCSettings(n_burnin_draws=0, n_keep_draws=MESH_HMC_TRANS,
                        step_size=step, n_leap_steps=REF_LEAP,
                        precond_mat=1.0 / inv_mass)
    hstarts = nuts_state.position.repeat(
        MESH_HMC_CHAINS // nuts_state.position.shape[0], 1)
    runs = {
        "nuts": lambda m: mt.nuts(starts, lk, ns, key=211, mesh=m,
                                  pooled_adaptation=True,
                                  adapt_mass_matrix=True),
        "hmc": lambda m: mt.hmc(hstarts, lk, hs, key=212, mesh=m)}
    for name, run in runs.items():
        secs = []
        draws = []
        for m in (None, mesh):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = run(m)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            draws.append(r.draws)
        equal = bool(torch.equal(draws[0], draws[1]))
        print(f"mesh (a) {name}: {tuple(draws[0].shape)} draws, no mesh "
              f"{secs[0]:.3f} s, a mesh of one under NCCL {secs[1]:.3f} s "
              f"({secs[1] / secs[0]:.3f}x); bit-equal: {equal}")
        check(equal, f"(a) {name}: a mesh of one bit-equal to no mesh")
        del draws, r

    # (b) two ranks sharing the card over Gloo
    os.makedirs("build", exist_ok=True)
    path = os.path.join("build", "mesh_phase_inputs.pt")
    torch.save({"X": X.cpu(), "y": y.cpu(), "ref_mean": ref["mean"].cpu(),
                "ref_sd": ref["sd"].cpu(), "inv_mass": inv_mass.cpu(),
                "ref_step": step}, path)
    t0 = time.perf_counter()
    try:
        ranks = par.launch_local(MESH_RANKS, [__file__, "--mesh-rank", path],
                                 timeout_s=240)
    finally:
        os.remove(path)
    t_b = time.perf_counter() - t0
    lines = [r["lines"] for r in ranks]
    for i, other in enumerate(lines[1:], 1):
        diff = [k for k in lines[0] if lines[0][k] != other.get(k)]
        check(not diff, f"(b) ranks 0 and {i} report the same global "
              f"statistics (differ: {diff})")
    res = lines[0]
    as_t = lambda v: torch.tensor(v, dtype=torch.float64)
    refs = {"hmc": ref, "nuts": ref}
    zero = {"mean": torch.zeros(2, dtype=torch.float64),
            "mcse": torch.zeros(2, dtype=torch.float64)}
    for name, t in ranks[0]["timing"].items():
        if name == "data_parallel":
            continue
        r = res[name]
        want = refs.get(name, zero)
        z = float(((as_t(r["mean"]) - want["mean"].double().cpu()).abs()
                   / torch.hypot(as_t(r["mcse"]),
                                 want["mcse"].double().cpu())).max())
        extra = {k: v for k, v in r.items() if k not in ("mean", "mcse")}
        print(f"mesh (b) {name}: {t['seconds']:.3f} s; collectives per "
              f"draw {json.dumps(t['collectives_per_draw'])}; max |mean - "
              f"reference| / combined MC standard error {z:.3f} (tol "
              f"{NUTS_MEAN_SIGMAS:g}); {json.dumps(extra)}")
        check(z <= NUTS_MEAN_SIGMAS, f"(b) {name}: means within "
              f"{NUTS_MEAN_SIGMAS:g} combined MC standard errors of the "
              "reference")
    check(res["nuts"]["pooled_equal"], "(b) nuts: one pooled step size and "
          "mass on every chain of both ranks")
    check(abs(res["smc"]["log_z"]) < 0.1 and abs(
        res["smc"]["mode_share"] - 0.5) < 0.05, "(b) smc: |log Z| < 0.1 and "
          "mode share within 0.05 of 1/2")
    for name in ("pt_sharded", "aees_sharded", "de"):
        share = res[name]["mode_share"]
        check(0.15 < share < 0.85, f"(b) {name}: both modes visited "
              f"(share {share:.3f})")
    dp = res["data_parallel"]
    tol = MESH_LINES["data_parallel"]["tol"]
    print(f"mesh (b) data_parallel: (1, 2) grid, value error "
          f"{dp['value_err']:.3e}, gradient error {dp['grad_err']:.3e} "
          f"(scaled by the largest |value| and |gradient|; tol {tol:g}); "
          f"{ranks[0]['timing']['data_parallel']['seconds']:.3f} s")
    check(dp["value_err"] <= tol and dp["grad_err"] <= tol,
          "(b) data_parallel_kernel's value and gradient match the "
          "unsharded kernel")
    print(f"mesh (b): {MESH_RANKS} ranks on one card over Gloo in "
          f"{t_b:.1f} s (start-up included)")

    # (c) the eleven sharded paths, two ranks
    t0 = time.perf_counter()
    dry = dryrun_multichip(2, device="cuda", timeout_s=240)
    print(f"mesh (c) dryrun_multichip(2): ok {dry['ok']}, "
          f"{len(dry['paths'])} paths in {time.perf_counter() - t0:.1f} s: "
          + json.dumps({k: round(v.get("seconds", 0.0), 3)
                        for k, v in dry["paths"].items()}))
    check(dry["ok"] and len(dry["paths"]) == 11, "(c) the eleven paths ran")
    torch.distributed.destroy_process_group()
    seconds = time.perf_counter() - t_phase
    print(f"mesh phase: {seconds:.1f} s (budget {MESH_PHASE_BUDGET_S:g} s)")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mcmc_tpu_torch import (diagnostics, fused_gaussian_hmc,
                                fused_glm_hmc, hmc, HMCSettings)
    from mcmc_tpu_torch.models import (ill_conditioned_gaussian,
                                       logistic_regression_model,
                                       make_logistic_regression_data)
    from mcmc_tpu_torch.ops import _cuda
    from mcmc_tpu_torch.ops import fused_logreg as fl
    from mcmc_tpu_torch.ops import link_codegen as lc

    # f32 matmuls of the plain versions in full f32, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t_script = time.perf_counter()
    phase_s = {}      # each phase's seconds, printed before the last lines
    mark = [t_script]

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = round(now - mark[0], 1)
        mark[0] = now

    print(card_line())
    print(f"device: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(f"cuts that pay for phase 20 (before, after): "
          f"{json.dumps(MESH_CUTS)}")

    # --- build: the library and the traced links' libraries (the cloglog
    # link on the 128, the cluster and the two-pass body, the hook on the
    # 128 body), every nvcc started together
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:
        builds = [pool.submit(_cuda.load)]   # tracing runs beside it
        traced = {name: lc.trace_link(f) for name, f in TRACED_LINKS.items()}
        builds += [pool.submit(_cuda.build_link, traced[name].source, dp)
                   for name, dp in (("cloglog", 128), ("cloglog", 256),
                                    ("cloglog", 2048),
                                    ("logistic_hook", 128))]
        for b in builds:
            b.result()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_cuda.build_seconds and round(_cuda.build_seconds, 1)} s "
          "for the library, the traced links' beside it)")
    for name, t in traced.items():
        print(f"  {name} traced to {len(t.ops)} aten ops, {t.sfu[0]} + "
              f"{t.sfu[1]} special-function operations an element")
    # the two-pass body's ptxas report and the traced links' SASS CALLs,
    # for the kernels' JSON line
    build_report = {"two_pass_body_ptxas": xwide_build_report(_cuda),
                    "traced_link_sass_calls": traced_builds(_cuda)}
    for line in _cuda.build_log.splitlines():
        if "Compiling" in line or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    wgmma_notes = wgmma_advisories(_cuda)
    for line in wgmma_notes:
        print("  ptxas advisory:", line)

    # --- kernel vs plain version, flagship shapes
    X, y, beta = make_logistic_regression_data(0, N_DATA, DIM)
    check(X.is_cuda and y.is_cuda, "data made with no device= is on the card")
    rng = np.random.default_rng(1)
    gen = torch.Generator(device=dev).manual_seed(2)
    max_abs_err, max_scaled_err, timing = 0.0, 0.0, {}
    for name in LINKS:
        yl = y if name == "logistic" else link_data(name, X, beta, rng)
        link = fl.studentt_link(STUDENTT_NU) if name == "studentt" else name
        traj = fl.make_fused_trajectory(X, yl, PRIOR_SCALE, STEP_SIZE, N_LEAP,
                                        link=link)
        dp = traj.dim_padded
        z = torch.zeros((N_CHAINS, dp), device=dev)
        p = torch.zeros((N_CHAINS, dp), device=dev)
        z[:, :DIM] = beta + 0.3 * torch.randn((N_CHAINS, DIM), generator=gen,
                                              device=dev)
        p[:, :DIM] = torch.randn((N_CHAINS, DIM), generator=gen, device=dev)
        args = (traj.Xb, traj.y, traj.mask, traj.inv_pv, STEP_SIZE, N_LEAP,
                link)
        zk, pk, uk = fl.fused_trajectory_cuda(z, p, *args)
        zp, pp, up = fl._fused_trajectory_plain(z, p, *args)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(zk).all() and torch.isfinite(uk).all()),
              f"{name}: kernel output finite")
        per_chain, abs_err = scaled_errors((zk, pk, uk), (zp, pp, up))
        err_q99 = float(torch.quantile(per_chain, 0.99))
        err_max = float(per_chain.max())
        n_off = int((per_chain > TOL_BULK).sum())
        pad_zero = bool((zk[:, DIM:] == 0).all() and (pk[:, DIM:] == 0).all())
        ms, plain_ms = median_ms([
            lambda: fl.fused_trajectory_cuda(z, p, *args),
            lambda: fl._fused_trajectory_plain(z, p, *args)])
        timing[name] = (ms, plain_ms)
        print(f"K1 {name}: max abs error of z, p {abs_err:.3e}; per-chain "
              f"scaled error: 99th percentile {err_q99:.3e} (tol "
              f"{TOL_BULK:g}), max {err_max:.3e} (tol {TOL_MAX:g}), "
              f"{n_off} of {N_CHAINS} chains above {TOL_BULK:g}; padded "
              f"columns zero: {pad_zero}; kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms per trajectory (median of 10 windows of "
              f"10 calls)")
        check(err_q99 <= TOL_BULK, f"{name}: 99% of chains within {TOL_BULK}")
        check(err_max <= TOL_MAX, f"{name}: every chain within {TOL_MAX}")
        check(pad_zero, f"{name}: padded columns exactly zero")
        max_abs_err = max(max_abs_err, abs_err)
        max_scaled_err = max(max_scaled_err, err_max)
        if name == "logistic":   # kept for the run-time entry's phase
            k1_inputs, k1_outputs = (z, p, args), (zk, pk, uk)
        del z, p, zk, pk, uk, zp, pp, up

    # --- K1 on the links traced from torch, against their plain versions
    # (the same callables run by torch): cloglog on its own responses, the
    # hook on the flagship's; the hook also against the built-in logistic
    ycl = cloglog_y(X, beta, CLOGLOG_SEED + DIM)
    tr_timing, tr_err = {}, {}
    for name, link in TRACED_LINKS.items():
        traj = fl.make_fused_trajectory(X, ycl if name == "cloglog" else y,
                                        PRIOR_SCALE, STEP_SIZE, N_LEAP,
                                        link=link)
        z = torch.zeros((N_CHAINS, traj.dim_padded), device=dev)
        p = torch.zeros_like(z)
        z[:, :DIM] = beta + 0.3 * torch.randn((N_CHAINS, DIM), generator=gen,
                                              device=dev)
        p[:, :DIM] = torch.randn((N_CHAINS, DIM), generator=gen, device=dev)
        args = (traj.Xb, traj.y, traj.mask, traj.inv_pv, STEP_SIZE, N_LEAP,
                link)
        got = fl.fused_trajectory_cuda(z, p, *args)
        again = fl.fused_trajectory_cuda(z, p, *args)
        want = fl._fused_trajectory_plain(z, p, *args)
        torch.cuda.synchronize()
        what = f"K1 {name} (traced)"
        dzp, du = close_but_rare(what, got, want, N_CHAINS)
        ms, plain_ms, abs_err, err = glm_compare(
            what, [lambda: fl.fused_trajectory_cuda(z, p, *args),
                   lambda: fl._fused_trajectory_plain(z, p, *args)],
            got, want, DIM)
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        bound = glm_bound_ms(N_CHAINS, DIM, N_DATA, N_LEAP, False,
                             traced[name].sfu)
        print(f"  two launches bit-equal: {repeat}; max |dz|, |dp| "
              f"{dzp:.3e}, max relative |dU| {du:.3e} (_close_but_rare's "
              f"bounds); bound {bound[0]:.4f} ms ({bound[2]}), "
              f"{100 * bound[0] / ms:.1f}% of it")
        check(repeat, f"{what}: two launches bit-equal")
        tr_timing[name] = (ms, plain_ms, bound)
        tr_err[name] = (abs_err, err)
        if name == "logistic_hook":
            builtin = fl.fused_trajectory_cuda(z, p, *args[:-1], "logistic")
            torch.cuda.synchronize()
            dzp, du = close_but_rare("the traced hook against the built-in "
                                     "logistic", got, builtin, N_CHAINS)
            same = all(torch.equal(a, b) for a, b in zip(got, builtin))
            print(f"K1 logistic_hook (traced) against the built-in logistic "
                  f"(fast __expf and __fdividef): max |dz|, |dp| {dzp:.3e}, "
                  f"max relative |dU| {du:.3e}, within _close_but_rare's "
                  f"bounds; bit-equal: {same}")
            del builtin
        else:
            traced_k3_in = (z, p, args, got)
        del z, p, got, again, want

    # --- the fused main path at full width
    n_trans = (N_BURNIN + N_KEEP) * STEPS_PER_DRAW
    X_np, y_np = X.cpu().numpy(), y.cpu().numpy()
    fl.fused_trajectory_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fused_glm_hmc(X_np, y_np, prior_scale=PRIOR_SCALE,
                        step_size=STEP_SIZE, n_leap=N_LEAP, n_chains=N_CHAINS,
                        n_burnin_draws=N_BURNIN, n_keep_draws=N_KEEP,
                        steps_per_draw=STEPS_PER_DRAW, key=11)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fl.fused_trajectory_cuda.launches
    check(launches == n_trans, f"{launches} kernel launches for {n_trans} "
          "transitions")
    check(out.draws.is_cuda, "draws of numpy inputs with no device= are on "
          "the card")
    check(tuple(out.draws.shape) == (N_KEEP, N_CHAINS, DIM), "draws shape")
    check(bool(torch.isfinite(out.draws).all()), "draws finite")
    accept = float(out.diagnostics["accept_rate_per_chain"].mean())
    check(0.5 < accept <= 1.0, f"accept rate {accept} in (0.5, 1]")
    rhat = float(diagnostics.split_rhat(out.draws).max())
    ess = float(diagnostics.ess(out.draws, chain_chunk=1024).min())
    rate = n_trans * N_LEAP * N_CHAINS / seconds
    print(f"fused_glm_hmc: {N_CHAINS} chains, {n_trans} transitions in "
          f"{seconds:.3f} s, {launches} kernel launches; accept {accept:.4f}; "
          f"{rate:.4e} leapfrog steps/s; max split R-hat {rhat:.4f}; "
          f"min ESS {ess:.1f} (of {N_KEEP * N_CHAINS} draws)")
    fused_mean = out.draws.mean(dim=(0, 1))
    del out
    # the fused step's accept potential: one f32 pass (TF32 off) at the end
    # position (a Deviation from the JAX package's bf16-path U), timed alone
    # and as part of a whole transition at the flagship shapes
    c2_step = fl.make_fused_hmc_step(X_np, y_np, PRIOR_SCALE, STEP_SIZE,
                                     N_LEAP)
    c2_gen = torch.Generator(device=dev).manual_seed(14)
    c2_state = c2_step.init(0.05 * torch.randn((N_CHAINS, DIM),
                                               generator=c2_gen, device=dev))
    f32_ms, step_ms = median_ms([
        lambda: c2_step.reference_potential(c2_state.position),
        lambda: c2_step(c2_gen, c2_state)])
    print(f"fused step: the f32 accept potential {f32_ms:.4f} ms of a "
          f"{step_ms:.4f} ms transition ({N_CHAINS} chains; median of 10 "
          "windows of 10 calls)")
    del c2_step, c2_state

    # --- generic HMC over the same transitions, same start distribution
    gen = torch.Generator(device=dev).manual_seed(12)
    init = 0.05 * torch.randn((HMC_CHAINS, DIM), generator=gen, device=dev)
    settings = HMCSettings(n_burnin_draws=N_BURNIN * STEPS_PER_DRAW,
                           n_keep_draws=N_KEEP * STEPS_PER_DRAW,
                           step_size=STEP_SIZE, n_leap_steps=N_LEAP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = hmc(init, logistic_regression_model(X, y, PRIOR_SCALE), settings,
              key=13)
    torch.cuda.synchronize()
    diff = float((ref.draws.mean(dim=(0, 1)) - fused_mean).abs().max())
    hmc_rhat = float(diagnostics.split_rhat(ref.draws).max())
    print(f"hmc: {HMC_CHAINS} chains, {n_trans} transitions in "
          f"{time.perf_counter() - t0:.3f} s; accept "
          f"{float(ref.accept_rate.mean()):.4f}; max |mean - fused mean| "
          f"{diff:.4f} (tol {MEAN_ATOL}); max split R-hat {hmc_rhat:.4f}")
    check(diff <= MEAN_ATOL, f"hmc mean within {MEAN_ATOL} of the fused mean")
    hmc_mean = ref.draws.mean(dim=(0, 1))
    del ref

    # --- the traced cloglog link's path: fused_glm_hmc at the flagship's
    # chains, then the generic hmc on the same torch density, as above
    ycl_np = ycl.cpu().numpy()
    fl.fused_trajectory_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fused_glm_hmc(X_np, ycl_np, link=cloglog, prior_scale=PRIOR_SCALE,
                        step_size=STEP_SIZE, n_leap=N_LEAP, n_chains=N_CHAINS,
                        n_burnin_draws=N_BURNIN, n_keep_draws=N_KEEP,
                        steps_per_draw=STEPS_PER_DRAW, key=16)
    torch.cuda.synchronize()
    cl_seconds = time.perf_counter() - t0
    cl_launches = fl.fused_trajectory_cuda.launches
    check(cl_launches == n_trans, f"{cl_launches} launches of K1 on the "
          f"traced cloglog link for {n_trans} transitions")
    check(out.draws.is_cuda and tuple(out.draws.shape) ==
          (N_KEEP, N_CHAINS, DIM), "cloglog draws on the card, shape")
    check(bool(torch.isfinite(out.draws).all()), "cloglog draws finite")
    cl_accept = float(out.diagnostics["accept_rate_per_chain"].mean())
    check(0.5 < cl_accept <= 1.0, f"cloglog accept rate {cl_accept} in "
          "(0.5, 1]")
    cl_mean = out.draws.mean(dim=(0, 1))
    del out
    ycl_d = torch.as_tensor(ycl_np, device=dev)
    X_d = torch.as_tensor(X_np, device=dev)
    cl_density = lambda th: cloglog(th @ X_d.T, ycl_d)[1].sum(-1) \
        - 0.5 * (th * th).sum(-1) / PRIOR_SCALE ** 2
    gen = torch.Generator(device=dev).manual_seed(17)
    init = 0.05 * torch.randn((HMC_CHAINS, DIM), generator=gen, device=dev)
    t0 = time.perf_counter()
    ref = hmc(init, cl_density, settings, key=18)
    torch.cuda.synchronize()
    diff = float((ref.draws.mean(dim=(0, 1)) - cl_mean).abs().max())
    cl_ms = 1e3 * cl_seconds / n_trans
    print(f"fused_glm_hmc, traced cloglog link: {N_CHAINS} chains, {n_trans} "
          f"transitions in {cl_seconds:.3f} s ({cl_ms:.4f} ms a transition), "
          f"{cl_launches} launches of K1; accept {cl_accept:.4f}; "
          f"{n_trans * N_LEAP * N_CHAINS / cl_seconds:.4e} leapfrog "
          f"steps/s; hmc at {HMC_CHAINS} chains on the same torch density "
          f"over the same transitions {time.perf_counter() - t0:.3f} s, "
          f"accept {float(ref.accept_rate.mean()):.4f}, max |mean - fused "
          f"mean| {diff:.4f} (tol {MEAN_ATOL})")
    check(diff <= MEAN_ATOL, f"cloglog: hmc mean within {MEAN_ATOL} of the "
          "fused mean")
    del ref

    # --- the run-time-parameter entry of the GLM kernel, flagship shapes
    (z, p, args), k1_out = k1_inputs, k1_outputs
    Xb, yr, mask, inv_pv = args[:4]
    dp = z.shape[1]
    eps_t = torch.tensor(STEP_SIZE, dtype=torch.float32, device=dev)
    im = torch.ones((dp,), device=dev)
    im[:DIM] = torch.linspace(0.5, 2.0, DIM, device=dev)
    rt_args = (Xb, yr, mask, inv_pv, eps_t, N_LEAP, "logistic", im)
    got = fl.fused_trajectory_rt_cuda(z, p, *rt_args)
    want = fl._fused_trajectory_plain(z, p, Xb, yr, mask, inv_pv, eps_t,
                                      N_LEAP, "logistic", im)
    one = fl.fused_trajectory_rt_cuda(z, p, Xb, yr, mask, inv_pv, eps_t,
                                      N_LEAP, "logistic", torch.ones_like(im))
    torch.cuda.synchronize()
    per_chain, rt_abs_err = scaled_errors(got, want)
    rt_q99 = float(torch.quantile(per_chain, 0.99))
    rt_max = float(per_chain.max())
    pad_zero = bool((got[0][:, DIM:] == 0).all() and
                    (got[1][:, DIM:] == 0).all())
    same = all(torch.equal(a, b) for a, b in zip(one, k1_out))
    rt_ms, rt_plain_ms, k1_ms_again = median_ms([
        lambda: fl.fused_trajectory_rt_cuda(z, p, *rt_args),
        lambda: fl._fused_trajectory_plain(z, p, Xb, yr, mask, inv_pv, eps_t,
                                           N_LEAP, "logistic", im),
        lambda: fl.fused_trajectory_cuda(z, p, *args)])
    print(f"K3 logistic, eps on the card, inverse mass 0.5..2: max abs error "
          f"of z, p {rt_abs_err:.3e}; per-chain scaled error: 99th percentile "
          f"{rt_q99:.3e} (tol {TOL_BULK:g}), max {rt_max:.3e} (tol "
          f"{TOL_MAX:g}); padded columns zero: {pad_zero}; at inverse mass 1 "
          f"bit-equal to K1: {same}; kernel {rt_ms:.3f} ms, plain "
          f"{rt_plain_ms:.3f} ms, K1 beside it {k1_ms_again:.3f} ms")
    check(rt_q99 <= TOL_BULK, f"K3: 99% of chains within {TOL_BULK}")
    check(rt_max <= TOL_MAX, f"K3: every chain within {TOL_MAX}")
    check(pad_zero, "K3: padded columns exactly zero")
    check(same, "K3 at inverse mass 1 and K1's step is bit-equal to K1")
    # its path is its factory function: a step size that lives on the card and
    # changes between calls, no host synchronisation
    traj_rt = fl.make_fused_trajectory_rt(X_np, y_np, PRIOR_SCALE, N_LEAP)
    fl.fused_trajectory_rt_cuda.launches = 0
    zc, pc = z, p
    for _ in range(RT_CALLS):
        zc, pc, uc = traj_rt(zc, pc, eps_t, im)
        eps_t = eps_t * 1.01
    torch.cuda.synchronize()
    rt_launches = fl.fused_trajectory_rt_cuda.launches
    check(rt_launches == RT_CALLS, f"{rt_launches} launches of K3 for "
          f"{RT_CALLS} calls of its factory's trajectory")
    check(bool(zc.is_cuda and torch.isfinite(zc).all() and
               torch.isfinite(uc).all()), "K3 path output finite, on the card")
    print(f"make_fused_trajectory_rt: {RT_CALLS} chained trajectories, "
          f"{rt_launches} launches of K3")
    del z, p, zc, pc, got, want, one, k1_inputs, k1_outputs, k1_out
    # the same on the traced cloglog link
    z, p, args, k1_out = traced_k3_in
    eps_t = torch.tensor(STEP_SIZE, dtype=torch.float32, device=dev)
    rt_args = (*args[:4], eps_t, N_LEAP, cloglog, im)
    got = fl.fused_trajectory_rt_cuda(z, p, *rt_args)
    want = fl._fused_trajectory_plain(z, p, *rt_args)
    one = fl.fused_trajectory_rt_cuda(z, p, *rt_args[:-1],
                                      torch.ones_like(im))
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(one, k1_out))
    dzp, du = close_but_rare("K3 cloglog (traced)", got, want, N_CHAINS)
    rt_tr_ms, rt_tr_plain_ms, rt_tr_abs, rt_tr_err = glm_compare(
        "K3 cloglog (traced), inverse mass 0.5..2",
        [lambda: fl.fused_trajectory_rt_cuda(z, p, *rt_args),
         lambda: fl._fused_trajectory_plain(z, p, *rt_args)], got, want, DIM)
    check(same, "K3 on the traced link at inverse mass 1 and K1's step is "
          "bit-equal to K1")
    traj_rt = fl.make_fused_trajectory_rt(X_np, ycl_np, PRIOR_SCALE, N_LEAP,
                                          link=cloglog)
    fl.fused_trajectory_rt_cuda.launches = 0
    zc, pc = z, p
    for _ in range(RT_CALLS):
        zc, pc, uc = traj_rt(zc, pc, eps_t, im)
        eps_t = eps_t * 1.01
    torch.cuda.synchronize()
    rt_tr_launches = fl.fused_trajectory_rt_cuda.launches
    check(rt_tr_launches == RT_CALLS, f"{rt_tr_launches} launches of K3 on "
          f"the traced link for {RT_CALLS} calls of its factory's trajectory")
    check(bool(torch.isfinite(zc).all() and torch.isfinite(uc).all()),
          "K3 path on the traced link: output finite")
    rt_tr_bound = glm_bound_ms(N_CHAINS, DIM, N_DATA, N_LEAP, True,
                               traced["cloglog"].sfu)
    print(f"  max |dz|, |dp| {dzp:.3e}, max relative |dU| {du:.3e} "
          f"(_close_but_rare's bounds); at inverse mass 1 bit-equal to K1: "
          f"{same}; {RT_CALLS} chained trajectories through "
          f"make_fused_trajectory_rt(link=cloglog), {rt_tr_launches} "
          f"launches of K3; bound {rt_tr_bound[0]:.4f} ms "
          f"({rt_tr_bound[2]}), {100 * rt_tr_bound[0] / rt_tr_ms:.1f}% of it")
    del z, p, zc, pc, got, want, one, traced_k3_in, k1_out

    # --- the Gaussian kernel vs its plain version, the suite's shapes
    variances = ill_conditioned_gaussian(G_DIM, G_COND).variances
    check(variances.is_cuda, "target made with no device= is on the card")
    prec_np = (1.0 / variances).cpu().numpy()
    rng = np.random.default_rng(3)
    Q, _ = np.linalg.qr(rng.standard_normal((G_DIM, G_DIM)))
    dense_np = (Q * prec_np.astype(np.float64)) @ Q.T
    dense_np = 0.5 * (dense_np + dense_np.T)
    gen = torch.Generator(device=dev).manual_seed(4)
    g_eps = torch.tensor(G_STEP, dtype=torch.float32, device=dev)
    g_abs_err, g_scaled_err = 0.0, 0.0
    for name, P_np, m_np in (("diagonal", prec_np, None),
                             ("dense", dense_np, rng.standard_normal(G_DIM))):
        traj = fl.make_fused_gaussian_trajectory(P_np, m_np, G_STEP, G_LEAP)
        dp = traj.dim_padded
        z = torch.zeros((G_CHAINS, dp), device=dev)
        p = torch.zeros((G_CHAINS, dp), device=dev)
        z[:, :G_DIM] = G_INIT_SCALE * torch.randn((G_CHAINS, G_DIM),
                                                  generator=gen, device=dev)
        p[:, :G_DIM] = torch.randn((G_CHAINS, G_DIM), generator=gen,
                                   device=dev)
        gargs = (z, p, traj.P, traj.mean, g_eps, G_LEAP, G_DIM)
        got = fl.fused_gaussian_trajectory_cuda(*gargs)
        again = fl.fused_gaussian_trajectory_cuda(*gargs)
        want = fl._fused_gaussian_trajectory_plain(*gargs)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(t).all()) for t in got),
              f"K2 {name}: kernel output finite")
        per_chain, abs_err = scaled_errors(got, want)
        err_q99 = float(torch.quantile(per_chain, 0.99))
        err_max = float(per_chain.max())
        pad_zero = bool((got[0][:, G_DIM:] == 0).all() and
                        (got[1][:, G_DIM:] == 0).all())
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        zp_equal = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        ms, plain_ms = median_ms([
            lambda: fl.fused_gaussian_trajectory_cuda(*gargs),
            lambda: fl._fused_gaussian_trajectory_plain(*gargs)])
        print(f"K2 {name} precision: max abs error of z, p {abs_err:.3e}; "
              f"per-chain scaled error: 99th percentile {err_q99:.3e} (tol "
              f"{G_TOL_BULK:g}), max {err_max:.3e} (tol {G_TOL_MAX:g}); z, p "
              f"bit-equal to plain: {zp_equal}; padded columns zero: "
              f"{pad_zero}; two launches bit-equal: {repeat}; kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms per trajectory (median "
              f"of 10 windows of 10 calls)")
        check(err_q99 <= G_TOL_BULK, f"K2 {name}: 99% within {G_TOL_BULK}")
        check(err_max <= G_TOL_MAX, f"K2 {name}: every chain within {G_TOL_MAX}")
        check(pad_zero, f"K2 {name}: padded columns exactly zero")
        check(repeat, f"K2 {name}: two launches bit-equal")
        if name == "diagonal":
            check(zp_equal, "K2 diagonal: z, p bit-equal to the plain version")
            g_ms, g_plain_ms = ms, plain_ms
            sweep = {}
            for n in G_SWEEP_CHAINS:   # printed, not gated
                zs, ps = z.repeat(-(-n // G_CHAINS), 1)[:n].contiguous(), \
                    p.repeat(-(-n // G_CHAINS), 1)[:n].contiguous()
                (sweep[n],) = median_ms(
                    [lambda: fl.fused_gaussian_trajectory_cuda(
                        zs, ps, *gargs[2:])])
            print("K2 diagonal precision, ms per trajectory by chain count: "
                  + ", ".join(f"{n}: {t:.4f}" for n, t in sweep.items()))
            del zs, ps
        g_abs_err = max(g_abs_err, abs_err)
        g_scaled_err = max(g_scaled_err, err_max)
        del z, p, got, again, want

    # --- the Gaussian main path at full width, numpy in, no device=
    g_trans = (G_BURNIN + G_KEEP) * G_STEPS_PER_DRAW
    fl.fused_gaussian_trajectory_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fused_gaussian_hmc(prec_np, step_size=G_STEP, n_leap=G_LEAP,
                             n_chains=G_CHAINS, n_burnin_draws=G_BURNIN,
                             n_keep_draws=G_KEEP, init_scale=G_INIT_SCALE,
                             step_jitter=G_JITTER,
                             steps_per_draw=G_STEPS_PER_DRAW, key=20)
    torch.cuda.synchronize()
    g_seconds = time.perf_counter() - t0
    g_launches = fl.fused_gaussian_trajectory_cuda.launches
    check(g_launches == g_trans, f"{g_launches} launches of K2 for {g_trans} "
          "transitions")
    check(out.draws.is_cuda, "Gaussian draws are on the card")
    check(tuple(out.draws.shape) == (G_KEEP, G_CHAINS, G_DIM),
          "Gaussian draws shape")
    check(bool(torch.isfinite(out.draws).all()), "Gaussian draws finite")
    g_accept = float(out.diagnostics["accept_rate_per_chain"].mean())
    check(0.5 < g_accept <= 1.0, f"Gaussian accept rate {g_accept} in (0.5, 1]")
    flat = out.draws.reshape(-1, G_DIM).double()
    mean_err = float((flat.mean(dim=0).abs() / variances.double().sqrt()).max())
    var_err = float((flat.var(dim=0) / variances.double() - 1.0).abs().max())
    del flat
    g_rhat = float(diagnostics.rank_normalized_rhat(out.draws).max())
    g_ess = float(diagnostics.ess(out.draws, chain_chunk=256).min())
    g_rate = g_trans * G_LEAP * G_CHAINS / g_seconds
    print(f"fused_gaussian_hmc: {G_CHAINS} chains, {g_trans} transitions of "
          f"{G_LEAP} leapfrogs in {g_seconds:.3f} s, {g_launches} launches of "
          f"K2; accept {g_accept:.4f}; {g_rate:.4e} leapfrog steps/s; max "
          f"|mean|/sd {mean_err:.4f} (tol {G_MEAN_TOL}); max |var/variance "
          f"- 1| {var_err:.4f} (tol {G_VAR_TOL}); max rank R-hat "
          f"{g_rhat:.4f}; min ESS {g_ess:.1f} (of {G_KEEP * G_CHAINS} draws)")
    check(mean_err <= G_MEAN_TOL, f"Gaussian mean within {G_MEAN_TOL} sd")
    check(var_err <= G_VAR_TOL, f"Gaussian variance within {G_VAR_TOL}")
    del out

    lap("1-8")
    # --- phases 3-8 at the widths past 128 padded columns
    wide = wide_widths(dev, fl, lc, wgmma_notes)
    lap("3-8 wide")
    print(f"phases 3-8 at the wide widths: {phase_s['3-8 wide']} s")
    # --- adapted NUTS, the quality line, before any profiler runs
    out, nuts_step, nuts_gen, nuts_state = nuts_line(
        X, y, NUTS_CHAINS, "nuts", 40, full_diag=True)
    nuts_diff = float((out["mean"] - hmc_mean).abs().max())
    print(f"nuts: max |mean - phase 5's hmc mean| {nuts_diff:.4f}, not gated: "
          f"phase 5 did not converge (max split R-hat {hmc_rhat:.4f})")
    ref = nuts_reference(X, y, nuts_state)
    z = float(((out["mean"] - ref["mean"]).abs()
               / torch.hypot(out["mcse"], ref["mcse"])).max())
    print(f"nuts vs hmc reference: max |mean difference| / combined MC "
          f"standard error {z:.3f} over {DIM} dims (tol {NUTS_MEAN_SIGMAS:g})")
    check(z <= NUTS_MEAN_SIGMAS, "NUTS's posterior means agree with the hmc "
          f"reference's within {NUTS_MEAN_SIGMAS:g} MC standard errors")
    lap("9")
    big, *_ = nuts_line(X, y, NUTS_BIG_CHAINS, "nuts4096", 41,
                        full_diag=False, n_keep=NUTS_BIG_KEEP)
    z = float(((out["mean"] - big["mean"]).abs()
               / torch.hypot(out["mcse"], big["mcse"])).max())
    print(f"nuts vs nuts4096: max |mean difference| / combined MC standard "
          f"error {z:.3f} over {DIM} dims (tol {NUTS_MEAN_SIGMAS:g})")
    check(z <= NUTS_MEAN_SIGMAS, "the two NUTS lines' posterior means agree "
          f"within {NUTS_MEAN_SIGMAS:g} MC standard errors")

    lap("10")
    # --- the bench's other quality lines, at its widths and protocols
    chees_path = chees_line(X, y, ref)
    ghmc_path = ghmc_line(X, y, ref)
    mclmc_path = microcanonical_lines(X, y, ref)

    lap("11-13")
    # --- phases 14-16: the rows with the longest autocorrelation times run
    # in worker processes (WORKER_ROWS), started here, beside the rest
    workers = start_row_workers()
    try:
        # the suite's rows of RWMH, MALA and DE, at full settings
        mala_path, rmhmc_path, refs = suite_rows(dev)
        lap("14")
        # the suite's rows of SMC, stretch and DE-MC(Z), likewise
        aees_path, pt_path = tempering_rows(dev)
        lap("15")
        # the suite's rows of slice and Barker, the SGLD and mMALA lines,
        # then the worker rows as they finish
        slice_path = remaining_rows(dev, refs)
        done = join_row_workers(workers, dev)
    finally:
        stop_row_workers(workers)
    ellipse_path, gibbs_path = worker_rows_after(dev, refs, done)
    lap("16")

    # --- the one-call workflow on the flagship posterior
    workflow_phase(X_np, y_np, ref)
    lap("17")

    # --- evidence, approximate inference and durability
    evidence_phase(X_np, y_np, ref)
    lap("18")

    # --- multi-device sampling on the one card
    mesh_phase(X_np, y_np, ref, nuts_state)
    lap("20")

    # --- where the time of a steady transition goes (printed, not gated)
    t_profile = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(30)
    glm_step = fl.make_fused_hmc_step(X_np, y_np, PRIOR_SCALE, STEP_SIZE,
                                      N_LEAP)
    g_step = fl.make_fused_gaussian_hmc_step(
        prec_np, step_size=G_STEP, n_leap=G_LEAP, step_jitter=G_JITTER)
    samplers = [(f"{name} transition ({path[2].position.shape[0]} chains)",
                 *path, *SAMPLER_PROFILE[name])
                for name, path in (("chees", chees_path), ("ghmc", ghmc_path),
                                   ("mclmc", mclmc_path), ("mala", mala_path),
                                   ("rmhmc", rmhmc_path))]
    samplers += [(f"{name} draw ({path[2].X.shape[0]} {what}, "
                  f"{path[2].X.shape[1]} rungs)", *path,
                  *SAMPLER_PROFILE[name])
                 for name, what, path in (("aees", "runs", aees_path),
                                          ("pt", "ladders", pt_path))]
    samplers += [(f"{name} {what} ({path[2].position.shape[0]} chains)",
                  *path, *SAMPLER_PROFILE[name])
                 for name, what, path in (("slice", "sweep", slice_path),
                                          ("ellipse", "draw", ellipse_path),
                                          ("gibbs", "sweep", gibbs_path))]
    profile_transitions([   # the launch-bound ones first
        ("NUTS draw (1024 chains, sampling kernel)", nuts_step, nuts_gen,
         nuts_state, NUTS_PROFILE_WARM, NUTS_PROFILE_DRAWS),
        *samplers,
        ("Gaussian transition", g_step, gen, g_step.init(
            G_INIT_SCALE * torch.randn((G_CHAINS, G_DIM), generator=gen,
                                       device=dev)),
         PROFILE_WARM, PROFILE_STEPS),
        ("GLM transition", glm_step, gen, glm_step.init(0.05 * torch.randn(
            (N_CHAINS, DIM), generator=gen, device=dev)),
         PROFILE_WARM, PROFILE_STEPS)])
    # one profiled fused step as a Chrome trace, through the port's own
    # capture (the profiler has run already in this phase)
    from mcmc_tpu_torch.observability import capture_trace, trace
    z0 = glm_step.init(0.05 * torch.randn((N_CHAINS, DIM), generator=gen,
                                          device=dev))
    with capture_trace("chiprun_out") as cap:
        with trace("fused_glm_step"):
            glm_step(gen, z0)
        torch.cuda.synchronize()
    trace_bytes = cap.path.stat().st_size
    with open(cap.path) as f:
        n_events = len(json.load(f)["traceEvents"])
    print(f"capture_trace: {cap.path} ({trace_bytes} bytes, {n_events} "
          f"events) of one profiled fused GLM step")
    check(trace_bytes > 0 and n_events > 0, "the Chrome trace is not empty")
    print(f"profiles: phase seconds {time.perf_counter() - t_profile:.1f}")
    lap("19")
    print(f"phase seconds: {json.dumps(phase_s)}; the script "
          f"{time.perf_counter() - t_script:.1f} s")

    # bounds from the model's own sizes (the work the function needs); the
    # padded shapes the kernels are handed give the *_padded figures
    ms, plain_ms = timing["logistic"]
    dp, n_rows = Xb.shape[1], Xb.shape[0]
    k1_bounds = {name: glm_bound_ms(N_CHAINS, DIM, N_DATA, N_LEAP, False,
                                    name) for name in LINKS}
    k1_bound = k1_bounds["logistic"]
    k3_bound = glm_bound_ms(N_CHAINS, DIM, N_DATA, N_LEAP, True)
    k2_bound = gaussian_bound_ms(G_CHAINS, G_DIM, G_LEAP)
    k1_padded = glm_bound_ms(N_CHAINS, dp, n_rows, N_LEAP, False)[0]
    k3_padded = glm_bound_ms(N_CHAINS, dp, n_rows, N_LEAP, True)[0]
    k2_padded = gaussian_bound_ms(G_CHAINS, 128, G_LEAP)[0]
    for name in LINKS:
        b_ms, _by, which = k1_bounds[name]
        print(f"K1 {name}: bound {b_ms:.4f} ms ({which}); kernel "
              f"{timing[name][0]:.3f} ms, {100 * b_ms / timing[name][0]:.1f}% "
              "of it")
    print(f"K3 logistic: bound {k3_bound[0]:.4f} ms ({k3_bound[2]}); kernel "
          f"{rt_ms:.3f} ms, {100 * k3_bound[0] / rt_ms:.1f}% of it")
    for name, (t_ms, _plain, b) in tr_timing.items():
        print(f"K1 {name} (traced): bound {b[0]:.4f} ms ({b[2]}); kernel "
              f"{t_ms:.3f} ms, {100 * b[0] / t_ms:.1f}% of it")
    print(f"K2: bound {k2_bound[0]:.4f} ms (3xTF32 tensor operations on the "
          f"model's {G_DIM} columns); kernel {g_ms:.3f} ms, "
          f"{100 * k2_bound[0] / g_ms:.1f}% of it")
    src = "mcmc_tpu_torch/csrc/"

    def by_width(k, at_128):
        """The per-width fields of kernel ``k``'s record: ``at_128`` its
        (ms, plain ms, bound, launches) at 128 columns, beside the wide
        widths'."""
        return {f"{f}_by_width": {"128": v, **wide[k][f]} for f, v in zip(
            ("ms", "plain_ms", "bound_ms", "launches"), at_128)}

    tr = {f"{k} (traced)": v for k, v in tr_timing.items()}
    print(json.dumps({"kernels": [{
        "name": "fused_glm_trajectory", "route": "cuda",
        "source": src + "fused_glm_body.cuh",
        "wide_source": src + "fused_glm_wide_body.cuh",
        "xwide_source": src + "fused_glm_xwide_body.cuh",
        "library_sources": [src + "fused_glm_trajectory.cu",
                            src + "fused_glm_trajectory_wide.cu",
                            src + "fused_glm_trajectory_xwide.cu"],
        "traced_link_source": "mcmc_tpu_torch/ops/link_codegen.py",
        **build_report,
        "replaces": "mcmc_tpu/ops/fused_logreg.py:163",
        "launches": launches,
        "launches_by_link": {"logistic": launches,
                             "cloglog (traced)": cl_launches},
        "max_abs_err": max(max_abs_err, wide["K1"]["max_abs_err"],
                           *(e[0] for e in tr_err.values())),
        "max_scaled_err": max(max_scaled_err, wide["K1"]["max_scaled_err"],
                              *(e[1] for e in tr_err.values())),
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": k1_bound[0], "bound_by": k1_bound[1], "library_ms": None,
        "bound_operations": k1_bound[2], "bound_ms_padded": k1_padded,
        "ms_by_link": {**{k: v[0] for k, v in timing.items()},
                       **{k: v[0] for k, v in tr.items()}},
        "plain_ms_by_link": {**{k: v[1] for k, v in timing.items()},
                             **{k: v[1] for k, v in tr.items()}},
        "bound_ms_by_traced_link": {k: v[2][0] for k, v in tr.items()},
        "max_abs_err_by_traced_link": {f"{k} (traced)": v[0]
                                       for k, v in tr_err.items()},
        **by_width("K1", (ms, plain_ms, k1_bound[0], launches)),
        "ms_by_link_by_width": wide["K1"]["ms_by_link"],
        "plain_ms_by_link_by_width": wide["K1"]["plain_ms_by_link"],
        "cloglog_traced_by_width": {
            "128": {"ms": tr_timing["cloglog"][0],
                    "plain_ms": tr_timing["cloglog"][1],
                    "bound_ms": tr_timing["cloglog"][2][0],
                    "launches": cl_launches,
                    "ms_a_transition": cl_ms},
            **wide["K1"]["traced"]},
    }, {
        "name": "fused_glm_trajectory_rt", "route": "cuda",
        "source": src + "fused_glm_body.cuh",
        "wide_source": src + "fused_glm_wide_body.cuh",
        "xwide_source": src + "fused_glm_xwide_body.cuh",
        "library_sources": [src + "fused_glm_trajectory.cu",
                            src + "fused_glm_trajectory_wide.cu",
                            src + "fused_glm_trajectory_xwide.cu"],
        "traced_link_source": "mcmc_tpu_torch/ops/link_codegen.py",
        **build_report,
        "replaces": "mcmc_tpu/ops/fused_logreg.py:498",
        "launches": rt_launches,
        "launches_by_link": {"logistic": rt_launches,
                             "cloglog (traced)": rt_tr_launches},
        "max_abs_err": max(rt_abs_err, wide["K3"]["max_abs_err"],
                           rt_tr_abs),
        "max_scaled_err": max(rt_max, wide["K3"]["max_scaled_err"],
                              rt_tr_err),
        "ms": rt_ms, "plain_ms": rt_plain_ms,
        "bound_ms": k3_bound[0], "bound_by": k3_bound[1], "library_ms": None,
        "bound_operations": k3_bound[2], "bound_ms_padded": k3_padded,
        "ms_by_link": {"logistic": rt_ms, "cloglog (traced)": rt_tr_ms},
        "plain_ms_by_link": {"logistic": rt_plain_ms,
                             "cloglog (traced)": rt_tr_plain_ms},
        **by_width("K3", (rt_ms, rt_plain_ms, k3_bound[0], rt_launches)),
        "cloglog_traced_by_width": {
            "128": {"ms": rt_tr_ms, "plain_ms": rt_tr_plain_ms,
                    "bound_ms": rt_tr_bound[0], "launches": rt_tr_launches},
            **wide["K3"]["traced"]},
    }, {
        "name": "fused_gaussian_trajectory", "route": "cuda",
        "source": src + "fused_gaussian_trajectory.cu",
        "wide_source": src + "fused_gaussian_trajectory_wide.cu",
        "xwide_source": src + "fused_gaussian_trajectory_xwide.cu",
        "replaces": "mcmc_tpu/ops/fused_logreg.py:330",
        "launches": g_launches,
        "max_abs_err": max(g_abs_err, wide["K2"]["max_abs_err"]),
        "max_scaled_err": max(g_scaled_err, wide["K2"]["max_scaled_err"]),
        "ms": g_ms, "plain_ms": g_plain_ms,
        "bound_ms": k2_bound[0], "bound_by": k2_bound[1], "library_ms": None,
        "bound_ms_padded": k2_padded,
        **by_width("K2", (g_ms, g_plain_ms, k2_bound[0], g_launches)),
        "dense_ms_by_width": wide["K2"]["dense_ms"],
        "float64_error_ratio_by_width": wide["K2"]["float64_ratio"],
        "grid_by_width": wide["K2"]["grid"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank_main(sys.argv[2]))
    sys.exit(main())
