"""Variants of the wide Gaussian trajectory kernel, side by side, on an NVIDIA GPU.

Builds each given copy of
``mcmc_tpu_torch/csrc/fused_gaussian_trajectory_wide.cu`` (K2 past 128
padded columns: a version from git history, a design trial, or a copy with
clock counters such as ``scripts/trials/k2_wide_first_counters.cu``), or of
``fused_gaussian_trajectory_xwide.cu`` (K2 past 1,024: its entry takes a
workspace, which the shim allocates; ``--dims 1100,2000,4096``), into its
own library with the package's nvcc flags (``scripts/torch_wide_glm_trials.py``
builds and times), and runs all of them on ``chip_smoke.py`` phase 7's
inputs: 2,048 chains, 157 leapfrogs of 0.9, ``ill_conditioned_gaussian(dim,
1e4)`` as a diagonal precision and densely rotated (an orthogonal Q from
numpy's generator seeded with ``dim``, a random mean), at 250, 500, 784 and
1,000 dims (256, 512, 896 and 1,024 padded columns). Per width, precision
and variant it prints the per-chain scaled error against the plain version
(99th percentile and max, ``chip_smoke.py``'s measure), whether z and p
equal the plain version's bits (required on the diagonal to 1,024 padded
columns), the largest scaled error of the variant and of the f32 plain
version against the plain version in float64 (past 1,024, where the
products are 3xTF32 on the tensor cores, the variant's must stay within 4
times), whether two launches are bit-equal, whether padded columns stay
zero, and whether z, p and U equal the first variant's bits; then each
variant's time (median of CUDA-event windows of back-to-back launches, the
variants in turns).
Every line names the width as padded columns/dims. ``--stress N`` launches
each variant N times back to back on each precision and prints whether
every launch gave the first one's bits.

A variant is ``name=path.cu`` or ``name=path.cu:DEF,DEF=VALUE`` (extra
``-D`` flags, such as ``RESIDENT``: the counter copy's variant that reads
one resident stage). ``scripts/trials/k2_fma_loop_micro.cu`` is no trajectory: it
runs the body's FMA loop alone, as much of it as a trajectory does, on a
resident panel. A variant that defines ``extern "C" int
trial_set_prof(void*)`` (int64 counters, [blocks][2][16], for the first and
the last thread of each block: words 0-5 in clocks, 14 the products, 15 the
panels) is named with ``--instr``: it is run once more with the buffer
installed and its counters are printed per panel or per product, as
``--labels`` says (``name/panel`` or ``name/product``). For each variant the
script also prints the body's shared memory at each width and what the
card runs of it at once: for the wide body ``cudaOccupancyMaxActiveClusters``
at clusters of 1, 2, 4, 5 and 8 blocks, for the body past 1,024 its grid at
2,048 chains (blocks, chain tiles, blocks a tile, waves). A trial of the
body past 1,024 is a copy of its source kept under ``build/`` with one
constant changed (a panel's depth, the stages, how many panels a
tensor-core sum runs over), named beside the source itself.

From the repository root, with a card:

    mkdir -p build/trials/parent
    git show 8dca0bf:mcmc_tpu_torch/csrc/fused_gaussian_trajectory_wide.cu \\
        > build/trials/parent/gauss_wide.cu
    python3 scripts/torch_wide_gaussian_trials.py \\
        first=build/trials/parent/gauss_wide.cu \\
        now=mcmc_tpu_torch/csrc/fused_gaussian_trajectory_wide.cu \\
        --dims 250,500,1000
"""

import argparse
import ctypes
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mcmc_tpu_torch.models import ill_conditioned_gaussian  # noqa: E402
from mcmc_tpu_torch.ops import fused_logreg as fl  # noqa: E402
from torch_wide_glm_trials import build, median_ms  # noqa: E402

CHAINS, N_LEAP, STEP, COND, INIT_SCALE = 2048, 157, 0.9, 1e4, 1.0
SHIM = """#include "{src}"
extern "C" int trial_launch(const void* z, const void* p, const void* P,
                            const void* mean, const void* eps, void* z_out,
                            void* p_out, void* u_out, int n_chains,
                            int dim_padded, int dim, int n_leap,
                            void* stream) {{
  return fused_gaussian_wide_launch(z, p, P, mean, eps, z_out, p_out, u_out,
                                    n_chains, dim_padded, dim, n_leap,
                                    (cudaStream_t)stream);
}}
// the body's shared memory at this width, and how many clusters of k of its
// blocks fit on the card at once
extern "C" int trial_smem_bytes(int dim_padded, int dim) {{
  const int live = (dim + kLiveMultiple - 1) / kLiveMultiple * kLiveMultiple;
  return {bytes};
}}
extern "C" int trial_max_clusters(int k, int dim_padded, int dim) {{
  const int live = (dim + kLiveMultiple - 1) / kLiveMultiple * kLiveMultiple;
  const auto kernel = {kernel};
  const int bytes = {bytes};
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess)
    return -1;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {{}};
  cfg.gridDim = dim3(k * 64);
  cfg.blockDim = dim3({threads});
  cfg.dynamicSmemBytes = bytes;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess)
    return -1;
  return n;
}}
"""
# the shim of the body past 1,024 columns: its entry takes a workspace (one
# allocation, kept and grown across launches)
XWIDE_SHIM = """#include "{src}"
extern "C" int trial_launch(const void* z, const void* p, const void* P,
                            const void* mean, const void* eps, void* z_out,
                            void* p_out, void* u_out, int n_chains,
                            int dim_padded, int dim, int n_leap,
                            void* stream) {{
  static void* work = nullptr;
  static long long have = 0;
  const long long need = fused_gaussian_xwide_workspace_bytes(n_chains, dim);
  if (need > have) {{
    if (work != nullptr) cudaFree(work);
    if (cudaMalloc(&work, need) != cudaSuccess) return -1;
    have = need;
  }}
  return fused_gaussian_xwide_trajectory_launch(
      z, p, P, mean, eps, z_out, p_out, u_out, n_chains, dim_padded, dim,
      n_leap, work, stream);
}}
extern "C" int trial_smem_bytes(int dim_padded, int dim) {{
  return gauss_xwide::kSmemBytes;
}}
// the grid of a launch at 2,048 chains: blocks, tiles, blocks a tile, the
// blocks the card runs at once, waves
extern "C" int trial_grid(int dim, int* out) {{
  return fused_gaussian_xwide_grid(2048, dim, out);
}}
"""
# how the shim names a body's kernel, threads and shared memory: the first
# wide body has one kernel for every width, the present one a kernel a width
SHAPES = {
    "wide_kernel(int dim_padded)": ("wide_kernel(dim_padded)",
                                    "split_of(live, dim_padded).threads",
                                    "4 * split_of(live, dim_padded).floats"),
    "": ("fused_gaussian_wide_kernel", "split_of(live, dim_padded).threads",
         "4 * split_of(live, dim_padded).floats"),
}
FIRST_LABELS = ("ring wait/panel,block barrier/panel,cp.async issue/panel,"
               "FMA loop/panel,split-K hand-off/product,"
               "update and store_d/product")


def shims(variants):
    """The shim of each variant, naming its kernel as its source does."""
    out = {}
    for name, path in variants.items():
        text = open(path).read()
        if "fused_gaussian_xwide_kernel" in text:
            out[name] = XWIDE_SHIM
            continue
        key = next(k for k in SHAPES if k in text)
        kernel, threads, nbytes = SHAPES[key]
        out[name] = (SHIM.replace("{kernel}", kernel)
                     .replace("{threads}", threads)
                     .replace("{bytes}", nbytes))
    return out


def bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.trial_launch.argtypes = [vp] * 8 + [ci] * 4 + [vp]
    lib.trial_launch.restype = ci
    lib.trial_smem_bytes.argtypes = [ci, ci]
    lib.trial_smem_bytes.restype = ci
    if hasattr(lib, "trial_grid"):
        lib.trial_grid.argtypes = [ci, vp]
        lib.trial_grid.restype = ci
    else:
        lib.trial_max_clusters.argtypes = [ci, ci, ci]
        lib.trial_max_clusters.restype = ci


def occupancy(lib, w, dim):
    """What the card runs at once of a variant: for the body past 1,024
    columns its grid at 2,048 chains, else the clusters of 1, 2, 4, 5 and 8
    blocks that fit."""
    if hasattr(lib, "trial_grid"):
        out = (ctypes.c_int * 5)()
        lib.trial_grid(dim, out)
        return ("grid at 2,048 chains: {} blocks, {} tiles x {} blocks, {} "
                "at once, {} wave(s)".format(*out))
    return ("max active clusters at 1 / 2 / 4 / 5 / 8 blocks "
            + " / ".join(str(lib.trial_max_clusters(k, w, dim))
                         for k in (1, 2, 4, 5, 8)))


def launch(lib, z, p, P, mean, eps, dim):
    z_out, p_out = torch.empty_like(z), torch.empty_like(p)
    u_out = torch.empty((z.shape[0],), device=z.device)
    rc = lib.trial_launch(
        z.data_ptr(), p.data_ptr(), P.data_ptr(), mean.data_ptr(),
        eps.data_ptr(), z_out.data_ptr(), p_out.data_ptr(), u_out.data_ptr(),
        z.shape[0], z.shape[1], dim, N_LEAP,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return z_out, p_out, u_out


def scaled_errors(got, want):
    """Per chain, the largest error of z, p and U relative to each
    output's scale (chip_smoke.py phase 7's measure)."""
    (zk, pk, uk), (zp, pp, up) = got, want
    return torch.stack([
        (zk - zp).abs().amax(dim=1) / zp.abs().max().clamp_min(1),
        (pk - pp).abs().amax(dim=1) / pp.abs().max().clamp_min(1),
        (uk - up).abs() / up.abs().max()]).amax(dim=0)


def problems(dim, dev, gen):
    """Phase 7's two precisions at ``dim``: (name, traj args, dim)."""
    variances = ill_conditioned_gaussian(dim, COND, device=dev).variances
    prec = (1.0 / variances).cpu().numpy().astype(np.float64)
    rng = np.random.default_rng(dim)
    # the QR and the product in float64 on the card (chip_smoke.py's
    # dense_rotation): at 4,096 dims the host's LAPACK takes seconds
    A = torch.tensor(rng.standard_normal((dim, dim)), dtype=torch.float64,
                     device=dev)
    Q, _ = torch.linalg.qr(A)
    dense = (Q / variances.double()) @ Q.T
    dense = (0.5 * (dense + dense.T)).cpu().numpy()
    eps = torch.tensor(STEP, dtype=torch.float32, device=dev)
    out = []
    for name, P_np, m_np in (("diagonal", prec, None),
                             ("dense", dense, rng.standard_normal(dim))):
        traj = fl.make_fused_gaussian_trajectory(P_np, m_np, STEP, N_LEAP,
                                                 device=dev)
        dp = traj.dim_padded
        z = torch.zeros((CHAINS, dp), device=dev)
        p = torch.zeros((CHAINS, dp), device=dev)
        z[:, :dim] = INIT_SCALE * torch.randn((CHAINS, dim), generator=gen,
                                              device=dev)
        p[:, :dim] = torch.randn((CHAINS, dim), generator=gen, device=dev)
        out.append((name, (z, p, traj.P, traj.mean, eps)))
    return out


def print_counters(lib, run, n_blocks, labels):
    """Run once with the variant's counters installed; print each
    counter's mean (10th and 90th percentiles) over the recorded threads,
    per panel or per product."""
    prof = torch.zeros((n_blocks, 2, 16), dtype=torch.int64, device="cuda")
    lib.trial_set_prof.argtypes = [ctypes.c_void_p]
    lib.trial_set_prof(prof.data_ptr())
    run()
    torch.cuda.synchronize()
    lib.trial_set_prof(None)
    per = prof.double().reshape(-1, 16)
    products, panels = per[:, 14], per[:, 15]
    print(f"  counters ({per.shape[0]} threads; {int(products[0])} products, "
          f"{int(panels[0])} panels each):")
    total = torch.zeros_like(products)
    for i, spec in enumerate(labels):
        name, unit = spec.rsplit("/", 1)
        total += per[:, i]
        col = per[:, i] / (panels if unit == "panel" else products)
        print(f"    {name:28s} {float(col.mean()):10.1f} a {unit} (p10 "
              f"{float(col.quantile(0.1)):10.1f}, p90 "
              f"{float(col.quantile(0.9)):10.1f}); "
              f"{float((per[:, i] / products).mean()):10.1f} a product")
    print(f"    {'sum':28s} {float((total / products).mean()):10.1f} a "
          "product")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="+", help="name=path.cu[:DEF,...]")
    ap.add_argument("--dims", default="250,500,1000")
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--instr", default="",
                    help="comma-separated variants with clock counters")
    ap.add_argument("--labels", default=FIRST_LABELS,
                    help="comma-separated name/panel or name/product")
    ap.add_argument("--plain", action="store_true",
                    help="time the plain version beside the variants")
    ap.add_argument("--notime", action="store_true")
    ap.add_argument("--stress", type=int, default=0,
                    help="launches of each variant compared with its first")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    variants, defines = {}, {}
    for v in args.variants:
        name, rest = v.split("=", 1)
        path, _, defs = rest.partition(":")
        variants[name] = path
        defines[name] = [d for d in defs.split(",") if d]
    instr = [n for n in args.instr.split(",") if n]
    t0 = time.perf_counter()
    libs = build(variants, shim=shims(variants), bind=bind, defines=defines)
    print(f"build {time.perf_counter() - t0:.1f} s")
    labels = args.labels.split(",")
    names = [n for n in variants if n not in instr]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(53)
    for dim in map(int, args.dims.split(",")):
        tag = f"{fl._round_up(dim, 128)}/{dim}"
        for name in variants:
            lib, w = libs[name], fl._round_up(dim, 128)
            print(f"{tag} {name}: shared memory "
                  f"{lib.trial_smem_bytes(w, dim)} bytes; "
                  f"{occupancy(lib, w, dim)}")
        for kind, targs in problems(dim, dev, gen):
            want = fl._fused_gaussian_trajectory_plain(*targs, N_LEAP, dim)
            z, p, P, mean, _eps = targs
            exact = fl._fused_gaussian_trajectory_plain(
                z.double(), p.double(), P.double(), mean.double(), STEP,
                N_LEAP, dim)
            plain_err = float(scaled_errors(
                [t.double() for t in want], exact).max())
            outs = {}
            for name in names:
                a = launch(libs[name], *targs, dim)
                b = launch(libs[name], *targs, dim)
                torch.cuda.synchronize()
                per = scaled_errors(a, want)
                print(f"{tag} {kind} {name}: scaled error q99 "
                      f"{float(torch.quantile(per, 0.99)):.3e} max "
                      f"{float(per.max()):.3e}; z, p bit-equal to plain "
                      f"{torch.equal(a[0], want[0]) and torch.equal(a[1], want[1])}; "
                      "two launches equal "
                      f"{all(torch.equal(u, v) for u, v in zip(a, b))}; "
                      "padded columns zero "
                      f"{bool((a[0][:, dim:] == 0).all() and (a[1][:, dim:] == 0).all())}")
                f64 = float(scaled_errors([t.double() for t in a],
                                          exact).max())
                print(f"  {tag} {kind} {name}: largest scaled error "
                      f"against float64 {f64:.3e}, the f32 plain "
                      f"version's {plain_err:.3e} ({f64 / plain_err:.2f}x)")
                outs[name] = a
            for name in names[1:]:
                eq = [torch.equal(u, v)
                      for u, v in zip(outs[names[0]], outs[name])]
                print(f"  {name} against {names[0]}: z, p, U bit-equal {eq}")
            for name in names if args.stress else ():
                first = outs[name]
                differ = torch.zeros((), dtype=torch.int64, device=dev)
                for _ in range(args.stress - 1):
                    again = launch(libs[name], *targs, dim)
                    differ += sum((u != v).any().long()
                                  for u, v in zip(first, again))
                torch.cuda.synchronize()
                print(f"  {tag} {kind} {name}: {args.stress} launches, all "
                      f"bit-equal to the first {int(differ) == 0}")
            for name in instr:
                lib = libs[name]
                print(f"  {tag} {kind} {name}:")
                print_counters(lib, lambda: launch(lib, *targs, dim),
                               (CHAINS + 15) // 16, labels)
            reps_calls = (args.reps, 10 if fl._round_up(dim, 128) <= 512
                          else 5 if dim <= 1024 else 1)
            if not args.notime and kind == "dense":
                timed = names + instr
                fns = [(lambda lib=libs[nm]: launch(lib, *targs, dim))
                       for nm in timed]
                if args.plain:
                    timed = timed + ["plain"]
                    fns.append(lambda: fl._fused_gaussian_trajectory_plain(
                        *targs, N_LEAP, dim))
                res = median_ms(fns, *reps_calls)
                for nm, (m, lo, hi) in zip(timed, res):
                    print(f"  time {tag} {kind} {nm}: {m:.4f} ms (min "
                          f"{lo:.4f}, max {hi:.4f})")
            del want, exact, outs


if __name__ == "__main__":
    main()
