"""Variants of the wide GLM trajectory kernel, side by side, on an NVIDIA GPU.

Builds each given copy of ``mcmc_tpu_torch/csrc/fused_glm_trajectory_wide.cu``
(a version from git history, a design trial, or one with clock counters),
or of the two-pass body's header ``mcmc_tpu_torch/csrc/fused_glm_xwide_body.cuh``
(past 1,024 padded columns: ``--widths 1152,2048,3072,8192``; the shim
allocates its workspace), into its own library with the package's nvcc
flags, runs all of them on the
same inputs as ``chip_smoke.py``'s wide lap (16,384 chains, 4 leapfrogs of
0.01, prior scale 10; logistic, or every link at 384 padded columns with
``--links``) and prints, per width: each variant's agreement with the plain
version (99th percentile and max of the per-chain scaled error), whether
two launches are bit-equal, whether the run-time entry at inverse mass 1
gives the fixed-step entry's bits, whether padded columns stay zero,
whether z, p and U equal the first variant's bits, and each variant's time
(median of CUDA-event windows of back-to-back launches, the variants in
turns). ptxas's registers, spills and notes are printed for each build.

A variant that also defines ``extern "C" int trial_set_prof(void*)`` (a
copy with ``clock64()`` counters that stores 16 int64 for the first and the
last thread of each warpgroup of every block, the count it divides by at
index 11: 128-row tiles in the cluster body's copies, items in the two-pass
body's, ``scripts/trials/glm_xwide_counters.cuh``) is named with
``--instr`` (several, separated by commas): it is run once more with a
buffer installed and its counters are printed per tile or item, labelled
by ``--labels``; it also reports ``cudaOccupancyMaxActiveClusters`` if it
defines ``trial_max_clusters``. ``--defines name=A+B`` compiles a variant
with ``-DA -DB`` (a trial copy's switches).

From the repository root, with a card:

    mkdir -p build/trials/parent
    git show <rev>:mcmc_tpu_torch/csrc/fused_glm_trajectory_wide.cu \\
        > build/trials/parent/wide.cu
    python3 scripts/torch_wide_glm_trials.py \\
        parent=build/trials/parent/wide.cu \\
        now=mcmc_tpu_torch/csrc/fused_glm_trajectory_wide.cu \\
        --widths 256,384,896

and past 1,024, the two-pass body against a parent copy of its header
(with the parent's headers beside it) and its counters copy:

    python3 scripts/torch_wide_glm_trials.py \\
        parent=build/trials/parent_csrc/fused_glm_xwide_body.cuh \\
        now=mcmc_tpu_torch/csrc/fused_glm_xwide_body.cuh \\
        prof=scripts/trials/glm_xwide_counters.cuh --instr prof \\
        --labels "wait full,products,release,refill,link,update,idle,\\
cluster barrier,all,empty wait" --widths 1152,2048,3072,8192
"""

import argparse
import ctypes
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mcmc_tpu_torch.models import make_logistic_regression_data  # noqa: E402
from mcmc_tpu_torch.ops import _cuda  # noqa: E402
from mcmc_tpu_torch.ops import fused_logreg as fl  # noqa: E402

OUT = Path("build") / "trials" / "out"
# padded width -> (model columns, data rows): chip_smoke.py's wide models
# and one model at each other cluster size
WIDTHS = {256: (200, 1000), 384: (300, 1000), 512: (450, 1000),
          640: (600, 700), 768: (700, 333), 896: (784, 2000),
          1024: (1000, 200), 1152: (1100, 1000), 2048: (2000, 1000),
          3072: (3072, 2000), 8192: (8100, 512)}
SHIM = """#include "{src}"
extern "C" int trial_launch(bool rt, const void* z, const void* p,
                            const void* X, const void* y, const void* mask,
                            const void* eps_ptr, const void* inv_mass,
                            void* z_out, void* p_out, void* u_out,
                            int n_chains, int n_rows, int dim_padded,
                            int n_leap, float half_eps, float eps,
                            float inv_pv, int link, float nu, void* stream) {{
  return fused_glm_wide_launch(rt, z, p, X, y, mask, eps_ptr, inv_mass,
                               z_out, p_out, u_out, n_chains, n_rows,
                               dim_padded, n_leap, half_eps, eps, inv_pv,
                               link, nu, (cudaStream_t)stream);
}}
"""

# the two-pass body's shim: its launch takes a workspace (one allocation,
# kept and grown across launches)
XWIDE_SHIM = """#include "{src}"
extern "C" int trial_launch(bool rt, const void* z, const void* p,
                            const void* X, const void* y, const void* mask,
                            const void* eps_ptr, const void* inv_mass,
                            void* z_out, void* p_out, void* u_out,
                            int n_chains, int n_rows, int dim_padded,
                            int n_leap, float half_eps, float eps,
                            float inv_pv, int link, float nu, void* stream) {{
  static void* work = nullptr;
  static size_t have = 0;
  const size_t need =
      glm_xwide::workspace_bytes(n_chains, n_rows, dim_padded);
  if (need > have) {{
    if (work != nullptr) cudaFree(work);
    if (cudaMalloc(&work, need) != cudaSuccess) return -1;
    have = need;
  }}
  const cudaStream_t s = (cudaStream_t)stream;
  if (rt)
    return (int)glm_xwide::launch<BuiltinLinks, true>(
        z, p, X, y, mask, eps_ptr, inv_mass, z_out, p_out, u_out, work,
        n_chains, n_rows, dim_padded, n_leap, half_eps, eps, inv_pv, link,
        nu, s);
  return (int)glm_xwide::launch<BuiltinLinks, false>(
      z, p, X, y, mask, eps_ptr, inv_mass, z_out, p_out, u_out, work,
      n_chains, n_rows, dim_padded, n_leap, half_eps, eps, inv_pv, link, nu,
      s);
}}
"""


# the same for a copy whose header instantiates the body once per built-in
# link (its entry glm_xwide::launch_builtin)
XWIDE_BUILTIN_SHIM = XWIDE_SHIM.replace(
    "launch<BuiltinLinks, true>", "launch_builtin<true>").replace(
    "launch<BuiltinLinks, false>", "launch_builtin<false>")


def shims(variants):
    """Each variant's shim: the two-pass body's for a copy of its header."""
    out = {}
    for name, path in variants.items():
        text = open(path).read()
        out[name] = SHIM if "namespace glm_xwide" not in text else \
            XWIDE_BUILTIN_SHIM if "launch_builtin" in text else XWIDE_SHIM
    return out


def bind_glm(lib):
    """Argument types of the GLM shim's launch."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.trial_launch.argtypes = [ctypes.c_bool] + [vp] * 10 + \
        [ci] * 4 + [cf] * 3 + [ci, cf, vp]
    lib.trial_launch.restype = ci


def build(variants, shim=SHIM, bind=bind_glm, defines=None):
    """Compile every variant at once; return name -> bound library.
    ``shim`` wraps a source (its ``{src}``) in a C entry for ctypes (or
    maps a variant's name to its own shim),
    ``bind`` sets that entry's argument types, and ``defines`` maps a
    variant's name to its extra ``-D`` flags."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in variants.items():
        src = Path(src).resolve()
        wrapper = OUT / f"{name}_shim.cu"
        template = shim[name] if isinstance(shim, dict) else shim
        wrapper.write_text(template.format(src=src))
        so = OUT / f"{name}.so"
        flags = [f"-D{d}" for d in (defines or {}).get(name, ())]
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, *flags, "-shared", "-I",
               str(src.parent), "-I", str(_cuda.CSRC), "-o", str(so),
               str(wrapper)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "C75", "error",
                                       "arning")):
                print(f"  [{name}] {line.strip()}")
        if proc.returncode != 0:
            raise SystemExit(f"build of {name} failed:\n{log}")
        lib = ctypes.CDLL(str(so))
        bind(lib)
        libs[name] = lib
    return libs


def launch(lib, z, p, traj, n_leap, eps, code, nu, rt=None):
    z_out, p_out = torch.empty_like(z), torch.empty_like(p)
    u_out = torch.empty((z.shape[0],), device=z.device)
    e_ptr = im_ptr = None
    if rt is not None:
        e_ptr, im_ptr = rt[0].data_ptr(), rt[1].data_ptr()
    rc = lib.trial_launch(
        rt is not None, z.data_ptr(), p.data_ptr(), traj.Xb.data_ptr(),
        traj.y.data_ptr(), traj.mask.data_ptr(), e_ptr, im_ptr,
        z_out.data_ptr(), p_out.data_ptr(), u_out.data_ptr(), z.shape[0],
        traj.Xb.shape[0], z.shape[1], n_leap, 0.5 * eps, eps, traj.inv_pv,
        code, nu, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return z_out, p_out, u_out


def scaled_error(got, want):
    """99th percentile and max over chains of the error of (z, p, U)
    relative to each output's scale (chip_smoke.py's measure)."""
    (zk, pk, uk), (zp, pp, up) = got, want
    per = torch.stack([
        (zk - zp).abs().amax(dim=1) / zp.abs().max().clamp_min(1),
        (pk - pp).abs().amax(dim=1) / pp.abs().max().clamp_min(1),
        (uk - up).abs() / up.abs().max()]).amax(dim=0)
    return float(torch.quantile(per, 0.99)), float(per.max())


def median_ms(fns, reps, calls):
    """Median ms per call of each of ``fns``, the windows in turns."""
    times = [[] for _ in fns]
    for f in fns:
        f()
    for r in range(reps):
        order = range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fns[i]()
            end.record()
            end.synchronize()
            times[i].append(start.elapsed_time(end) / calls)
    return [(float(np.median(t)), min(t), max(t)) for t in times]


def responses(name, X, y, beta, dim):
    """y of each family for the data (logistic keeps the data's own), as in
    chip_smoke.py's link_data."""
    if name == "logistic":
        return y
    rng = np.random.default_rng(dim)
    eta = (X.double() @ beta.double()).cpu()
    n = X.shape[0]
    if name == "probit":
        out = rng.uniform(size=n) < torch.special.ndtr(eta).numpy()
    elif name == "poisson":
        out = rng.poisson(np.exp(eta.numpy()))
    elif name == "studentt":
        out = eta.numpy() + 0.5 * rng.standard_t(4.0, size=n)
    else:
        out = eta.numpy() + 0.5 * rng.standard_normal(n)
    return torch.tensor(np.asarray(out, np.float64), dtype=torch.float32,
                        device=X.device)


def blocks(n_chains, n_rows, dp):
    """At most the blocks of a launch: the cluster body's dp / 128 a
    128-chain tile, the two-pass body's min(8, row tiles, dp / 128) (a
    cluster of it may hold more chains)."""
    k = dp // 128
    c = k if dp <= _cuda.CLUSTER_MAX_DIM_PADDED \
        else min(8, (n_rows + 127) // 128, k)
    return c * ((n_chains + 127) // 128)


def print_counters(lib, run, n_blocks, labels):
    """Run once with the variant's counters installed; print their mean
    (and 10th, 90th percentiles) per tile over the recorded threads."""
    n_words = 16
    prof = torch.zeros((n_blocks, 4, n_words), dtype=torch.int64,
                       device="cuda")
    lib.trial_set_prof.argtypes = [ctypes.c_void_p]
    lib.trial_set_prof(prof.data_ptr())
    run()
    torch.cuda.synchronize()
    lib.trial_set_prof(None)
    per_thread = prof.double().reshape(-1, n_words)
    # threads that counted (the buffer may hold more blocks than ran)
    per_thread = per_thread[per_thread[:, 11] > 0]
    tiles = per_thread[:, 11:12]
    per = per_thread[:, :len(labels)] / tiles
    print(f"  clocks per tile or item ({per.shape[0]} threads, "
          f"{int(tiles[0, 0])} each):")
    for i, label in enumerate(labels):
        if label and label != "-":
            col = per[:, i]
            print(f"    {label:24s} {float(col.mean()):9.1f}  (p10 "
                  f"{float(col.quantile(0.1)):9.1f}, p90 "
                  f"{float(col.quantile(0.9)):9.1f})")
    print(f"  per thread, all counters: {per_thread.mean(0).tolist()}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="+", help="name=path.cu")
    ap.add_argument("--widths", default="256,384,896")
    ap.add_argument("--chains", type=int, default=16384)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--links", action="store_true",
                    help="every built-in link at 384 padded columns")
    ap.add_argument("--instr", default="",
                    help="the variants with clock counters (commas)")
    ap.add_argument("--defines", action="append", default=[],
                    help="name=A+B: compile variant name with -DA -DB")
    ap.add_argument("--labels", default="",
                    help="comma-separated names of the counters")
    ap.add_argument("--notime", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    variants = dict(v.split("=", 1) for v in args.variants)
    t0 = time.perf_counter()
    defines = {k: v.split("+") for k, v in
               (d.split("=", 1) for d in args.defines)}
    libs = build(variants, shim=shims(variants), defines=defines)
    print(f"build {time.perf_counter() - t0:.1f} s")
    instr = [n for n in args.instr.split(",") if n]
    names = [n for n in variants if n not in instr]
    if instr and hasattr(libs[instr[0]], "trial_max_clusters"):
        fn = libs[instr[0]].trial_max_clusters
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
        print("max active clusters by k:", {k: fn(k) for k in range(2, 9)})
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(50)
    for dp in map(int, args.widths.split(",")):
        dim, n = WIDTHS[dp]
        X, y, beta = make_logistic_regression_data(dim, n, dim)
        links = ("logistic", "poisson", "linear", "probit", "studentt") \
            if args.links and dp == 384 else ("logistic",)
        for lname in links:
            link = fl.studentt_link(4.0) if lname == "studentt" else lname
            traj = fl.make_fused_trajectory(
                X, responses(lname, X, y, beta, dim), 10.0, 0.01, 4,
                link=link)
            code, nu = fl._link_code(link)
            C = args.chains
            z = torch.zeros((C, dp), device=dev)
            p = torch.zeros((C, dp), device=dev)
            z[:, :dim] = beta + 0.3 * torch.randn((C, dim), generator=gen,
                                                  device=dev)
            p[:, :dim] = torch.randn((C, dim), generator=gen, device=dev)
            want = fl._fused_trajectory_plain(z, p, traj.Xb, traj.y,
                                              traj.mask, traj.inv_pv, 0.01,
                                              4, link)
            rt = (torch.tensor(0.01, device=dev), torch.ones(dp, device=dev))
            outs = {}
            for name in names:
                a = launch(libs[name], z, p, traj, 4, 0.01, code, nu)
                b = launch(libs[name], z, p, traj, 4, 0.01, code, nu)
                c = launch(libs[name], z, p, traj, 4, 0.01, code, nu, rt=rt)
                torch.cuda.synchronize()
                q99, mx = scaled_error(a, want)
                print(f"{dp} {lname} {name}: scaled error q99 {q99:.3e} max "
                      f"{mx:.3e}; two launches equal "
                      f"{all(torch.equal(u, v) for u, v in zip(a, b))}; "
                      "rt at inverse mass 1 equal "
                      f"{all(torch.equal(u, v) for u, v in zip(a, c))}; "
                      "padded columns zero "
                      f"{bool((a[0][:, dim:] == 0).all())} "
                      f"{bool((a[1][:, dim:] == 0).all())}")
                outs[name] = a
            for name in names[1:]:
                eq = [torch.equal(u, v)
                      for u, v in zip(outs[names[0]], outs[name])]
                print(f"  {name} against {names[0]}: z, p, U bit-equal {eq}")
            for name in instr if lname == "logistic" else ():
                lib = libs[name]
                print(f"  counters of {name}:")
                print_counters(
                    lib, lambda: launch(lib, z, p, traj, 4, 0.01, code, nu),
                    blocks(C, traj.Xb.shape[0], dp),
                    args.labels.split(","))
            if not args.notime:
                fns = [(lambda lib=libs[nm]: launch(lib, z, p, traj, 4, 0.01,
                                                    code, nu))
                       for nm in names]
                fns.append(lambda: launch(libs[names[-1]], z, p, traj, 4,
                                          0.01, code, nu, rt=rt))
                res = median_ms(fns, args.reps,
                                10 if dp < 896 else 5 if dp <= 2048 else 2)
                for nm, (m, lo, hi) in zip(names + [names[-1] + " rt"], res):
                    print(f"  time {dp} {lname} {nm}: {m:.4f} ms (min "
                          f"{lo:.4f}, max {hi:.4f})")
            del z, p, want, outs


if __name__ == "__main__":
    main()
