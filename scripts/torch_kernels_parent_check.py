"""The package's kernel library against an earlier version's, on an NVIDIA GPU.

Builds every ``*.cu`` of an earlier copy of ``mcmc_tpu_torch/csrc`` (made on
a machine with git, the card's has none) into a library of its own with the
package's nvcc flags, binds it as ``mcmc_tpu_torch/ops/_cuda.py`` binds the
package's, and runs both on the same inputs at ``chip_smoke.py``'s shapes
(16,384 chains, 4 leapfrogs of 0.01, prior scale 10; 2,048 chains and 157
leapfrogs of 0.9 for the Gaussian kernel):

- K1 (the GLM trajectory) on every built-in link and K3 (its run-time
  entry, inverse mass 0.5..2) on the logistic link at each padded width of
  ``--widths``; K2 (the Gaussian trajectory) on a dense precision at each
  of ``--gauss``: whether z, p and U equal the earlier build's bits;
- each kernel's time, the two builds in turns (earlier, now, now, earlier:
  median of CUDA-event windows of back-to-back launches through the C
  entries, their arguments made once), and the ratio now / earlier;
- the SHA-256 digests of the built-in logistic K1's outputs on
  ``tests/test_torch_kernels_cuda.py``'s ``_digest_problem`` inputs from
  the earlier build, which that file's card test holds the package to.

From the repository root, with a card (the earlier copy made beforehand):

    mkdir -p build/trials/parent_csrc
    git archive <rev> mcmc_tpu_torch/csrc | tar -x -C build/trials/parent_csrc
    python3 scripts/torch_kernels_parent_check.py \\
        build/trials/parent_csrc/mcmc_tpu_torch/csrc
"""

import argparse
import ctypes
import hashlib
import importlib.util
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mcmc_tpu_torch.models import (ill_conditioned_gaussian,  # noqa: E402
                                   make_logistic_regression_data)
from mcmc_tpu_torch.ops import _cuda  # noqa: E402
from mcmc_tpu_torch.ops import fused_logreg as fl  # noqa: E402

OUT = Path("build") / "trials" / "parent_lib"
# padded width -> (model columns, data rows): chip_smoke.py's models
GLM = {128: (100, 1000), 256: (200, 1000), 384: (300, 1000),
       512: (450, 1000), 896: (784, 2000), 1024: (1000, 200)}
LINKS = ("logistic", "poisson", "linear", "probit", "studentt")


def build_dir(csrc):
    """Every source of ``csrc`` compiled at once and linked into one
    library, bound as ``_cuda.load`` binds the package's."""
    OUT.mkdir(parents=True, exist_ok=True)
    srcs = sorted(Path(csrc).glob("*.cu"))
    procs = [(src, OUT / (src.stem + ".o"), subprocess.Popen(
        [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-c", "-o",
         str(OUT / (src.stem + ".o")), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src in srcs]
    for src, _, p in procs:
        log = p.communicate()[0]
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed on {src}:\n{log}")
    so = OUT / "parent.so"
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS[:2], "-shared", "-o",
                    str(so), *(str(o) for _, o, _ in procs)], check=True)
    lib = ctypes.CDLL(str(so))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fused_glm_trajectory_launch.argtypes = \
        [vp] * 8 + [ci] * 4 + [cf] * 3 + [ci, cf, vp]
    lib.fused_glm_trajectory_rt_launch.argtypes = \
        [vp] * 8 + [vp, vp] + [ci] * 4 + [cf] + [ci, cf, vp]
    lib.fused_gaussian_trajectory_launch.argtypes = [vp] * 8 + [ci] * 4 + [vp]
    return lib


def glm_launch(lib, z, p, Xb, y, mask, inv_pv, eps, n_leap, link,
               inv_mass=None):
    """``fused_logreg._launch_glm``'s call on the library ``lib``."""
    code, nu = fl._link_code(link)
    z_out, p_out = torch.empty_like(z), torch.empty_like(p)
    u_out = torch.empty((z.shape[0],), device=z.device)
    ptrs = (z.data_ptr(), p.data_ptr(), Xb.data_ptr(), y.data_ptr(),
            mask.data_ptr(), z_out.data_ptr(), p_out.data_ptr(),
            u_out.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    n, dp = z.shape
    if inv_mass is None:
        rc = lib.fused_glm_trajectory_launch(
            *ptrs, n, Xb.shape[0], dp, n_leap, 0.5 * eps, eps, inv_pv, code,
            nu, stream)
    else:
        e = torch.tensor(eps, device=z.device)
        rc = lib.fused_glm_trajectory_rt_launch(
            *ptrs, e.data_ptr(), inv_mass.data_ptr(), n, Xb.shape[0], dp,
            n_leap, inv_pv, code, nu, stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return z_out, p_out, u_out


def glm_launcher(lib, z, p, Xb, y, mask, inv_pv, eps, n_leap, link,
                 inv_mass=None):
    """A call of ``lib``'s C entry with its arguments, outputs and step
    size made once, for timing: no allocation, copy or Python wrapper
    between back-to-back launches."""
    code, nu = fl._link_code(link)
    outs = [torch.empty_like(z), torch.empty_like(p),
            torch.empty((z.shape[0],), device=z.device)]
    e = torch.tensor(eps, device=z.device)
    stream = torch.cuda.current_stream().cuda_stream
    n, dp = z.shape
    ptrs = (z.data_ptr(), p.data_ptr(), Xb.data_ptr(), y.data_ptr(),
            mask.data_ptr(), *(o.data_ptr() for o in outs))
    if inv_mass is None:
        args = (*ptrs, n, Xb.shape[0], dp, n_leap, 0.5 * eps, eps, inv_pv,
                code, nu, stream)
        return lambda: lib.fused_glm_trajectory_launch(*args)
    args = (*ptrs, e.data_ptr(), inv_mass.data_ptr(), n, Xb.shape[0], dp,
            n_leap, inv_pv, code, nu, stream)
    return lambda: lib.fused_glm_trajectory_rt_launch(*args)


def gauss_launch(lib, z, p, P, mean, eps, n_leap, dim):
    z_out, p_out = torch.empty_like(z), torch.empty_like(p)
    u_out = torch.empty((z.shape[0],), device=z.device)
    rc = lib.fused_gaussian_trajectory_launch(
        z.data_ptr(), p.data_ptr(), P.data_ptr(), mean.data_ptr(),
        eps.data_ptr(), z_out.data_ptr(), p_out.data_ptr(), u_out.data_ptr(),
        z.shape[0], z.shape[1], dim, n_leap,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return z_out, p_out, u_out


def median_ms(fns, reps=8, calls=10):
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
    return [float(np.median(t)) for t in times]


def responses(name, X, y, beta, dim):
    """chip_smoke.py's link_data: y of each family for the data."""
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


def card_tests():
    """``tests/test_torch_kernels_cuda.py`` as a module (it imports no
    JAX)."""
    spec = importlib.util.spec_from_file_location(
        "card_tests", Path("tests") / "test_torch_kernels_cuda.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", help="the earlier csrc directory")
    ap.add_argument("--widths", default="128,256,384,896")
    ap.add_argument("--gauss", default="100,250,500,1000")
    ap.add_argument("--chains", type=int, default=16384)
    ap.add_argument("--reps", type=int, default=30,
                    help="timing windows of each build, in turns")
    ap.add_argument("--calls", type=int, default=50,
                    help="back-to-back launches a window")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    t0 = time.perf_counter()
    old = build_dir(args.parent)
    new = _cuda.load()
    print(f"builds {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(50)
    all_equal, ratios = True, {}
    for dp in map(int, args.widths.split(",")):
        dim, n = GLM[dp]
        X, y, beta = make_logistic_regression_data(dim, n, dim)
        C = args.chains
        z = torch.zeros((C, dp), device=dev)
        p = torch.zeros((C, dp), device=dev)
        z[:, :dim] = beta + 0.3 * torch.randn((C, dim), generator=gen,
                                              device=dev)
        p[:, :dim] = torch.randn((C, dim), generator=gen, device=dev)
        im = torch.ones((dp,), device=dev)
        im[:dim] = torch.linspace(0.5, 2.0, dim, device=dev)
        for name in LINKS:
            link = fl.studentt_link(4.0) if name == "studentt" else name
            traj = fl.make_fused_trajectory(
                X, responses(name, X, y, beta, dim), 10.0, 0.01, 4,
                link=link)
            a = (z, p, traj.Xb, traj.y, traj.mask, traj.inv_pv, 0.01, 4,
                 link)
            cases = [("K1", {})] + ([("K3", {"inv_mass": im})]
                                    if name == "logistic" else [])
            for kernel, kw in cases:
                want = glm_launch(old, *a, **kw)
                got = glm_launch(new, *a, **kw)
                torch.cuda.synchronize()
                eq = [torch.equal(u, v) for u, v in zip(got, want)]
                all_equal &= all(eq)
                line = f"{kernel} {name} at {dp}: z, p, U bit-equal {eq}"
                if name == "logistic":
                    run_old = glm_launcher(old, *a, **kw)
                    run_new = glm_launcher(new, *a, **kw)
                    t_old1, t_new1, t_new2, t_old2 = median_ms(
                        [run_old, run_new, run_new, run_old],
                        reps=args.reps, calls=args.calls)
                    t_old, t_new = (t_old1 + t_old2) / 2, (t_new1 + t_new2) / 2
                    ratios[f"{kernel} {dp}"] = t_new / t_old
                    line += (f"; earlier {t_old1:.4f}, {t_old2:.4f} ms, now "
                             f"{t_new1:.4f}, {t_new2:.4f} ms: now / earlier "
                             f"{t_new / t_old:.4f}")
                print(line)
                del want, got
        del z, p
    g_eps = torch.tensor(0.9, device=dev)
    for dim in map(int, args.gauss.split(",")):
        var = ill_conditioned_gaussian(dim, 1e4).variances
        rng = np.random.default_rng(dim)
        Q, _ = np.linalg.qr(rng.standard_normal((dim, dim)))
        P_np = (Q * (1.0 / var).cpu().numpy().astype(np.float64)) @ Q.T
        traj = fl.make_fused_gaussian_trajectory(0.5 * (P_np + P_np.T),
                                                 None, 0.9, 157)
        dp = traj.dim_padded
        z = torch.zeros((2048, dp), device=dev)
        p = torch.zeros((2048, dp), device=dev)
        z[:, :dim] = torch.randn((2048, dim), generator=gen, device=dev)
        p[:, :dim] = torch.randn((2048, dim), generator=gen, device=dev)
        a = (z, p, traj.P, traj.mean, g_eps, 157, dim)
        want, got = gauss_launch(old, *a), gauss_launch(new, *a)
        torch.cuda.synchronize()
        eq = [torch.equal(u, v) for u, v in zip(got, want)]
        all_equal &= all(eq)
        t_old1, t_new1, t_new2, t_old2 = median_ms(
            [lambda: gauss_launch(old, *a), lambda: gauss_launch(new, *a),
             lambda: gauss_launch(new, *a), lambda: gauss_launch(old, *a)],
            reps=6, calls=5)
        r = (t_new1 + t_new2) / (t_old1 + t_old2)
        ratios[f"K2 {dp}"] = r
        print(f"K2 dense at {dp} ({dim} dims): z, p, U bit-equal {eq}; "
              f"earlier {t_old1:.4f}, {t_old2:.4f} ms, now {t_new1:.4f}, "
              f"{t_new2:.4f} ms: now / earlier {r:.4f}")
    tests = card_tests()
    for dim in tests.DIGEST_DIMS:
        z, p, args_ = tests._digest_problem(dim)
        print(f"digest of the earlier build's K1 logistic at {dim} columns: "
              f"{tests._digest(glm_launch(old, z, p, *args_))}; now "
              f"{tests._digest(fl.fused_trajectory_cuda(z, p, *args_))}")
    print(f"every output bit-equal: {all_equal}; time now / earlier: "
          + ", ".join(f"{k} {v:.4f}" for k, v in ratios.items()))


if __name__ == "__main__":
    main()
