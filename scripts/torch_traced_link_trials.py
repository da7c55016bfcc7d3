"""Variants of the GLM trajectory on a traced link, side by side, on an NVIDIA GPU.

Each variant is a link functor compiled into the body ``--dp`` needs (the
128 body, the cluster body or the two-pass body) through the translation
unit ``mcmc_tpu_torch/ops/_cuda.py`` generates for a traced link
(``link_source``), each into a library of its own with the package's nvcc
flags, all compiled at once. A variant is ``name=SPEC``:

- ``traced:LINK``: the functor ``ops/link_codegen.py`` traces from LINK
  (``cloglog`` or ``logistic_hook``, as ``chip_smoke.py`` writes them);
- ``fastdiv:LINK``: the same with each quotient ``div_rn`` replaced by the
  approximate ``__fdividef`` (a trial);
- ``ieee:LINK``: the same with each ``div_rn`` replaced by CUDA's
  ``__fdiv_rn``, whose slow path is a ``CALL`` in the kernel (what the
  tracer emitted before ``div_rn``);
- ``f64div:LINK``: the same with each ``div_rn`` replaced by a quotient
  computed in f64 alone (``F64_DIV``: no f32 path; a trial);
- ``builtin:CODE``: a functor that calls the built-in link CODE's code
  (``link_residual<CODE>`` of ``csrc/fused_glm_common.cuh``): the library's
  arithmetic in a traced link's translation unit;
- ``file:PATH``: a functor source (``struct TracedLink``) from a file.

``SPEC@DIR`` builds the variant against the headers in DIR (a parent copy
of ``mcmc_tpu_torch/csrc``) in place of the package's; ``SPEC%NAME`` with
``-DNAME`` (a trial switch of a header).

It runs every variant and the package's library on the logistic link at
``chip_smoke.py``'s shapes (16,384 chains, 4 leapfrogs of 0.01, prior scale
10; 100 x 1,000 at 128 padded columns, 300 x 1,000 at 384, 784 x 2,000 at
896, 2,000 x 1,000 at 2,048), compares each
variant with the plain version of its link and with the first variant's
bits (for ``builtin:0``, the bits of the library), times them in turns (median of CUDA-event windows of
back-to-back launches through the C entry, no Python in between), and prints
each kernel's SASS census from ``cuobjdump`` where the toolkit has it
(instructions, special-function ``MUFU``, ``CALL``, branches, warpgroup
waits).

From the repository root, with a card:

    python3 scripts/torch_traced_link_trials.py lib0=builtin:0 \\
        hook=traced:logistic_hook cloglog=traced:cloglog --dp 128
"""

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mcmc_tpu_torch.models import make_logistic_regression_data  # noqa: E402
from mcmc_tpu_torch.ops import _cuda, link_codegen as lc  # noqa: E402
from mcmc_tpu_torch.ops import fused_logreg as fl  # noqa: E402

OUT = Path("build") / "trials" / "traced"
MODELS = {128: (100, 1000), 384: (300, 1000), 896: (784, 2000),
          2048: (2000, 1000)}


def cloglog(eta, y):
    m = torch.exp(eta)
    p = -torch.expm1(-m)
    score = y * m * torch.exp(-m) / p - (1 - y) * m
    return y - score, y * torch.log(p) - (1 - y) * m


def logistic_hook(eta, yv):
    return torch.sigmoid(eta), yv * eta - torch.nn.functional.softplus(eta)


LINKS = {"cloglog": cloglog, "logistic_hook": logistic_hook}
BUILTIN = """struct TracedLink {{
  template <bool WANT_LL>
  static __device__ __forceinline__ float residual(float nu, float eta,
                                                   float y, float* ll) {{
    return link_residual<{code}, WANT_LL>(nu, eta, y, ll);
  }}
}};
"""


# f64div's quotient: div_rn's f64 path for every operand
F64_DIV = """__device__ __forceinline__ float div_f64(float a, float b) {
  const uint32_t ua = __float_as_uint(a) & 0x7fffffffu;
  const uint32_t ub = __float_as_uint(b) & 0x7fffffffu;
  if (ua - 1u >= 0x7f7fffffu || ub - 1u >= 0x7f7fffffu) {
    const float s = ub == 0u ? __int_as_float(0x7f800000)
                    : ub > 0x7f800000u ? b : ub == 0x7f800000u ? 0.0f : 1.0f;
    return __fmul_rn(a, copysignf(s, b));
  }
  const double da = a, db = b;
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(db));
  double e = fma(-db, r, 1.0);
  r = fma(r, e, r);
  e = fma(-db, r, 1.0);
  r = fma(r, e, r);
  const double q = da * r;
  return __double2float_rn(fma(fma(-db, q, da), r, q));
}
"""


def functor(spec):
    spec = spec.split("@", 1)[0].split("%", 1)[0]
    kind, arg = spec.split(":", 1)
    if kind == "traced":
        return lc.trace_link(LINKS[arg]).source, LINKS[arg]
    if kind == "f64div":
        return F64_DIV + lc.trace_link(LINKS[arg]).source.replace(
            "div_rn(", "div_f64("), LINKS[arg]
    if kind in ("fastdiv", "ieee"):
        return lc.trace_link(LINKS[arg]).source.replace(
            "div_rn(", "__fdividef(" if kind == "fastdiv" else "__fdiv_rn("), \
            LINKS[arg]
    if kind == "builtin":
        names = ("logistic", "poisson", "linear", "probit")
        return BUILTIN.format(code=int(arg)), names[int(arg)]
    return Path(arg).read_text(), "logistic"


def build(variants, dp, headers=None, defines=None):
    """Compile every variant's translation unit at once (``headers`` maps
    a variant's name to the header directory it builds against,
    ``defines`` to a macro it defines)."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in variants.items():
        inc = (headers or {}).get(name) or str(_cuda.CSRC)
        cu = OUT / f"{name}_{dp}.cu"
        cu.write_text(_cuda.link_source(src, dp))
        so = cu.with_suffix(".so")
        procs[name] = (subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS,
             *([f"-D{defines[name]}"] if name in (defines or {}) else []),
             "-shared", "-I", inc, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "C75", "error",
                                       "arning")):
                print(f"  [{name}] {line.strip()}")
        if proc.returncode != 0:
            raise SystemExit(f"build of {name} failed:\n{log}")
        libs[name] = (_cuda._bind_link(ctypes.CDLL(str(so)),
                                       _cuda.glm_body(dp)), so)
    return libs


def sass_census(so):
    """Per kernel of the library: instruction counts by kind."""
    tool = shutil.which("cuobjdump") or str(
        Path(_cuda._nvcc()).parent / "cuobjdump")
    if not Path(tool).exists():
        return "cuobjdump not found"
    out = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                         text=True).stdout
    lines = []
    for block in re.split(r"\n\s*Function : ", out)[1:]:
        name = block.split("\n", 1)[0].strip()
        ins = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", block)
        ops = [i.split()[0] if not i.startswith("@") else i.split()[1]
               for i in ins if i.strip()]
        count = lambda p: sum(o.startswith(p) for o in ops)  # noqa: E731
        lines.append(
            f"{'RT' if 'Lb1E' in name else 'fixed'}: {len(ops)} "
            f"instructions, MUFU {count('MUFU')}, CALL {count('CALL')}, "
            f"BRA {count('BRA')}, HGMMA {count('HGMMA')}, WARPGROUP "
            f"{count('WARPGROUP')}, FFMA {count('FFMA')}, FMUL "
            f"{count('FMUL')}, FADD {count('FADD')}")
    return "; ".join(lines)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="+", help="name=SPEC")
    ap.add_argument("--dp", type=int, default=128)
    ap.add_argument("--chains", type=int, default=16384)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    specs = dict(v.split("=", 1) for v in args.variants)
    made = {name: functor(spec) for name, spec in specs.items()}
    t0 = time.perf_counter()
    libs = build({n: m[0] for n, m in made.items()}, args.dp,
                 {n: sp.split("@", 1)[1] for n, sp in specs.items()
                  if "@" in sp},
                 {n: sp.split("%", 1)[1] for n, sp in specs.items()
                  if "%" in sp})
    print(f"build {time.perf_counter() - t0:.1f} s")
    for name, (_, so) in libs.items():
        print(f"  {name}: {sass_census(so)}")
    dim, n = MODELS[args.dp]
    X, y, beta = make_logistic_regression_data(dim, n, dim)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(50)
    C, dp = args.chains, args.dp
    z = torch.zeros((C, dp), device=dev)
    p = torch.zeros((C, dp), device=dev)
    z[:, :dim] = beta + 0.3 * torch.randn((C, dim), generator=gen, device=dev)
    p[:, :dim] = torch.randn((C, dim), generator=gen, device=dev)
    traj = fl.make_fused_trajectory(X, y, 10.0, 0.01, 4)
    outs = [torch.empty_like(z), torch.empty_like(p),
            torch.empty((C,), device=dev)]
    stream = torch.cuda.current_stream().cuda_stream
    base = (z.data_ptr(), p.data_ptr(), traj.Xb.data_ptr(),
            traj.y.data_ptr(), traj.mask.data_ptr(),
            *(o.data_ptr() for o in outs), C, traj.Xb.shape[0], dp, 4, 0.005,
            0.01, traj.inv_pv)
    lib0 = _cuda.load()
    work = ()
    if _cuda.glm_body(dp) == "two-pass":
        ws = torch.empty((lib0.fused_glm_xwide_workspace_bytes(
            C, traj.Xb.shape[0], dp),), dtype=torch.uint8, device=dev)
        work = (ws.data_ptr(),)
        calls = {"library logistic":
                 lambda: lib0.fused_glm_xwide_trajectory_launch(
                     *base, 0, 0.0, *work, stream)}
    else:
        calls = {"library logistic": lambda: lib0.fused_glm_trajectory_launch(
            *base, 0, 0.0, stream)}
    for name, (lib, _) in libs.items():
        calls[name] = (lambda lib=lib: lib.traced_glm_launch(*base, *work,
                                                             stream))
    ref, first = None, None
    for name, call in calls.items():
        rc = call()
        torch.cuda.synchronize()
        got = [o.clone() for o in outs]
        if rc != 0:
            raise SystemExit(f"{name}: launch failed ({rc})")
        if ref is None:
            ref = got
        elif first is None:
            first = (name, got)
        link = made[name][1] if name in made else "logistic"
        want = fl._fused_trajectory_plain(z, p, traj.Xb, traj.y, traj.mask,
                                          traj.inv_pv, 0.01, 4, link)
        err = max(float((a - b).abs().max()) for a, b in zip(got[:2],
                                                             want[:2]))
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        print(f"{name}: max |dz|, |dp| against its plain version {err:.3e}; "
              f"bit-equal to the library's logistic: {same}")
        if first is not None and name != first[0]:
            eq = [torch.equal(a, b) for a, b in zip(got, first[1])]
            print(f"  {name} against {first[0]}: z, p, U bit-equal {eq}")
    names = list(calls)
    times = {k: [] for k in names}
    for r in range(args.reps):
        for k in (names if r % 2 == 0 else names[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                calls[k]()
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end) / 10)
    for k in names:
        print(f"time {dp} {k}: {np.median(times[k]):.4f} ms (min "
              f"{min(times[k]):.4f}, max {max(times[k]):.4f})")
    # the public wrapper, Python included, on the traced hook
    if "logistic_hook" in {m[1] if isinstance(m[1], str) else
                           m[1].__name__ for m in made.values()}:
        args_h = (traj.Xb, traj.y, traj.mask, traj.inv_pv, 0.01, 4,
                  logistic_hook)
        fl.fused_trajectory_cuda(z, p, *args_h)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            fl.fused_trajectory_cuda(z, p, *args_h)
        host = (time.perf_counter() - t0) / 100
        torch.cuda.synchronize()
        print(f"fused_trajectory_cuda on the traced hook: {1e3 * host:.4f} "
              "ms of host time a call (enqueue, no sync)")


if __name__ == "__main__":
    main()
