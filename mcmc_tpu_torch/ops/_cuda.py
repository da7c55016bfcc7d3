"""Build and bind the package's CUDA kernels.

Every source (``*.cu``) under ``mcmc_tpu_torch/csrc`` is compiled with
``nvcc`` for Hopper (``sm_90a``), one compiler process per source and all
started together, and the objects are linked into one shared library with a
plain C interface, at first use, into ``build/mcmc_tpu_torch/`` beside the
package (a directory ``.gitignore`` lists). The library's file name carries
a hash of every file the build reads (sources and the headers ``*.cuh``
they include) and the flags, so an edited file is rebuilt and an unchanged
tree is loaded as built. The library is bound with ``ctypes``:
pointers and the stream travel as ``c_void_p``.

The kernels take every padded width that is a multiple of 128
(:func:`takes_dim_padded`); each picks its body by width. The GLM trajectory
runs ``csrc/fused_glm_body.cuh`` at 128 padded columns, the cluster body
``csrc/fused_glm_wide_body.cuh`` at 256 to :data:`CLUSTER_MAX_DIM_PADDED`
(1,024), and the two-pass body ``csrc/fused_glm_xwide_body.cuh`` past it;
the Gaussian trajectory ``csrc/fused_gaussian_trajectory.cu`` at 128,
``fused_gaussian_trajectory_wide.cu`` to 1,024 and
``fused_gaussian_trajectory_xwide.cu`` past it. The bodies past 1,024 take
a workspace in device memory, which the caller allocates (its size from the
library's ``*_workspace_bytes``).

A GLM link traced from torch (:mod:`mcmc_tpu_torch.ops.link_codegen`) is
built by :func:`build_link` into a library of its own: a generated
translation unit that includes the body the width needs and instantiates
it on the traced functor, compiled with the same flags into
``build/mcmc_tpu_torch/link-<hash>.so`` (the hash covers the generated
source, the headers and the flags) and bound with ``ctypes`` the same way.

Nothing here runs at import: :func:`load` builds and loads on first call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

__all__ = ["load", "build", "library_path", "sources", "headers",
           "CLUSTER_MAX_DIM_PADDED", "takes_dim_padded",
           "GAUSSIAN_LIVE_WIDTHS", "WIDE_LIVE_MULTIPLE", "build_seconds",
           "build_log", "build_link", "link_source", "link_library_path",
           "link_builds"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "mcmc_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v"]
# the widest padded model of the GLM kernel's cluster body and of the
# Gaussian kernel's wide body (csrc: kMaxDimPadded): at 128 columns the GLM
# kernel runs its warpgroup body, to this width its cluster body of one
# block per 128-column panel (at most eight, the portable cluster size),
# past it its two-pass body; the Gaussian kernel streams P from L2 past 128
# and runs its products on the tensor cores (3xTF32) past this width
CLUSTER_MAX_DIM_PADDED = 1024
# the live widths the Gaussian kernel is instantiated for at 128 padded
# columns: a launch runs the smallest that holds the model's dimension
# (csrc: fused_gaussian_trajectory_launch); past 128 columns its live width
# is the dimension rounded up to a multiple of WIDE_LIVE_MULTIPLE (csrc:
# fused_gaussian_wide_launch)
GAUSSIAN_LIVE_WIDTHS = (32, 64, 104, 128)
WIDE_LIVE_MULTIPLE = 16


def glm_body(dp: int) -> str:
    """The GLM kernel's body for a model padded to ``dp`` columns:
    ``"128"`` (its warpgroup body), ``"cluster"`` (256 to
    :data:`CLUSTER_MAX_DIM_PADDED`) or ``"two-pass"`` (past it)."""
    return "128" if dp <= 128 else "cluster" \
        if dp <= CLUSTER_MAX_DIM_PADDED else "two-pass"


def takes_dim_padded(dp: int) -> bool:
    """Whether the kernels take a model padded to ``dp`` columns: every
    multiple of 128, as the JAX package pads (only device memory limits
    the width)."""
    return dp % 128 == 0 and dp >= 128


_lib = None
build_seconds = None   # wall time of the build this process ran, if any
build_log = ""         # its compiler output (ptxas: registers, spills)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source at first use")
    return found


def sources():
    """The kernel sources, in a fixed order."""
    return sorted(CSRC.glob("*.cu"))


def headers():
    """The headers the sources include, in a fixed order."""
    return sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the build of the files as they are now lies or will lie: the
    name carries a hash of the flags and of every source and header."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sources() + headers():
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel library if no build of these files exists;
    return its path. The link writes to a temporary name and renames, so a
    concurrent process never loads a half-written library."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        return out
    srcs = sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in srcs]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        for src, p, log in zip(srcs, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}) on "
                                   f"{src.name}:\n{log}")
        lib = Path(tmp) / "kernels.so"
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(lib),
             *map(str, objs)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(lib, out)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    return out


def load():
    """The bound kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # z, p, X, y, mask, z_out, p_out, u_out; n_chains, n_rows,
        # dim_padded, n_leap; half_eps, eps, inv_pv; link, link_param; stream
        fn = lib.fused_glm_trajectory_launch
        fn.argtypes = [vp] * 8 + [ci] * 4 + [cf] * 3 + [ci, cf, vp]
        fn.restype = ci
        # the same with eps and inv_mass as device pointers in place of
        # half_eps, eps
        fn = lib.fused_glm_trajectory_rt_launch
        fn.argtypes = [vp] * 8 + [vp, vp] + [ci] * 4 + [cf] + [ci, cf, vp]
        fn.restype = ci
        # z, p, P, mean, eps, z_out, p_out, u_out; n_chains, dim_padded,
        # dim, n_leap; stream
        fn = lib.fused_gaussian_trajectory_launch
        fn.argtypes = [vp] * 8 + [ci] * 4 + [vp]
        fn.restype = ci
        # the bodies past 1,024 columns: the same arguments, and the
        # workspace before the stream; its size from n_chains, n_rows,
        # dim_padded (GLM) or n_chains, dim (Gaussian)
        ll = ctypes.c_longlong
        fn = lib.fused_glm_xwide_trajectory_launch
        fn.argtypes = [vp] * 8 + [ci] * 4 + [cf] * 3 + [ci, cf, vp, vp]
        fn.restype = ci
        fn = lib.fused_glm_xwide_trajectory_rt_launch
        fn.argtypes = [vp] * 8 + [vp, vp] + [ci] * 4 + [cf] + [ci, cf, vp, vp]
        fn.restype = ci
        lib.fused_glm_xwide_workspace_bytes.argtypes = [ci] * 3
        lib.fused_glm_xwide_workspace_bytes.restype = ll
        fn = lib.fused_gaussian_xwide_trajectory_launch
        fn.argtypes = [vp] * 8 + [ci] * 4 + [vp, vp]
        fn.restype = ci
        lib.fused_gaussian_xwide_workspace_bytes.argtypes = [ci] * 2
        lib.fused_gaussian_xwide_workspace_bytes.restype = ll
        # n_chains, dim, int[5] out: blocks, chain tiles, blocks a tile,
        # the blocks the card runs at once, waves
        lib.fused_gaussian_xwide_grid.argtypes = [ci, ci, vp]
        lib.fused_gaussian_xwide_grid.restype = ci
        lib.fused_glm_error_string.argtypes = [ci]
        lib.fused_glm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# The translation unit of a traced link: the body the width needs,
# instantiated on the traced functor, behind the library's fixed-step and
# run-time-parameter launch signatures without the link code and its
# parameter (fused_glm_trajectory.cu's entries; the two-pass body's also
# take its workspace before the stream, and give its size).
_LINK_TU = """// Generated by mcmc_tpu_torch/ops/_cuda.py (build_link): the fused GLM
// trajectory's {body} on a link traced from torch.
#include "{header}"

namespace {{
{functor}
bool args_ok(int n_chains, int n_rows, int dim_padded, int n_leap) {{
  return glm_launch_args_ok(n_chains, n_rows, n_leap) && {width_ok};
}}
}}  // namespace

extern "C" int traced_glm_launch(
    const void* z, const void* p, const void* X, const void* y,
    const void* mask, void* z_out, void* p_out, void* u_out, int n_chains,
    int n_rows, int dim_padded, int n_leap, float half_eps, float eps,
    float inv_pv, {work_param}void* stream) {{
  if (!args_ok(n_chains, n_rows, dim_padded, n_leap))
    return (int)cudaErrorInvalidValue;
  return (int){ns}::launch<TracedLink, false>(
      z, p, X, y, mask, nullptr, nullptr, z_out, p_out, u_out,
      {work_arg}n_chains, n_rows, {dp_arg}n_leap, half_eps, eps, inv_pv, 0,
      0.0f, static_cast<cudaStream_t>(stream));
}}

extern "C" int traced_glm_rt_launch(
    const void* z, const void* p, const void* X, const void* y,
    const void* mask, void* z_out, void* p_out, void* u_out, const void* eps,
    const void* inv_mass, int n_chains, int n_rows, int dim_padded,
    int n_leap, float inv_pv, {work_param}void* stream) {{
  if (eps == nullptr || inv_mass == nullptr ||
      !args_ok(n_chains, n_rows, dim_padded, n_leap))
    return (int)cudaErrorInvalidValue;
  return (int){ns}::launch<TracedLink, true>(
      z, p, X, y, mask, eps, inv_mass, z_out, p_out, u_out,
      {work_arg}n_chains, n_rows, {dp_arg}n_leap, 0.0f, 0.0f, inv_pv, 0,
      0.0f, static_cast<cudaStream_t>(stream));
}}

extern "C" const char* traced_glm_error_string(int code) {{
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}}
{extra}"""

# what the two-pass body's translation unit adds: its workspace's size
_XWIDE_EXTRA = """
extern "C" long long traced_glm_workspace_bytes(int n_chains, int n_rows,
                                                int dim_padded) {
  return (long long)glm_xwide::workspace_bytes(n_chains, n_rows, dim_padded);
}
"""

_link_libs = {}        # (functor source, glm_body) -> the library
_link_lock = threading.Lock()
# library path -> (seconds, compiler output) of each traced link this
# process built: nvcc's time and ptxas's registers, spills and notes
link_builds = {}


def link_source(functor_source: str, dim_padded: int) -> str:
    """The generated translation unit of a traced link's functor for the
    body that runs a model padded to ``dim_padded`` columns
    (:func:`glm_body`)."""
    plain = {"work_param": "", "work_arg": "", "extra": ""}
    body = glm_body(dim_padded)
    if body == "two-pass":
        return _LINK_TU.format(
            body="two-pass body (dim_padded past 1024)",
            header="fused_glm_xwide_body.cuh", functor=functor_source,
            ns="glm_xwide", dp_arg="dim_padded, ",
            width_ok="dim_padded > kMaxDimPadded &&\n"
                     "         dim_padded % 128 == 0",
            work_param="void* work, ", work_arg="work, ",
            extra=_XWIDE_EXTRA)
    if body == "cluster":
        return _LINK_TU.format(
            body="cluster body (dim_padded 256 to 1024)",
            header="fused_glm_wide_body.cuh", functor=functor_source,
            ns="glm_wide", dp_arg="dim_padded, ",
            width_ok="dim_padded > 128 &&\n"
                     "         dim_padded <= kMaxDimPadded && "
                     "dim_padded % 128 == 0", **plain)
    return _LINK_TU.format(
        body="body at dim_padded 128", header="fused_glm_body.cuh",
        functor=functor_source, ns="glm128", dp_arg="",
        width_ok="dim_padded == 128", **plain)


def link_library_path(source: str) -> Path:
    """Where the build of a generated translation unit lies or will lie: the
    name carries a hash of the flags, the source and every header."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(source.encode())
    for f in headers():
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"link-{h.hexdigest()[:16]}.so"


def _bind_link(lib, body):
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # the two-pass body's workspace, before the stream
    work = [vp] if body == "two-pass" else []
    # z, p, X, y, mask, z_out, p_out, u_out; n_chains, n_rows, dim_padded,
    # n_leap; half_eps, eps, inv_pv; stream
    fn = lib.traced_glm_launch
    fn.argtypes = [vp] * 8 + [ci] * 4 + [cf] * 3 + work + [vp]
    fn.restype = ci
    # the same with eps and inv_mass as device pointers in place of
    # half_eps, eps
    fn = lib.traced_glm_rt_launch
    fn.argtypes = [vp] * 10 + [ci] * 4 + [cf] + work + [vp]
    fn.restype = ci
    if work:
        lib.traced_glm_workspace_bytes.argtypes = [ci] * 3
        lib.traced_glm_workspace_bytes.restype = ctypes.c_longlong
    lib.traced_glm_error_string.argtypes = [ci]
    lib.traced_glm_error_string.restype = ctypes.c_char_p
    return lib


def build_link(functor_source: str, dim_padded: int):
    """The bound library of a traced link's functor on the body that runs
    a model padded to ``dim_padded`` columns (:func:`glm_body`), compiled at
    first use (nvcc's time is printed to standard error) and shared by
    every link with the same generated source. A failed build raises;
    nothing falls back. The compile writes to a temporary name and renames,
    so a concurrent process never loads a half-written library; threads
    may build at once."""
    body = glm_body(dim_padded)
    key = (functor_source, body)
    lib = _link_libs.get(key)   # every launch passes here: no hashing
    if lib is not None:
        return lib
    source = link_source(functor_source, dim_padded)
    out = link_library_path(source)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            cu = Path(tmp) / (out.stem + ".cu")
            cu.write_text(source)
            so = Path(tmp) / out.name
            r = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-shared", "-I", str(CSRC), "-o",
                 str(so), str(cu)], capture_output=True, text=True)
            log = r.stdout + r.stderr
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed ({r.returncode}) on the "
                                   f"traced link {out.stem}:\n{log}")
            os.replace(so, out)
        seconds = time.perf_counter() - t0
        with _link_lock:
            link_builds[out] = (seconds, log)
        print(f"mcmc_tpu_torch: built the traced link {out.name} "
              f"({body} body) in {seconds:.1f} s", file=sys.stderr)
    lib = _bind_link(ctypes.CDLL(str(out)), body)
    with _link_lock:
        return _link_libs.setdefault(key, lib)
