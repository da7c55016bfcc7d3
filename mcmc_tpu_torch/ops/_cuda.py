"""Build and bind the package's CUDA kernels.

The sources under ``mcmc_tpu_torch/csrc`` are compiled with ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface, at first
use, into ``build/mcmc_tpu_torch/`` beside the package (a directory
``.gitignore`` lists). The library's file name carries a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one is
loaded as built. The library is bound with ``ctypes``: pointers and the
stream travel as ``c_void_p``.

Nothing here runs at import: :func:`load` builds and loads on first call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["load", "build", "DIM_PADDED", "build_seconds", "build_log"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fused_glm_trajectory.cu"
BUILD_DIR = _PKG.parent / "build" / "mcmc_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v"]
# padded model widths the kernel is instantiated for (csrc: launch)
DIM_PADDED = (128, 256)

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


def build() -> Path:
    """Compile the kernel library if no build of this source exists;
    return its path. The compile writes to a temporary name and renames,
    so a concurrent process never loads a half-written library."""
    global build_seconds, build_log
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"fused_glm_trajectory-{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    return out


def load():
    """The bound kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = lib.fused_glm_trajectory_launch
        fn.argtypes = [vp] * 8 + [ci] * 4 + [cf] * 3 + [ci, vp]
        fn.restype = ci
        lib.fused_glm_error_string.argtypes = [ci]
        lib.fused_glm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
