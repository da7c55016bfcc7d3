"""ctypes binding for the native draw sink (``runtime/drawsink.cpp``).

The sink is a C++ writer that queues appended draw blocks and writes them
to disk on a background thread, so disk IO overlaps sampling. It is built
at first use with ``g++ -O2 -fPIC -shared -std=c++17 -pthread`` into
``build/mcmc_tpu_torch/`` beside the package (a directory ``.gitignore``
lists), under a name that carries a hash of the source and the flags.
Nothing is built at import.

There is no quiet fallback: when the build fails, :class:`DrawSink`
raises. The pure-Python writer (same file format) runs only when the
caller asks for it with ``DrawSink(..., native=False)``; ``sink.native``
says which writer a sink uses.

The file format is the JAX package's sink's (``mcmc_tpu.runtime``), byte
for byte: a 64-byte header (magic ``MCMCSINK``, version, dtype code, ndim,
the trailing shape, the row count, which ``close`` writes) followed by raw
row-major blocks. A draws file written by either package reads back in the
other.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import struct
import subprocess
import tempfile
import threading

import numpy as np

__all__ = ["DrawSink", "read_draws", "load", "library_path"]

_HERE = pathlib.Path(__file__).resolve().parent
_SRC = _HERE / "drawsink.cpp"
BUILD_DIR = _HERE.parent.parent / "build" / "mcmc_tpu_torch"
CXX = "g++"
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17", "-pthread"]

_MAGIC = b"MCMCSINK"
_HEADER_FMT = "<8sIIII4QQ"  # magic, version, dtype, ndim, reserved, dims[4], n_rows
_HEADER_SIZE = struct.calcsize(_HEADER_FMT)
_DTYPES = {0: np.float32, 1: np.float64}
_DTYPE_CODES = {np.dtype(np.float32): 0, np.dtype(np.float64): 1}

_lib = None
_lib_lock = threading.Lock()


def library_path() -> pathlib.Path:
    """Where the build of the source as it is now lies or will lie."""
    h = hashlib.sha256((CXX + " " + " ".join(CXX_FLAGS)).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"drawsink-{h.hexdigest()[:16]}.so"


def _build() -> pathlib.Path:
    """Compile the sink library if no build of this source exists; the
    compiler writes to a temporary name that is then renamed, so a
    concurrent process never loads a half-written library."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        try:
            r = subprocess.run([CXX, *CXX_FLAGS, str(_SRC), "-o", tmp],
                               capture_output=True, text=True, timeout=300)
        except OSError as e:
            raise RuntimeError(f"the native draw sink could not be built: "
                               f"{CXX!r} did not run ({e})") from e
        if r.returncode != 0:
            raise RuntimeError(f"the native draw sink could not be built "
                               f"({CXX} exited {r.returncode}):\n{r.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load():
    """The bound sink library, built on first call; raises
    ``RuntimeError`` when the build fails."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            lib.drawsink_open.restype = ctypes.c_void_p
            lib.drawsink_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32,
                                          ctypes.c_uint32,
                                          ctypes.POINTER(ctypes.c_uint64)]
            lib.drawsink_append.restype = ctypes.c_int
            lib.drawsink_append.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.c_uint64, ctypes.c_uint64]
            lib.drawsink_flush.restype = None
            lib.drawsink_flush.argtypes = [ctypes.c_void_p]
            lib.drawsink_rows.restype = ctypes.c_uint64
            lib.drawsink_rows.argtypes = [ctypes.c_void_p]
            lib.drawsink_close.restype = None
            lib.drawsink_close.argtypes = [ctypes.c_void_p]
            _lib = lib
        return _lib


class DrawSink:
    """Append-only draw storage. ``row_shape`` is the trailing shape of one
    draw (e.g. ``(n_chains, n_vals)``); appended arrays have shape
    ``(k, *row_shape)``. The native writer copies each appended block and
    writes it on a background thread; ``flush`` waits until every block
    appended so far has reached the OS. ``native=False`` selects the
    pure-Python writer of the same format."""

    def __init__(self, path, row_shape, dtype=np.float32, native=True):
        self.path = str(path)
        self.row_shape = tuple(int(d) for d in row_shape)
        if len(self.row_shape) > 4:
            raise ValueError("row_shape supports at most 4 dims")
        self.dtype = np.dtype(dtype)
        if self.dtype not in _DTYPE_CODES:
            raise ValueError(f"unsupported dtype {self.dtype}")
        self._code = _DTYPE_CODES[self.dtype]
        self._rows = 0
        self._handle = None
        self._file = None
        self._native = bool(native)
        if native:
            self._lib = load()
            dims = (ctypes.c_uint64 * 4)(
                *(list(self.row_shape) + [0] * (4 - len(self.row_shape))))
            self._handle = self._lib.drawsink_open(
                self.path.encode(), self._code, len(self.row_shape), dims)
            if self._handle is None:
                raise OSError(f"the native draw sink could not open "
                              f"{self.path}")
        else:
            self._file = open(self.path, "wb")
            self._write_header(0)

    def _write_header(self, n_rows):
        dims = list(self.row_shape) + [0] * (4 - len(self.row_shape))
        self._file.write(struct.pack(
            _HEADER_FMT, _MAGIC, 1, self._code, len(self.row_shape), 0,
            *dims, n_rows,
        ))

    @property
    def native(self) -> bool:
        """True when the C++ writer is in use."""
        return self._native

    @property
    def rows(self) -> int:
        if self._handle is not None:
            return int(self._lib.drawsink_rows(self._handle))
        return self._rows

    def append(self, arr):
        """Queue ``arr`` ``(k, *row_shape)``; the native writer copies it
        before returning, so the caller may reuse the buffer."""
        arr = np.ascontiguousarray(arr, self.dtype)
        if arr.shape[1:] != self.row_shape:
            raise ValueError(f"expected trailing shape {self.row_shape}, "
                             f"got {arr.shape[1:]}")
        if self._handle is not None:
            rc = self._lib.drawsink_append(
                self._handle, arr.ctypes.data_as(ctypes.c_void_p),
                arr.shape[0], arr.nbytes,
            )
            if rc != 0:
                raise IOError("native drawsink append failed")
        elif self._file is not None:
            self._file.write(arr.tobytes())
            self._rows += arr.shape[0]
        else:
            raise ValueError("append to a closed draw sink")

    def flush(self):
        if self._handle is not None:
            self._lib.drawsink_flush(self._handle)
        elif self._file is not None:
            self._file.flush()

    def close(self):
        if self._handle is not None:
            self._lib.drawsink_close(self._handle)
            self._handle = None
        elif self._file is not None:
            n = self._rows
            self._file.seek(0)
            self._write_header(n)
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_draws(path, mmap=True, mode="r"):
    """Read a sink file back as a numpy array of shape (n_rows, *row_shape):
    a ``numpy.memmap`` opened with ``mode`` (``"c"``: copy-on-write, which
    a tensor may wrap) or, with ``mmap=False``, an array in memory.

    If the header's row count was never finalized (the writing process was
    killed before ``close()``), the count is recovered from the file size —
    any torn trailing partial row is dropped."""
    with open(path, "rb") as f:
        raw = f.read(_HEADER_SIZE)
    magic, _version, code, ndim, _res, d0, d1, d2, d3, n_rows = \
        struct.unpack(_HEADER_FMT, raw)
    if magic != _MAGIC:
        raise ValueError(f"{path} is not a draw-sink file")
    dtype = _DTYPES[code]
    row_shape = tuple(int(d) for d in (d0, d1, d2, d3)[:ndim])
    row_bytes = int(np.prod(row_shape)) * np.dtype(dtype).itemsize
    data_bytes = os.path.getsize(path) - _HEADER_SIZE
    rows_on_disk = data_bytes // row_bytes if row_bytes else 0
    if n_rows == 0 and rows_on_disk > 0:
        n_rows = rows_on_disk          # crash recovery
    n_rows = min(n_rows, rows_on_disk)  # never trust header past the data
    shape = (n_rows,) + row_shape
    if mmap and n_rows > 0:
        return np.memmap(path, dtype=dtype, mode=mode, offset=_HEADER_SIZE,
                         shape=shape)
    data = np.fromfile(path, dtype=dtype, offset=_HEADER_SIZE,
                       count=int(np.prod(shape)))
    return data.reshape(shape)
