"""The port's draw sink (``mcmc_tpu_torch.runtime``): the native writer,
the pure-Python writer the caller asks for, the file format shared with the
JAX package's sink byte for byte (each package reads the other's files),
crash recovery, and a failed native build that raises instead of falling
back."""

import numpy as np
import pytest
import torch

from mcmc_tpu.runtime import DrawSink as JSink
from mcmc_tpu.runtime import read_draws as jread
from mcmc_tpu_torch.runtime import DrawSink, drawsink, read_draws


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for every test here: the tests run in several
    worker processes at once, and torch's default of a thread per core
    oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blocks(dtype=np.float32):
    rng = np.random.default_rng(0)
    return [rng.standard_normal((k, 3, 2)).astype(dtype) for k in (4, 1, 7)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_native_round_trip(tmp_path, dtype):
    """Blocks appended to the native sink read back equal, memmapped and in
    memory, with their dtype; the sink says it is native."""
    path = tmp_path / "d.bin"
    blocks = _blocks(dtype)
    with DrawSink(path, (3, 2), dtype) as sink:
        assert sink.native
        for b in blocks:
            sink.append(b)
        sink.flush()
        assert sink.rows == 12
    want = np.concatenate(blocks)
    for mmap in (True, False):
        got = read_draws(path, mmap=mmap)
        assert got.dtype == dtype and got.shape == (12, 3, 2)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="trailing shape"):
        with DrawSink(tmp_path / "e.bin", (3, 2)) as sink:
            sink.append(np.zeros((2, 2, 3), np.float32))


def test_python_writer_writes_the_same_bytes(tmp_path):
    """``native=False`` selects the Python writer, which writes the native
    writer's file byte for byte."""
    for native in (True, False):
        with DrawSink(tmp_path / f"{native}.bin", (3, 2),
                      native=native) as sink:
            assert sink.native == native
            for b in _blocks():
                sink.append(b)
    assert (tmp_path / "True.bin").read_bytes() == \
        (tmp_path / "False.bin").read_bytes()


def test_files_interchange_with_the_jax_sink(tmp_path):
    """A file the port writes reads back through the JAX package's
    ``read_draws``, and one the JAX package's sink writes through the
    port's; the two sinks' files are the same bytes."""
    blocks = _blocks()
    with DrawSink(tmp_path / "port.bin", (3, 2)) as sink:
        for b in blocks:
            sink.append(b)
    with JSink(tmp_path / "jax.bin", (3, 2)) as sink:
        for b in blocks:
            sink.append(b)
    want = np.concatenate(blocks)
    np.testing.assert_array_equal(jread(tmp_path / "port.bin"), want)
    np.testing.assert_array_equal(read_draws(tmp_path / "jax.bin"), want)
    assert (tmp_path / "port.bin").read_bytes() == \
        (tmp_path / "jax.bin").read_bytes()


@pytest.mark.parametrize("native", [True, False])
def test_unclosed_sink_recovered(tmp_path, native):
    """A writer that dies before ``close()`` leaves the header's row count
    at 0: ``read_draws`` recovers the rows from the file size and drops a
    torn trailing row."""
    path = tmp_path / "crash.bin"
    sink = DrawSink(path, (2, 3), native=native)
    data = np.arange(18, dtype=np.float32).reshape(3, 2, 3)
    sink.append(data)
    sink.flush()                 # on disk, never closed
    np.testing.assert_array_equal(read_draws(path, mmap=False), data)
    with open(path, "ab") as f:
        f.write(b"\x00" * 7)
    assert read_draws(path, mmap=False).shape == (3, 2, 3)
    np.testing.assert_array_equal(jread(path, mmap=False), data)
    sink.close()


def test_failed_build_raises(tmp_path, monkeypatch):
    """With a compiler that does not run, the native sink raises and no
    file is written by a fallback; the Python writer still works when asked
    for."""
    monkeypatch.setattr(drawsink, "_lib", None)
    monkeypatch.setattr(drawsink, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(drawsink, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="could not be built"):
        DrawSink(tmp_path / "d.bin", (2,))
    assert not (tmp_path / "d.bin").exists()
    monkeypatch.setattr(drawsink, "CXX", "false")   # runs, exits 1
    with pytest.raises(RuntimeError, match="exited 1"):
        drawsink.load()
    with DrawSink(tmp_path / "p.bin", (2,), native=False) as sink:
        sink.append(np.ones((3, 2), np.float32))
    np.testing.assert_array_equal(read_draws(tmp_path / "p.bin"),
                                  np.ones((3, 2), np.float32))
