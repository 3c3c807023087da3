"""The port's RecordIO (`paddle_tpu_torch.recordio`) against
tests/test_recordio.py's fourteen tests, both implementations (the
port's native C++ library over ctypes, and pure Python), plus the
interchange with the JAX package: a file written by either package, on
either path, compressed or not, reads in the other on both paths, and
all four writers write the same bytes. Also the build scaffold
(`utils/native.py`): the port's libraries live under its own build
directory, named by a hash of source and flags, and a failed build
keeps g++'s message."""

import os
import subprocess
import sys

import numpy as np
import pytest

from paddle_tpu.recordio import recordio as JR
from paddle_tpu_torch.recordio import (
    PrefetchScanner, Scanner, Writer, count, native_available,
    native_error, prefetch_reader, recordio_reader, write_recordio)
from paddle_tpu_torch.recordio import recordio as R
from paddle_tpu_torch.utils import native

RECORDS = [b"hello", b"", b"x" * 10000, bytes(range(256)) * 7, b"tail"]


# ----------------------------------------- tests/test_recordio.py mirrors

@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("force_python", [False, True])
def test_roundtrip(tmp_path, compress, force_python):
    p = str(tmp_path / "f.rio")
    with Writer(p, compress=compress, force_python=force_python) as w:
        for r in RECORDS:
            w.write(r)
    got = list(Scanner(p, force_python=force_python))
    assert got == RECORDS
    assert count(p) == len(RECORDS)


def test_cross_implementation(tmp_path):
    """Files written by one implementation read by the other."""
    a = str(tmp_path / "native.rio")
    b = str(tmp_path / "py.rio")
    with Writer(a, force_python=False) as w:
        for r in RECORDS:
            w.write(r)
    with Writer(b, force_python=True) as w:
        for r in RECORDS:
            w.write(r)
    assert list(Scanner(a, force_python=True)) == RECORDS
    assert list(Scanner(b, force_python=False)) == RECORDS
    # identical bytes on disk: the format spec, not an implementation quirk
    assert open(a, "rb").read() == open(b, "rb").read()


def test_native_is_used_when_available():
    assert native_available(), f"g++ is here; native must build: " \
                               f"{native_error()}"
    assert native_error() is None


def test_many_small_records_multi_chunk(tmp_path):
    p = str(tmp_path / "many.rio")
    recs = [f"rec-{i}".encode() for i in range(5000)]
    write_recordio(p, recs)
    assert count(p) == 5000
    assert list(Scanner(p)) == recs


def test_chunk_boundary(tmp_path):
    p = str(tmp_path / "chunky.rio")
    with Writer(p, compress=False, max_chunk_bytes=64) as w:
        for i in range(100):
            w.write(f"record-{i:03d}".encode())
    got = list(Scanner(p))
    assert got[0] == b"record-000" and got[-1] == b"record-099"
    assert len(got) == 100


@pytest.mark.parametrize("force_python", [False, True])
def test_corruption_detected(tmp_path, force_python):
    p = str(tmp_path / "bad.rio")
    write_recordio(p, RECORDS, compress=False)
    data = bytearray(open(p, "rb").read())
    data[30] ^= 0xFF  # flip a payload byte -> crc must catch it
    open(p, "wb").write(bytes(data))
    with pytest.raises(IOError, match="crc"):
        list(Scanner(p, force_python=force_python))


def test_torn_tail_chunk(tmp_path):
    """A crashed writer leaves a torn final chunk: earlier records are
    served, the tear raises (Fluid's recovery semantics)."""
    p = str(tmp_path / "torn.rio")
    with Writer(p, compress=False, max_chunk_bytes=32) as w:
        for i in range(10):
            w.write(f"r{i}".encode())
    data = open(p, "rb").read()
    open(p, "wb").write(data[:-3])  # tear mid-final-chunk
    got = []
    with pytest.raises(IOError):
        for rec in Scanner(p):
            got.append(rec)
    assert got and got[0] == b"r0"


def test_reader_decorator_composes(tmp_path):
    from paddle_tpu_torch.data import readers
    p = str(tmp_path / "r.rio")
    write_recordio(p, [str(i).encode() for i in range(20)])
    r = readers.batch(
        readers.map_readers(lambda b: int(b), recordio_reader(p)), 5)
    batches = list(r())
    assert len(batches) == 4
    np.testing.assert_array_equal(np.asarray(batches[0]), [0, 1, 2, 3, 4])


class TestPrefetch:
    """The native multi-file prefetch reader (Fluid's open_files_op +
    buffered_reader async tier)."""

    def _write_files(self, tmp_path, n_files=3, per_file=50):
        paths, want = [], set()
        for i in range(n_files):
            p = str(tmp_path / f"f{i}.rio")
            recs = [f"file{i}-rec{j}".encode() for j in range(per_file)]
            write_recordio(p, recs)
            paths.append(p)
            want.update(recs)
        return paths, want

    def test_reads_all_records_across_files(self, tmp_path):
        paths, want = self._write_files(tmp_path)
        with PrefetchScanner(paths, n_threads=3, queue_capacity=8) as sc:
            got = list(sc)
        assert set(got) == want
        assert len(got) == len(want)

    def test_prefetch_reader_decorator(self, tmp_path):
        paths, want = self._write_files(tmp_path, n_files=2, per_file=10)
        got = list(prefetch_reader(paths)())
        assert set(got) == want

    def test_python_fallback(self, tmp_path):
        paths, want = self._write_files(tmp_path, n_files=2, per_file=5)
        sc = PrefetchScanner(paths, force_python=True)
        assert set(sc) == want

    def test_backpressure_small_queue(self, tmp_path):
        paths, want = self._write_files(tmp_path, n_files=2, per_file=200)
        with PrefetchScanner(paths, n_threads=2, queue_capacity=2) as sc:
            got = list(sc)
        assert set(got) == want

    def test_early_close_joins_workers(self, tmp_path):
        assert native_available()
        paths, _ = self._write_files(tmp_path, n_files=2, per_file=500)
        sc = PrefetchScanner(paths, n_threads=2, queue_capacity=2)
        it = iter(sc)
        next(it)                        # consume one, workers blocked
        sc.close()                      # must not deadlock
        assert sc._h is None

    def test_abandoned_iteration_and_reiteration_safe(self, tmp_path):
        paths, want = self._write_files(tmp_path, n_files=2, per_file=100)
        sc = PrefetchScanner(paths, n_threads=2, queue_capacity=2)
        for rec in sc:          # abandon mid-stream: finally must close
            break
        assert sc._h is None
        # second iteration after close: empty, no crash
        assert list(sc) == []


# ------------------------------------------- interchange with JAX's package

WRITERS = [("port", False), ("port", True), ("jax", False), ("jax", True)]


def _write(pkg: str, force_python: bool, path: str, compress: bool):
    mod = R if pkg == "port" else JR
    with mod.Writer(path, compress=compress, max_chunk_bytes=4096,
                    force_python=force_python) as w:
        for r in RECORDS * 3:
            w.write(r)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("writer", WRITERS,
                         ids=lambda w: f"{w[0]}-{'py' if w[1] else 'c'}")
def test_files_interchange_with_jax(tmp_path, writer, compress):
    """A file from either package, on either path, reads in both
    packages on both paths; every writer writes the same bytes."""
    pkg, py = writer
    p = str(tmp_path / "w.rio")
    _write(pkg, py, p, compress)
    ref = str(tmp_path / "ref.rio")
    _write("port", True, ref, compress)
    assert open(p, "rb").read() == open(ref, "rb").read()
    for mod in (R, JR):
        for force_python in (False, True):
            assert list(mod.Scanner(p, force_python=force_python)) \
                == RECORDS * 3
        assert mod.count(p) == len(RECORDS) * 3


def test_prefetch_reads_jax_files(tmp_path):
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"j{i}.rio"))
        JR.write_recordio(paths[-1], [f"{i}-{j}".encode()
                                      for j in range(40)])
    got = sorted(PrefetchScanner(paths, n_threads=3))
    assert got == sorted(f"{i}-{j}".encode() for i in range(3)
                         for j in range(40))


# ------------------------------------------------------ the build scaffold

def test_library_lives_in_the_ports_build_dir():
    """Hashed names under build/paddle_tpu_torch/native: never the JAX
    package's `<cache>/librecordio.so`."""
    assert native_available()
    path = R._lazy.path
    assert path.parent == native.BUILD_DIR
    assert path.name.startswith("librecordio-") and path.suffix == ".so"
    assert path == native.library_path(R._lazy._src, "librecordio.so",
                                       ("-lz",))
    from paddle_tpu.utils import native as jax_native
    assert path.parent != os.path.realpath(jax_native.cache_dir())
    assert "build/paddle_tpu_torch/native" in path.as_posix()


def test_flags_and_source_key_the_name(tmp_path):
    src = tmp_path / "a.cc"
    src.write_text('extern "C" int f() { return 1; }\n')
    a = native.library_path(str(src), "liba.so")
    assert native.library_path(str(src), "liba.so", ("-DX",)) != a
    src.write_text('extern "C" int f() { return 2; }\n')
    assert native.library_path(str(src), "liba.so") != a


def test_failed_build_keeps_the_compiler_message(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    src = tmp_path / "broken.cc"
    src.write_text("this is not C++ at all;\n")
    lib = native.LazyLib(str(src), "libbroken.so", lambda lib: None)
    assert lib.get() is None and lib.get() is None      # memoized
    assert "g++" in lib.error and "error" in lib.error
    assert native.build_shared(str(src), "libbroken.so") is None
    with pytest.raises(RuntimeError, match="broken.*error"):
        lib.require("broken")
    assert not list((tmp_path / "native").glob("*.tmp"))


# a builder process: utils/native.py loaded by path (it needs only the
# standard library), building one library into a given directory
_CHILD = """
import importlib.util, pathlib, sys
spec = importlib.util.spec_from_file_location("native", sys.argv[1])
native = importlib.util.module_from_spec(spec)
spec.loader.exec_module(native)
native.BUILD_DIR = pathlib.Path(sys.argv[2])
lib = native.LazyLib(sys.argv[3], "libpar.so", lambda lib: None)
handle = lib.get()
print(lib.path, handle.f())
"""


def test_parallel_builds_are_safe(tmp_path):
    """Processes building one library at once all load a whole file."""
    src = tmp_path / "par.cc"
    src.write_text('extern "C" int f() { return 7; }\n')
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, native.__file__,
         str(tmp_path / "native"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for _ in range(3)]
    outs = [p.communicate(timeout=120)[0].split() for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert len({o[0] for o in outs}) == 1 and all(o[1] == "7" for o in outs)
    assert not list((tmp_path / "native").glob("*.tmp"))
