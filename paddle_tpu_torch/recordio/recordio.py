"""RecordIO bindings (port of paddle_tpu/recordio/recordio.py): ctypes
over the native library, with a pure-Python path.

The native library (the port's own `recordio.cc`) is compiled on demand
with g++ by `utils/native.py` into `build/paddle_tpu_torch/native/` and
loaded with ctypes (a flat C ABI; no pybind11). The pure-Python path
implements the identical on-disk format, so files interchange freely,
between the two paths and between the two packages, and everything
still works without a toolchain. `native_error()` says why the native
library is unavailable, when it is.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib
from typing import Iterable, Iterator, Optional

from paddle_tpu_torch.utils.native import LazyLib

_MAGIC = 0x50545231
_HEAD = struct.Struct("<6I")   # magic, compressor, nrec, raw, payload, crc

def _bind(lib: ctypes.CDLL) -> None:
    lib.rio_writer_open.restype = ctypes.c_void_p
    lib.rio_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32,
                                    ctypes.c_uint32]
    lib.rio_write.restype = ctypes.c_int
    lib.rio_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                              ctypes.c_uint32]
    lib.rio_writer_close.restype = ctypes.c_int
    lib.rio_writer_close.argtypes = [ctypes.c_void_p]
    lib.rio_scanner_open.restype = ctypes.c_void_p
    lib.rio_scanner_open.argtypes = [ctypes.c_char_p]
    lib.rio_next.restype = ctypes.c_int64
    lib.rio_next.argtypes = [ctypes.c_void_p,
                             ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte))]
    lib.rio_error.restype = ctypes.c_char_p
    lib.rio_error.argtypes = [ctypes.c_void_p]
    lib.rio_scanner_close.restype = None
    lib.rio_scanner_close.argtypes = [ctypes.c_void_p]
    lib.rio_count.restype = ctypes.c_int64
    lib.rio_count.argtypes = [ctypes.c_char_p]
    lib.rio_prefetch_open.restype = ctypes.c_void_p
    lib.rio_prefetch_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    lib.rio_prefetch_next.restype = ctypes.c_int64
    lib.rio_prefetch_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte))]
    lib.rio_prefetch_error.restype = ctypes.c_char_p
    lib.rio_prefetch_error.argtypes = [ctypes.c_void_p]
    lib.rio_prefetch_close.restype = None
    lib.rio_prefetch_close.argtypes = [ctypes.c_void_p]


_lazy = LazyLib(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "recordio.cc"),
    "librecordio.so", _bind, extra_flags=("-lz",))


def _native() -> Optional[ctypes.CDLL]:
    return _lazy.get()


def native_available() -> bool:
    return _native() is not None


def native_error() -> Optional[str]:
    """Why the native library did not build or load (the tail of g++'s
    output), or None when it is available."""
    return None if native_available() else _lazy.error


class Writer:
    """Append records to a recordio file (Fluid's recordio/writer.h)."""

    def __init__(self, path: str, compress: bool = True,
                 max_chunk_bytes: int = 1 << 20,
                 force_python: bool = False):
        self.path = path
        self._compress = compress
        self._max = max_chunk_bytes
        self._closed = False
        lib = None if force_python else _native()
        self._lib = lib
        if lib is not None:
            self._h = lib.rio_writer_open(path.encode(), int(compress),
                                          max_chunk_bytes)
            if not self._h:
                raise OSError(f"cannot open {path!r} for writing")
        else:
            self._f = open(path, "wb")
            self._buf = bytearray()
            self._nrec = 0

    def write(self, record: bytes) -> None:
        if self._closed:
            raise ValueError("writer is closed")
        record = bytes(record)
        if self._lib is not None:
            if self._lib.rio_write(self._h, record, len(record)) != 0:
                raise OSError("recordio write failed")
            return
        self._buf += struct.pack("<I", len(record)) + record
        self._nrec += 1
        if len(self._buf) >= self._max:
            self._flush()

    def _flush(self) -> None:
        if not self._nrec:
            return
        raw = bytes(self._buf)
        payload = zlib.compress(raw) if self._compress else raw
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        self._f.write(_HEAD.pack(_MAGIC, int(self._compress), self._nrec,
                                 len(raw), len(payload), crc))
        self._f.write(payload)
        self._buf = bytearray()
        self._nrec = 0

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._lib is not None:
            if self._lib.rio_writer_close(self._h) != 0:
                raise OSError("recordio close/flush failed")
        else:
            self._flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Scanner:
    """Iterate records of a recordio file (Fluid's recordio/scanner.h).
    Raises IOError on CRC/corruption; a torn final chunk from a crashed
    writer surfaces as corruption, records before it are served."""

    def __init__(self, path: str, force_python: bool = False):
        self.path = path
        lib = None if force_python else _native()
        self._lib = lib
        if lib is not None:
            self._h = lib.rio_scanner_open(path.encode())
            if not self._h:
                raise OSError(f"cannot open {path!r}")
        else:
            self._f = open(path, "rb")
            self._chunk = b""
            self._pos = 0
        self._done = False

    def __iter__(self) -> Iterator[bytes]:
        return self

    def __next__(self) -> bytes:
        if self._done:
            raise StopIteration
        if self._lib is not None:
            out = ctypes.POINTER(ctypes.c_ubyte)()
            n = self._lib.rio_next(self._h, ctypes.byref(out))
            if n == -1:
                self.close()
                raise StopIteration
            if n == -2:
                msg = self._lib.rio_error(self._h).decode()
                self.close()
                raise IOError(f"recordio corruption in {self.path!r}: {msg}")
            return ctypes.string_at(out, n)
        # pure-python path
        while self._pos >= len(self._chunk):
            head = self._f.read(_HEAD.size)
            if not head:
                self.close()
                raise StopIteration
            if len(head) < _HEAD.size:
                self.close()
                raise IOError("torn chunk header")
            magic, comp, nrec, raw_len, payload_len, crc = _HEAD.unpack(head)
            if magic != _MAGIC:
                self.close()
                raise IOError("bad chunk magic")
            payload = self._f.read(payload_len)
            if len(payload) != payload_len:
                self.close()
                raise IOError("torn chunk payload")
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                self.close()
                raise IOError("chunk crc mismatch")
            self._chunk = zlib.decompress(payload) if comp else payload
            self._pos = 0
        if self._pos + 4 > len(self._chunk):
            raise IOError("truncated record length")
        (n,) = struct.unpack_from("<I", self._chunk, self._pos)
        self._pos += 4
        rec = self._chunk[self._pos:self._pos + n]
        if len(rec) != n:
            raise IOError("truncated record body")
        self._pos += n
        return rec

    def close(self) -> None:
        if self._done:
            return
        self._done = True
        if self._lib is not None:
            self._lib.rio_scanner_close(self._h)
        else:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def count(path: str) -> int:
    """Number of records (chunk-header index pass; no payload decode in the
    native path)."""
    lib = _native()
    if lib is not None:
        n = lib.rio_count(path.encode())
        if n < 0:
            raise OSError(f"cannot open {path!r}")
        return int(n)
    total = 0
    with open(path, "rb") as f:
        while True:
            head = f.read(_HEAD.size)
            if len(head) < _HEAD.size:
                break
            magic, _, nrec, _, payload_len, _ = _HEAD.unpack(head)
            if magic != _MAGIC:
                break
            total += nrec
            f.seek(payload_len, os.SEEK_CUR)
    return total


def write_recordio(path: str, records: Iterable[bytes],
                   compress: bool = True) -> int:
    """Bulk write; returns record count (recordio_writer.py capability)."""
    n = 0
    with Writer(path, compress=compress) as w:
        for r in records:
            w.write(r)
            n += 1
    return n


def recordio_reader(path: str):
    """Paddle-style reader decorator over a recordio file (the
    create_recordio_file_reader op capability)."""
    def reader():
        with Scanner(path) as s:
            for rec in s:
                yield rec
    return reader


class PrefetchScanner:
    """Multi-file background-prefetch reader over the native library.

    Fluid's async C++ reader tier (open_files_op.cc multi-file parallel
    reader + buffered_reader.h): `n_threads` workers scan the files
    concurrently and fill a bounded queue; iteration pops records
    without blocking on the filesystem. Record order interleaves across
    files (like Fluid's open_files). Falls back to sequential
    per-file scanning when the native library is unavailable.
    """

    def __init__(self, paths, n_threads: int = 2, queue_capacity: int = 1024,
                 force_python: bool = False):
        self.paths = [os.fspath(p) for p in paths]
        lib = None if force_python else _native()
        self._lib = lib
        self._h = None
        if lib is not None:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths])
            self._h = lib.rio_prefetch_open(arr, len(self.paths),
                                            n_threads, queue_capacity)
            if not self._h:
                raise IOError(f"cannot open prefetch over {self.paths}")

    def __iter__(self):
        if self._lib is None:
            for p in self.paths:
                yield from Scanner(p, force_python=True)
            return
        out = ctypes.POINTER(ctypes.c_ubyte)()
        try:
            while self._h:              # closed/exhausted -> stop cleanly
                n = self._lib.rio_prefetch_next(self._h, ctypes.byref(out))
                if n == -1:
                    return
                if n == -2:
                    raise IOError(
                        self._lib.rio_prefetch_error(self._h).decode())
                yield ctypes.string_at(out, n)
        finally:
            # auto-close like Scanner — and on ANY exit (exhaustion,
            # error, abandoned iteration/GeneratorExit) join the workers
            # and free queued records
            self.close()

    def __del__(self):
        self.close()

    def close(self):
        if self._lib is not None and self._h:
            self._lib.rio_prefetch_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def prefetch_reader(paths, n_threads: int = 2, queue_capacity: int = 1024):
    """Paddle-style reader decorator over PrefetchScanner (the
    open_files + double-buffer capability as one reader)."""
    def reader():
        with PrefetchScanner(paths, n_threads, queue_capacity) as sc:
            yield from sc
    return reader
