"""Build-on-demand scaffold for the port's native (C++) components (port
of paddle_tpu/utils/native.py).

`recordio/recordio.cc`, `data/datafeed.cc` and `serving/serving.cc`
are compiled with g++ into shared libraries and bound with ctypes (a
flat C ABI, no pybind11); `serving/demo.cc` and `serving/train_demo.cc`
into executables.
This module owns the common mechanics, so a fix lands in one place:

- libraries land in `build/paddle_tpu_torch/native/` at the repository
  root (git-ignored), as the CUDA kernels land in
  `build/paddle_tpu_torch/` (kernels/build.py): the port never loads a
  library that the JAX package built into its own cache directory;
- each library or program is named by a hash of its source and the
  compiler flags (`librecordio-<hash>.so`, `ptpu_demo-<hash>`), so an
  edited source builds anew and two checkouts or packages never load
  each other's build;
- a build writes a temporary file suffixed with its process and thread
  and `os.replace`s it into place, so parallel builders (test workers,
  threads) never load a half-written file;
- a failed build keeps the tail of g++'s output, which `LazyLib.error`
  holds and the callers that insist on the native path raise with.

Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional, Sequence

BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "paddle_tpu_torch" / "native")
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
# an executable's (serving/demo.cc, serving/train_demo.cc)
EXE_FLAGS = ("-O2", "-std=c++17")
# the bytes of g++'s output a failure keeps
ERROR_TAIL = 2000


class NativeBuildError(RuntimeError):
    """A native library did not build or load; the message holds the
    tail of the compiler's output."""


def cache_dir() -> str:
    """The port's native build directory (made if missing)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return str(BUILD_DIR)


def library_path(src: str, libname: str,
                 extra_flags: Sequence[str] = ()) -> Path:
    """Where `src` built with `extra_flags` lives: `libname`'s stem plus
    a hash of the source and the flags."""
    stem = libname[:-3] if libname.endswith(".so") else libname
    return BUILD_DIR / f"{stem}-{_key(src, CXX_FLAGS, extra_flags)}.so"


def binary_path(src: str, name: str,
                extra_flags: Sequence[str] = ()) -> Path:
    """Where the executable `src` built with `extra_flags` lives: `name`
    plus a hash of the source and the flags."""
    return BUILD_DIR / f"{name}-{_key(src, EXE_FLAGS, extra_flags)}"


def _key(src: str, flags: Sequence[str], extra_flags: Sequence[str]) -> str:
    return hashlib.sha256(
        Path(src).read_bytes()
        + " ".join((CXX, *flags, *extra_flags)).encode()).hexdigest()[:16]


def compile_shared(src: str, libname: str, extra_flags: Sequence[str] = (),
                   timeout: float = 120.0) -> Path:
    """Compile `src` into its hashed library (unless it is there) and
    return the path; raises NativeBuildError with g++'s output tail."""
    if not os.path.exists(src):
        raise NativeBuildError(f"no source {src}")
    return _compile(src, library_path(src, libname, extra_flags),
                    CXX_FLAGS, extra_flags, timeout)


def compile_binary(src: str, name: str, extra_flags: Sequence[str] = (),
                   timeout: float = 180.0) -> Path:
    """Compile and link the program `src` into its hashed executable
    (unless it is there) and return the path; raises NativeBuildError
    with g++'s output tail."""
    if not os.path.exists(src):
        raise NativeBuildError(f"no source {src}")
    return _compile(src, binary_path(src, name, extra_flags), EXE_FLAGS,
                    extra_flags, timeout)


def _compile(src: str, out: Path, flags: Sequence[str],
             extra_flags: Sequence[str], timeout: float) -> Path:
    if out.is_file():
        return out
    cache_dir()
    tmp = out.with_name(
        f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *flags, src, *extra_flags, "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=timeout)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeBuildError(f"{' '.join(cmd)}: {e}") from None
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        tail = (res.stdout + res.stderr)[-ERROR_TAIL:]
        raise NativeBuildError(
            f"{' '.join(cmd)} failed (rc={res.returncode}):\n{tail}")
    os.replace(tmp, out)
    return out


def build_shared(src: str, libname: str, extra_flags: Sequence[str] = (),
                 timeout: float = 120.0) -> Optional[str]:
    """JAX's contract: the library's path, or None when the toolchain or
    the source is missing or the compile fails."""
    try:
        return str(compile_shared(src, libname, extra_flags, timeout))
    except NativeBuildError:
        return None


class LazyLib:
    """Once-only loader: builds, loads with ctypes and binds signatures
    on first use.

    `bind(lib)` declares restype/argtypes; its exceptions mean an ABI
    mismatch and propagate. A build or load failure memoizes to None
    (so the pure-Python paths engage without retrying the compiler on
    every call) and keeps its message in `error`.
    """

    def __init__(self, src: str, libname: str,
                 bind: Callable[[ctypes.CDLL], None],
                 extra_flags: Sequence[str] = ()):
        self._src = src
        self._libname = libname
        self._bind = bind
        self._extra = tuple(extra_flags)
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None   # guarded-by: _lock
        self._tried = False                       # guarded-by: _lock
        #: the loaded library's file, once built
        self.path: Optional[Path] = None
        #: why the library is unavailable (g++'s output tail), or None
        self.error: Optional[str] = None

    def get(self) -> Optional[ctypes.CDLL]:
        with self._lock:
            if not self._tried:
                self._tried = True
                try:
                    path = compile_shared(self._src, self._libname,
                                          self._extra)
                    lib = ctypes.CDLL(str(path))
                except (NativeBuildError, OSError) as e:
                    self.error = str(e)
                else:
                    self._bind(lib)
                    self._lib, self.path = lib, path
            return self._lib

    def require(self, what: str) -> ctypes.CDLL:
        """The library, or RuntimeError naming `what` and why."""
        lib = self.get()
        if lib is None:
            raise RuntimeError(f"native {what} library unavailable: "
                               f"{self.error}")
        return lib
