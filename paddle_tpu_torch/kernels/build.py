"""Build and load the port's CUDA kernels.

Each kernel is one CUDA C++ source under `kernels/csrc/` with a plain
`extern "C"` launcher. It is compiled by hand with nvcc for Hopper
(`-gencode arch=compute_90a,code=sm_90a`) into a shared library and
loaded with ctypes — no PyTorch headers, so a build takes seconds.

Libraries land in `build/paddle_tpu_torch/` at the repository root,
named by a hash of the source, the shared headers (`csrc/*.cuh`) and
the flags, at first use: a checkout
builds its own kernels, and an edit to a source builds anew. Sources
build in parallel, one nvcc process each, all started together. A
failed compile raises with nvcc's output; the `-Xptxas -v` report
(registers, shared memory, spills per kernel) is kept beside each
library and returned by `ptxas_report`.

Nothing here runs at import: the CPU tests import every module, and
this machine may have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "paddle_tpu_torch"

# kernel name -> its source under csrc/
SOURCES = {
    "ragged_paged_attention": "ragged_paged_attention.cu",
    "flash_attention": "flash_attention.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class BuildInfo:
    name: str
    path: Path
    seconds: float      # 0.0 when the library was already built
    ptxas: str          # nvcc's -Xptxas -v report


_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}      # guarded-by: _LOCK
_INFO: Dict[str, BuildInfo] = {}        # guarded-by: _LOCK


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "port's CUDA kernels are built on the machine with the card")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{key[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, BuildInfo]:
    """Build every named kernel (default: all) that is not built yet,
    one nvcc per source, all started together. Returns name ->
    BuildInfo; raises RuntimeError with nvcc's output on a failure."""
    names = list(SOURCES if names is None else names)
    with _LOCK:
        return _build_locked(names)


# requires-lock: _LOCK
def _build_locked(names) -> Dict[str, BuildInfo]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if name in _INFO:
            continue
        path = _lib_path(name)
        log = path.with_suffix(".ptxas.txt")
        if path.is_file() and log.is_file():
            _INFO[name] = BuildInfo(name, path, 0.0, log.read_text())
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.perf_counter(), path, tmp, log)
    failures = []
    for name, (proc, t0, path, tmp, log) in procs.items():
        output, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name} (rc={proc.returncode}):"
                            f"\n{output}")
            continue
        log.write_text(output)
        os.replace(tmp, path)
        _INFO[name] = BuildInfo(name, path, seconds, output)
    if failures:
        raise RuntimeError("\n".join(failures))
    return {n: _INFO[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            info = _build_locked([name])[name]
            lib = _LIBS[name] = ctypes.CDLL(str(info.path))
        return lib


def ptxas_report(name: str) -> str:
    """The `ptxas info` lines (registers, shared memory, spills) of a
    built kernel."""
    with _LOCK:
        info = _build_locked([name])[name]
    return "\n".join(line for line in info.ptxas.splitlines()
                     if "ptxas info" in line or "spill" in line)
