"""C++ serving shim build + ctypes binding (port of
paddle_tpu/serving/__init__.py).

Reference: the inference C++ API consumed by serving applications
(paddle/fluid/inference/api/paddle_api.h, api/analysis_predictor.h:44,61,
api/demo_ci/). `serving.cc` is the library; `demo.cc` a standalone C++
consumer; `train_demo.cc` a C++ program that owns a training loop. This
module compiles them on demand with g++ into
`build/paddle_tpu_torch/native/` (utils/native.py: names hashed by
source and flags, so concurrent builders share one build) and provides
`CPredictor`, a ctypes binding of the same C ABI — used by tests and by
Python hosts that want the C contract.

Unlike JAX's, a failed build raises `NativeBuildError` with g++'s
output (JAX returns None), and the ABI takes the device:
`ptpu_create(model_dir, sys_path, device)`, `CPredictor(model_dir,
sys_path=None, device=None)` and the demos' optional last argument, where
None or "" means the CUDA card (it never drops to the CPU on its own).
Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sysconfig
from typing import List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.utils import native

#: the C ABI's dtype codes (serving.cc's kDtypeNames)
_DTYPES = ["float32", "float64", "int32", "int64", "uint8", "int8",
           "bool", "bfloat16", "float16"]
_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.dirname(os.path.dirname(_SRC_DIR))


def _include_flags() -> List[str]:
    return [f"-I{sysconfig.get_path('include')}"]


def _link_flags() -> List[str]:
    """libpython for a program that embeds the interpreter (the demos);
    --no-as-needed keeps it when only the shim library calls into it."""
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ver = (sysconfig.get_config_var("LDVERSION")
           or sysconfig.get_python_version())
    return [f"-L{libdir}", "-Wl,--no-as-needed", f"-lpython{ver}",
            f"-Wl,-rpath,{libdir}"]


def build_library() -> str:
    """Compile libptpu_serving.so (cached); returns its path. No
    -lpython: it runs inside an interpreter or a program linked with
    libpython."""
    return str(native.compile_shared(
        os.path.join(_SRC_DIR, "serving.cc"), "libptpu_serving.so",
        _include_flags(), timeout=180.0))


def build_demo() -> str:
    """Compile the standalone C++ demo binary (api/demo_ci capability)
    against the serving library; returns its path."""
    lib = build_library()
    return str(native.compile_binary(
        os.path.join(_SRC_DIR, "demo.cc"), "ptpu_demo",
        [lib, f"-Wl,-rpath,{os.path.dirname(lib)}", *_link_flags()]))


def build_train_demo() -> str:
    """Compile the standalone C++ *training* demo (reference
    train/demo/demo_trainer.cc capability: a native app owning the train
    loop, feeding its own C buffers and checkpointing at the end)."""
    return str(native.compile_binary(
        os.path.join(_SRC_DIR, "train_demo.cc"), "ptpu_train_demo",
        [*_include_flags(), *_link_flags()]))


def program_sys_path() -> str:
    """The sys.path a demo program's embedded interpreter needs: this
    checkout and the site-packages this interpreter imports numpy and
    torch from (an embedded interpreter starts from the system prefix,
    not from a virtual environment)."""
    return f"{_REPO_ROOT}:{os.path.dirname(os.path.dirname(np.__file__))}"


def run_demo(model_dir: str, device: Optional[str] = None,
             timeout: float = 600.0) -> subprocess.CompletedProcess:
    """Build and run demo.cc on `model_dir` (device None: the card);
    returns the finished process (its stdout holds the output lines)."""
    return subprocess.run(
        [build_demo(), model_dir, program_sys_path(), device or ""],
        capture_output=True, text=True, timeout=timeout)


def run_train_demo(ckpt_dir: str, device: Optional[str] = None,
                   timeout: float = 600.0) -> subprocess.CompletedProcess:
    """Build and run train_demo.cc, checkpointing into `ckpt_dir`
    (device None: the card); returns the finished process."""
    return subprocess.run(
        [build_train_demo(), program_sys_path(), ckpt_dir, device or ""],
        capture_output=True, text=True, timeout=timeout)


class _Tensor(ctypes.Structure):
    _fields_ = [("dtype", ctypes.c_int), ("rank", ctypes.c_int),
                ("shape", ctypes.POINTER(ctypes.c_int64)),
                ("data", ctypes.c_void_p)]


def _load(lib_path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(lib_path)
    lib.ptpu_create.restype = ctypes.c_void_p
    lib.ptpu_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                ctypes.c_char_p]
    lib.ptpu_clone.restype = ctypes.c_void_p
    lib.ptpu_clone.argtypes = [ctypes.c_void_p]
    lib.ptpu_ok.argtypes = [ctypes.c_void_p]
    lib.ptpu_last_error.restype = ctypes.c_char_p
    lib.ptpu_last_error.argtypes = [ctypes.c_void_p]
    lib.ptpu_run.argtypes = [ctypes.c_void_p, ctypes.POINTER(_Tensor),
                             ctypes.c_int]
    lib.ptpu_num_inputs.argtypes = [ctypes.c_void_p]
    lib.ptpu_num_outputs.argtypes = [ctypes.c_void_p]
    lib.ptpu_output_rank.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ptpu_output_dtype.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ptpu_output_shape.restype = ctypes.POINTER(ctypes.c_int64)
    lib.ptpu_output_shape.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ptpu_output_data.restype = ctypes.c_void_p
    lib.ptpu_output_data.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ptpu_output_nbytes.restype = ctypes.c_int64
    lib.ptpu_output_nbytes.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ptpu_destroy.argtypes = [ctypes.c_void_p]
    return lib


def _as_c(x) -> "tuple[int, np.ndarray]":
    """(dtype code, contiguous host array holding the bytes) of a numpy
    array or a CPU tensor; a torch.bfloat16 tensor goes as its bits."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return _DTYPES.index("bfloat16"), t.view(torch.int16).numpy()
        return _DTYPES.index(str(t.dtype).replace("torch.", "")), t.numpy()
    a = np.ascontiguousarray(x)
    return _DTYPES.index(a.dtype.name), a


class CPredictor:
    """ctypes binding of the serving C ABI (same contract a C++ host
    uses; ≈ PaddlePredictor::Run through paddle_api.h). `device` (None:
    the card) is where the predictor runs; `sys_path` is prepended to the
    interpreter's path (default: this checkout)."""

    def __init__(self, model_dir: str, sys_path: Optional[str] = None,
                 device: Optional[str] = None,
                 _cloned_from: Optional["CPredictor"] = None):
        if _cloned_from is not None:
            if not _cloned_from._h:
                raise RuntimeError("cannot clone a closed CPredictor")
            self._lib = _cloned_from._lib
            self._h = self._lib.ptpu_clone(_cloned_from._h)
            if not self._h:
                raise RuntimeError("ptpu_clone failed")
            return
        self._h = None
        self._lib = _load(build_library())
        sp = sys_path if sys_path is not None else _REPO_ROOT
        self._h = self._lib.ptpu_create(
            model_dir.encode(), sp.encode(),
            None if device is None else str(device).encode())
        if not self._lib.ptpu_ok(self._h):
            err = self._lib.ptpu_last_error(self._h).decode()
            self._lib.ptpu_destroy(self._h)
            self._h = None
            raise RuntimeError(f"ptpu_create failed: {err}")

    def run(self, arrays: Sequence) -> List[np.ndarray]:
        """Numpy arrays or CPU tensors in, numpy outputs out (bfloat16
        outputs come back as float32, as the predictor gives them)."""
        if not self._h:   # NULL would segfault inside ptpu_run
            raise RuntimeError("CPredictor is closed")
        tensors = (_Tensor * len(arrays))()
        keep = []
        for i, x in enumerate(arrays):
            code, a = _as_c(x)
            shape = (ctypes.c_int64 * a.ndim)(*a.shape)
            keep += [a, shape]
            tensors[i] = _Tensor(code, a.ndim, shape,
                                 a.ctypes.data_as(ctypes.c_void_p))
        if self._lib.ptpu_run(self._h, tensors, len(arrays)) != 0:
            raise RuntimeError(
                f"ptpu_run: {self._lib.ptpu_last_error(self._h).decode()}")
        outs = []
        for i in range(self._lib.ptpu_num_outputs(self._h)):
            rank = self._lib.ptpu_output_rank(self._h, i)
            shape = [self._lib.ptpu_output_shape(self._h, i)[d]
                     for d in range(rank)]
            dtype = _DTYPES[self._lib.ptpu_output_dtype(self._h, i)]
            nbytes = self._lib.ptpu_output_nbytes(self._h, i)
            buf = ctypes.string_at(self._lib.ptpu_output_data(self._h, i),
                                   nbytes)
            outs.append(np.frombuffer(buf, dtype=dtype).reshape(shape)
                        .copy())
        return outs

    def clone(self) -> "CPredictor":
        """Per-thread handle sharing the loaded predictor (≈
        PaddlePredictor::Clone): a CPredictor is NOT thread-safe (run
        rewrites its output slots) — clone one per serving thread."""
        return CPredictor("", _cloned_from=self)

    def close(self) -> None:
        if self._h:
            self._lib.ptpu_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


__all__ = ["CPredictor", "build_demo", "build_library", "build_train_demo",
           "program_sys_path", "run_demo", "run_train_demo"]
