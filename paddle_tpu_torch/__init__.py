"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu.

The JAX package `paddle_tpu` stays the reference; this package mirrors
its module names (benchmark/, core/, data/, engine/, io/, kernels/,
models/, nn/, obs/, ops/, optim/, parallel/, quant/, recordio/,
resilience/, serve/, utils/) so each part has an obvious counterpart, and imports neither
`jax` nor `paddle_tpu`. Plain tensor code is PyTorch; every kernel that
the JAX package wrote in Pallas for the TPU is a hand-written CUDA
kernel under `kernels/csrc/`, built at first use (kernels/build.py); the
C++ readers (recordio/, data/datafeed) build with g++ at first use
(utils/native.py).

The front door exports JAX's names (`paddle_tpu/__init__.py`) but its
module system: the port's layers are `torch.nn.Module`s, so JAX's
`Context`, `Module` and `Variables` have no counterpart. The other
subpackages load on first access (`paddle_tpu_torch.data`, ...);
importing the package builds nothing and touches no card.

Entry points default to the CUDA card (`device.resolve_device`) and
raise without one unless the caller passes `device="cpu"`.
"""

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.utils.flags import FLAGS, get_flags, set_flags
from paddle_tpu_torch.core.module import (Sequential, named_params,
                                          param_count)
from paddle_tpu_torch.core.executor import (
    Executor, NaiveExecutor, Trainer, TrainState, supervised_loss,
    train_from_files)
from paddle_tpu_torch import nn, ops, optim

__version__ = "0.1.0"

# JAX's lazily loaded subpackages (paddle_tpu/__init__.py:47-59)
_LAZY = ("data", "io", "metrics", "models", "parallel", "kernels",
         "profiler", "serving", "recordio", "benchmark", "testing",
         "quant", "resilience")

__all__ = ["Executor", "FLAGS", "NaiveExecutor", "Sequential", "Trainer",
           "TrainState", "__version__", "get_flags", "named_params", "nn",
           "ops", "optim", "param_count", "resolve_device", "set_flags",
           "supervised_loss", "train_from_files"]


def __getattr__(name):
    # Lazy subpackage access keeps the base import light. A subpackage
    # not ported (yet) raises AttributeError, keeping the hasattr/getattr
    # contract, as JAX's does for a missing one.
    import importlib
    if name in _LAZY:
        try:
            return importlib.import_module(f"paddle_tpu_torch.{name}")
        except ModuleNotFoundError as e:
            if e.name != f"paddle_tpu_torch.{name}":
                raise
            raise AttributeError(
                f"module paddle_tpu_torch has no attribute {name}") from e
    raise AttributeError(f"module paddle_tpu_torch has no attribute {name}")
