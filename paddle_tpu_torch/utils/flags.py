"""Global flag registry with environment-variable override (the port's
own copy of paddle_tpu/utils/flags.py).

Flags are typed Python values, resolved once at definition from a
`FLAGS_<name>` environment variable when one is set, held in one
process-wide registry:

    from paddle_tpu_torch.utils.flags import FLAGS
    FLAGS.set("check_nan_inf", True)

The port defines the flags its modules read: `check_nan_inf`
(`core/executor.py`'s NaN/Inf guard) and `executor_cache_capacity`
(`Executor`'s program-cache bound).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional


@dataclass
class _FlagDef:
    name: str
    default: Any
    parser: Callable[[str], Any]
    help: str


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


class FlagRegistry:
    """Process-wide typed flag registry. Thread-safe."""

    def __init__(self) -> None:
        self._defs: Dict[str, _FlagDef] = {}
        self._values: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def define(self, name: str, default: Any, help: str = "",
               parser: Optional[Callable[[str], Any]] = None) -> None:
        if parser is None:
            if isinstance(default, bool):
                parser = _parse_bool
            elif isinstance(default, int):
                parser = int
            elif isinstance(default, float):
                parser = float
            else:
                parser = str
        with self._lock:
            if name in self._defs:
                return  # idempotent re-import
            self._defs[name] = _FlagDef(name, default, parser, help)
            env = os.environ.get(f"FLAGS_{name}")
            self._values[name] = parser(env) if env is not None else default

    def get(self, name: str) -> Any:
        with self._lock:
            if name not in self._values:
                raise KeyError(f"undefined flag: {name}")
            return self._values[name]

    def set(self, name: str, value: Any) -> None:
        with self._lock:
            if name not in self._defs:
                raise KeyError(f"undefined flag: {name}")
            self._values[name] = value

    def all(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._values)


FLAGS = FlagRegistry()

FLAGS.define("check_nan_inf", False,
             "Check the outputs of every executor run and train step for "
             "NaN/Inf (debug).")
FLAGS.define("executor_cache_capacity", 256,
             "Max (program, signature) entries an Executor retains (LRU "
             "eviction). <=0 disables the bound.", int)


def get_flags() -> Dict[str, Any]:
    return FLAGS.all()


def set_flags(d: Dict[str, Any]) -> None:
    for k, v in d.items():
        FLAGS.set(k, v)
