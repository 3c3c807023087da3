"""The runtime of the port (paddle_tpu/core counterpart): training,
its resumable state, the program runners, and the module helpers."""

from paddle_tpu_torch.core.executor import (
    Executor, ExecutorError, NaiveExecutor, Trainer, TrainState,
    check_nan_inf, executor_cache_stats, host_step_of, supervised_loss)
from paddle_tpu_torch.core.module import (ModuleError, Sequential,
                                          named_params, param_count)

__all__ = ["Executor", "ExecutorError", "ModuleError", "NaiveExecutor",
           "Sequential", "Trainer", "TrainState", "check_nan_inf",
           "executor_cache_stats", "host_step_of", "named_params",
           "param_count", "supervised_loss"]
