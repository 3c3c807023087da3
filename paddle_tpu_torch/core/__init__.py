"""The runtime of the port (paddle_tpu/core counterpart): training,
its resumable state, and the program runners."""

from paddle_tpu_torch.core.executor import (
    Executor, ExecutorError, NaiveExecutor, Trainer, TrainState,
    check_nan_inf, executor_cache_stats, host_step_of, supervised_loss)

__all__ = ["Executor", "ExecutorError", "NaiveExecutor", "Trainer",
           "TrainState", "check_nan_inf", "executor_cache_stats",
           "host_step_of", "supervised_loss"]
