"""Resilient training runtime of the port (paddle_tpu/resilience
counterpart): preemption, corruption, bad steps, retry.

- `RunSupervisor` / `train_resilient` — SIGTERM-safe supervision with
  emergency checkpointing, a step watchdog and bad-step rollback.
- `retry` — bounded exponential backoff + deterministic jitter, applied
  to checkpoint I/O.
- `chaos` — PTPU_CHAOS_* deterministic fault injection so every pillar
  is testable in-process.
"""

from paddle_tpu_torch.resilience.errors import (
    BadStepBudgetExceeded, PREEMPT_EXIT_CODE, ResilienceError,
)
from paddle_tpu_torch.resilience.retry import (
    RetryBudget, RetryPolicy, backoff_delay, retry_call, shared_budget,
    with_retry,
)
from paddle_tpu_torch.resilience import chaos


def __getattr__(name):
    # Lazy: supervisor sits ABOVE io.checkpoint in the layering, while
    # io.checkpoint imports retry/chaos from this package — an eager
    # supervisor import here would close that cycle before
    # io.checkpoint finishes executing.
    if name in ("RunSupervisor", "train_resilient"):
        from paddle_tpu_torch.resilience import supervisor
        return getattr(supervisor, name)
    raise AttributeError(
        f"module paddle_tpu_torch.resilience has no attribute {name}")
