"""Exception types and the exit-code contract of the resilience layer
(port of paddle_tpu/resilience/errors.py).

Import-light on purpose: `parallel.trainer` (the bad-step guard) and
`io.checkpoint` both raise these without pulling the rest of the
resilience package.
"""

from __future__ import annotations

# Exit code a preempted run terminates with after its emergency
# checkpoint commits. Distinct from 0 (clean), 1 (crash) and the shell's
# 128+SIGTERM=143 (a process that died WITHOUT an emergency save): a
# scheduler can tell "preempted, checkpoint intact, safe to reschedule"
# from "failed" by this code alone.
PREEMPT_EXIT_CODE = 75  # EX_TEMPFAIL: transient, retry the job


class ResilienceError(RuntimeError):
    """Base class for resilience-layer failures."""


class BadStepBudgetExceeded(ResilienceError):
    """Raised by the bad-step guard after `bad_step_budget` consecutive
    non-finite steps: the trainer's state is still the last good one
    (every bad update was skipped), but the run needs a rollback to the
    last good checkpoint — the state may sit in a region that keeps
    producing NaNs (bad host, poisoned batch stream)."""

    def __init__(self, budget: int, step: int):
        super().__init__(
            f"{budget} consecutive non-finite steps at step {step}; "
            "state unchanged (updates skipped), roll back to the last "
            "good checkpoint")
        self.budget = budget
        self.step = step
