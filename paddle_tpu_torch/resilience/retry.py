"""Bounded retry with exponential backoff + deterministic jitter (port
of paddle_tpu/resilience/retry.py).

The transient-failure policy for the control-plane edges the runtime
crosses: checkpoint shard I/O (shared-FS hiccups) here, and the
rendezvous and the checkpoint barriers once the port runs across
processes. One policy object, so every site logs the same `retry`
event and tests can drive it via env knobs.

Jitter is DETERMINISTIC — hash of (name, attempt), not a live RNG — so
a restarted run and its uninterrupted twin sleep identically and
subprocess tests stay reproducible. Sleeps scale by `PTPU_RETRY_SCALE`
(set it to 0 in tests to make retries instantaneous).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
import zlib
from typing import Callable, Optional, Tuple, Type

from paddle_tpu_torch.obs.metrics import MetricsRegistry, default_registry
from paddle_tpu_torch.utils.log import resilience_event

_RETRIES = default_registry().counter(
    "ptpu_resilience_retries_total",
    "Transient-failure re-attempts", labelnames=("site",))


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """attempts = TOTAL tries (1 == no retry). Delay before try k (k>=2)
    is min(base * 2**(k-2), max_delay) * (1 + jitter_frac * u) with u in
    [0, 1) derived from crc32((name, attempt)). `full_jitter=True`
    switches to the AWS "full jitter" shape — delay = raw * u, spreading
    retries over [0, raw) instead of clustering at raw — with the SAME
    deterministic u, so restarted runs still sleep identically."""
    attempts: int = 3
    base_delay: float = 0.25
    max_delay: float = 8.0
    jitter_frac: float = 0.25
    full_jitter: bool = False
    retry_on: Tuple[Type[BaseException], ...] = (OSError, RuntimeError)
    # a matching exception is NOT retried even with budget left (e.g. a
    # barrier DEADLINE_EXCEEDED: peers have moved on, re-waiting the
    # same key can only hang again)
    giveup: Optional[Callable[[BaseException], bool]] = None


class RetryBudget:
    """Token bucket capping retries to a fraction of successful traffic.

    Every SUCCESS deposits `ratio` tokens (so sustained retry volume is
    at most `ratio` x success volume); every retry spends one whole
    token. The bucket starts full at `burst` tokens — the allowance for
    a cold start or a short correlated outage — and never exceeds it.
    When the bucket is empty `try_spend` refuses and the caller must
    surface the failure instead of retrying: that is the anti-storm
    property — a fleet-wide degradation stops generating successes,
    the bucket drains, and retry traffic collapses to zero rather than
    amplifying the overload.

    Purely arithmetic (no RNG, no clock), so tests are deterministic:
    the same success/failure sequence always yields the same admit/deny
    decisions. Thread-safe; spends are accounted per `site` on the
    `denied` counter so `ptpu_resilience_retries_total{site}` plus the
    denials remain the single retry-accounting surface."""

    def __init__(self, ratio: float = 0.1, burst: float = 10.0,
                 registry: Optional[MetricsRegistry] = None):
        self.ratio = float(ratio)
        self.burst = float(burst)
        self._lock = threading.Lock()
        self._tokens = self.burst           # guarded-by: self._lock
        reg = registry if registry is not None else default_registry()
        self._tokens_g = reg.gauge(
            "ptpu_resilience_retry_budget_tokens",
            "Retry-budget tokens currently available")
        self._denied = reg.counter(
            "ptpu_resilience_retry_budget_denied_total",
            "Retries refused because the budget was exhausted",
            labelnames=("site",))
        self._tokens_g.set(self._tokens)

    def note_success(self, n: int = 1) -> None:
        """Deposit ratio tokens per success (capped at burst)."""
        with self._lock:
            self._tokens = min(self.burst, self._tokens + self.ratio * n)
            self._tokens_g.set(self._tokens)

    def try_spend(self, site: str) -> bool:
        """Take one token for a retry at `site`; False == shed, don't
        retry. Counts denials so exhaustion is visible on /metrics."""
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                self._tokens_g.set(self._tokens)
                return True
        self._denied.labels(site=site).inc()
        return False

    def tokens(self) -> float:
        with self._lock:
            return self._tokens

    def reset(self) -> None:
        with self._lock:
            self._tokens = self.burst
            self._tokens_g.set(self._tokens)


_SHARED_BUDGET: Optional[RetryBudget] = None
_SHARED_LOCK = threading.Lock()


def shared_budget() -> RetryBudget:
    """The process-wide budget every checkpoint-IO / rendezvous
    `retry_call` site draws from (default registry). One bucket per
    process: a storm of shard-write retries and a storm of barrier
    retries drain the SAME allowance, which is the point."""
    global _SHARED_BUDGET
    with _SHARED_LOCK:
        if _SHARED_BUDGET is None:
            _SHARED_BUDGET = RetryBudget(ratio=0.2, burst=32.0)
        return _SHARED_BUDGET


def _jitter_u(name: str, attempt: int) -> float:
    return (zlib.crc32(f"{name}:{attempt}".encode()) % 1000) / 1000.0


def _scale() -> float:
    try:
        return float(os.environ.get("PTPU_RETRY_SCALE", "1"))
    except ValueError:
        return 1.0


def backoff_delay(policy: RetryPolicy, name: str, attempt: int) -> float:
    """Delay (s) before `attempt` (2-based; attempt 1 never waits)."""
    if attempt <= 1:
        return 0.0
    raw = min(policy.base_delay * (2.0 ** (attempt - 2)), policy.max_delay)
    u = _jitter_u(name, attempt)
    if policy.full_jitter:
        return raw * u * _scale()
    return raw * (1.0 + policy.jitter_frac * u) * _scale()


def retry_call(fn: Callable, *args, policy: Optional[RetryPolicy] = None,
               name: Optional[str] = None,
               budget: Optional[RetryBudget] = None, **kwargs):
    """Call fn(*args, **kwargs) under `policy`, emitting one `retry`
    event per re-attempt. Re-raises the last exception when the budget
    is exhausted (or immediately on a non-retryable/giveup error).
    With `budget`, each re-attempt must win a token first — an empty
    bucket turns a retryable failure into an immediate raise — and
    each success deposits back into it."""
    policy = policy or RetryPolicy()
    name = name or getattr(fn, "__name__", "call")
    last: Optional[BaseException] = None
    for attempt in range(1, max(1, policy.attempts) + 1):
        delay = backoff_delay(policy, name, attempt)
        if delay > 0:
            time.sleep(delay)
        try:
            out = fn(*args, **kwargs)
            if budget is not None:
                budget.note_success()
            return out
        except policy.retry_on as e:
            last = e
            if policy.giveup is not None and policy.giveup(e):
                raise
            if attempt >= max(1, policy.attempts):
                raise
            if budget is not None and not budget.try_spend(name):
                resilience_event("retry_budget_exhausted", site=name,
                                 attempt=attempt,
                                 error=f"{type(e).__name__}: {e}")
                raise
            _RETRIES.labels(site=name).inc()
            resilience_event("retry", site=name, attempt=attempt,
                             of=policy.attempts,
                             next_delay_s=round(
                                 backoff_delay(policy, name, attempt + 1), 3),
                             error=f"{type(e).__name__}: {e}")
    raise last  # unreachable; keeps type checkers honest


def with_retry(policy: Optional[RetryPolicy] = None,
               name: Optional[str] = None,
               budget: Optional[RetryBudget] = None):
    """Decorator form of retry_call."""

    def deco(fn: Callable):
        def wrapped(*args, **kwargs):
            return retry_call(fn, *args, policy=policy,
                              name=name or fn.__name__, budget=budget,
                              **kwargs)
        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        wrapped.__doc__ = fn.__doc__
        return wrapped
    return deco
