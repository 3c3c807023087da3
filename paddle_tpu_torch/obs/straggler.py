"""Cross-worker straggler detection for multi-process dp training (port
of paddle_tpu/obs/straggler.py).

In an SPMD dp job the collectives run the workers in lock step: a slow
worker stalls *everyone's* step, so per-worker total step time is
useless for blame — every worker's `ptpu_train_step_ms` inflates
identically. What stays local is the **host input stall**: the wall
time a worker spends producing/feeding its batch before it joins the
collective (`ptpu_train_input_wait_ms`, timed around `batch_for` in
train_resilient). A worker whose input wait dwarfs the fleet baseline
is the straggler, even though step times agree.

The detector consumes raw `/metrics` exposition bodies (one per
worker, scraped from each worker's MetricsServer), reuses
`obs.fleetmetrics.parse_exposition` for the per-worker stats and
`obs.fleetmetrics.federate` for the merged fleet body, and publishes:

- `ptpu_train_straggler{worker=}` — 1.0 when that worker's mean input
  wait exceeds `ratio` x the fleet baseline (median for >= 3 workers,
  min for 2), else 0.0;
- `ptpu_train_step_dispersion` — max/min of per-worker mean step
  time, the lock-step sanity check (should sit near 1.0 in dp).
"""

from __future__ import annotations

from typing import Dict, Optional

from paddle_tpu_torch.obs.fleetmetrics import federate, parse_exposition
from paddle_tpu_torch.obs.metrics import MetricsRegistry, default_registry


def _family_mean(fams, name: str) -> Optional[float]:
    """sum/count over every label set of one histogram family."""
    fam = fams.get(name)
    if fam is None:
        return None
    total = count = 0.0
    for suffix, _, _, value in fam.samples:
        if suffix == "_sum":
            total += value
        elif suffix == "_count":
            count += value
    return (total / count) if count else None


def _baseline(values) -> float:
    vals = sorted(values)
    if len(vals) >= 3:
        mid = len(vals) // 2
        if len(vals) % 2:
            return vals[mid]
        return 0.5 * (vals[mid - 1] + vals[mid])
    return vals[0]


class StragglerDetector:
    """Flags dp workers whose input stall leaves the fleet baseline."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 ratio: float = 2.0, min_gap_ms: float = 5.0,
                 wait_family: str = "ptpu_train_input_wait_ms",
                 step_family: str = "ptpu_train_step_ms"):
        reg = registry if registry is not None else default_registry()
        self._g_straggler = reg.gauge(
            "ptpu_train_straggler",
            "1 when the worker's input wait exceeds ratio x baseline",
            labelnames=("worker",))
        self._g_dispersion = reg.gauge(
            "ptpu_train_step_dispersion",
            "max/min of per-worker mean step time")
        self.ratio = ratio
        # sub-ms jitter between healthy workers must not trip the flag:
        # a straggler must beat the baseline by ratio AND by a real gap
        self.min_gap_ms = min_gap_ms
        self.wait_family = wait_family
        self.step_family = step_family

    def update(self, expositions: Dict[str, str]) -> Dict[str, Dict]:
        """Feed {worker: exposition_text}; update gauges; return
        {worker: {input_wait_ms, step_ms, straggler}}."""
        parsed = {w: parse_exposition(t) for w, t in expositions.items()}
        waits = {w: _family_mean(f, self.wait_family)
                 for w, f in parsed.items()}
        steps = {w: _family_mean(f, self.step_family)
                 for w, f in parsed.items()}

        known_waits = [v for v in waits.values() if v is not None]
        base = _baseline(known_waits) if known_waits else None
        out: Dict[str, Dict] = {}
        for worker in sorted(parsed):
            wait = waits.get(worker)
            slow = bool(base is not None and wait is not None
                        and wait > self.ratio * max(base, 1e-9)
                        and wait - base > self.min_gap_ms)
            self._g_straggler.labels(worker=worker).set(
                1.0 if slow else 0.0)
            out[worker] = {"input_wait_ms": wait,
                           "step_ms": steps.get(worker),
                           "straggler": slow}

        known_steps = [v for v in steps.values() if v is not None and v > 0]
        if known_steps:
            self._g_dispersion.set(max(known_steps) / min(known_steps))
        return out

    def fleet_exposition(self, expositions: Dict[str, str]) -> str:
        """Merged fleet body for the aggregator's own /metrics/fleet —
        counters/histograms sum exactly, gauges gain a replica label."""
        return federate(expositions)
