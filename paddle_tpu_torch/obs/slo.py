"""SLO monitor: objectives evaluated against the live metrics registry
(port of paddle_tpu/obs/slo.py, a copy over the port's metrics).

Observability as a CONTROL PLANE (OBSERVABILITY.md §SLOs): the serving
front-end doesn't guess whether it is overloaded — it asks the same
latency histograms a `/metrics` scrape exposes. An `SLOObjective` is a
statement like "99% of requests see TTFT <= 200ms"; the monitor turns
the registry's log-bucketed histograms into per-objective BURN RATES
and a machine-readable verdict, and the front-end sheds load while the
verdict says `burning` (serve/frontend.py admission control).

Burn rate is the SRE-workbook quantity: the fraction of requests that
violated the objective in a window, divided by the error budget
(1 - target). burn == 1.0 means "violations arriving exactly at the
rate the budget tolerates"; burn == 10 means the budget for the whole
window is gone in a tenth of it. The monitor evaluates burn over TWO
windows (multi-window alerting): the SHORT window makes shedding react
within seconds of an overload, the LONG window keeps one straggler
request from flapping the verdict — `burning` requires BOTH to exceed
the threshold, and recovery is immediate once the short window drains.

Windowing works on SNAPSHOT DELTAS, not cumulative counts: `tick()`
(called on an interval thread or inline by the front-end) records each
objective histogram's (total, violating) cumulative counts; a window's
burn is the delta between now and the sample one window ago. The
histograms are cumulative and monotone, so deltas are exact — no
per-request state, and a scrape-side consumer could compute the same
number from two `/metrics` pulls.

Violation counting uses the histogram's own buckets: the threshold is
rounded DOWN to a bucket bound, so the violating count is never
underestimated (an SLO that errs, errs strict — by at most one bucket's
growth factor, ~26% at the default resolution).

Everything the monitor concludes is re-exported as gauges
(`ptpu_slo_burn_rate{objective,window}`, `ptpu_slo_burning{objective}`,
`ptpu_slo_ok`) so dashboards and the replica router read verdicts from
the ordinary scrape, and as a JSON verdict served at `GET /slo`
(obs/http.py route; serve/frontend.py mounts it).
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

from paddle_tpu_torch.obs.metrics import Histogram, MetricsRegistry


@dataclass(frozen=True)
class SLOObjective:
    """`target` fraction of observations of `metric` must be <=
    `threshold_ms`. The error budget is 1 - target."""
    name: str                 # short label ("ttft", "tpot", "queue_wait")
    metric: str               # histogram family name in the registry
    threshold_ms: float
    target: float = 0.99

    def __post_init__(self):
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"{self.name}: target must be in (0, 1), "
                             f"got {self.target}")
        if self.threshold_ms <= 0:
            raise ValueError(f"{self.name}: threshold_ms must be > 0")

    @property
    def budget(self) -> float:
        return 1.0 - self.target


def default_objectives(ttft_ms: float = 500.0, tpot_ms: float = 200.0,
                       queue_wait_ms: float = 1000.0,
                       target: float = 0.99) -> List[SLOObjective]:
    """The serving objectives every replica watches by default, over
    the engine's own histogram names (engine/engine.py)."""
    return [
        SLOObjective("ttft", "ptpu_serve_ttft_ms", ttft_ms, target),
        SLOObjective("tpot", "ptpu_serve_tpot_ms", tpot_ms, target),
        SLOObjective("queue_wait", "ptpu_serve_queue_wait_ms",
                     queue_wait_ms, target),
    ]


@dataclass
class _Sample:
    ts: float
    total: int
    bad: int


class SLOMonitor:
    """Evaluates objectives against `registry` on every `tick()`.

    `burning(name)` / `any_burning()` are what admission control keys
    off; `verdict()` is the `/slo` body. Thread-safe: tick() may run on
    an interval thread while HTTP handlers read verdicts.
    """

    def __init__(self, registry: MetricsRegistry,
                 objectives: Optional[List[SLOObjective]] = None,
                 short_window_s: float = 5.0,
                 long_window_s: float = 60.0,
                 burn_threshold: float = 1.0,
                 min_samples: int = 4):
        if short_window_s <= 0 or long_window_s < short_window_s:
            raise ValueError(
                f"need 0 < short_window_s <= long_window_s, got "
                f"{short_window_s}/{long_window_s}")
        self.registry = registry
        self.objectives = list(objectives if objectives is not None
                               else default_objectives())
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        self.short_window_s = short_window_s
        self.long_window_s = long_window_s
        self.burn_threshold = burn_threshold
        # below this many new observations in the short window the
        # verdict holds OK: a single slow request on an idle replica is
        # not an outage, and shedding needs evidence
        self.min_samples = min_samples
        self._lock = threading.Lock()
        self._history: Dict[str, Deque[_Sample]] = {
            o.name: deque() for o in self.objectives}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # verdict gauges: the scrape-visible face of the monitor
        self._g_burn = registry.gauge(
            "ptpu_slo_burn_rate",
            "Error-budget burn rate per objective and window "
            "(1.0 = budget consumed exactly at tolerance)",
            labelnames=("objective", "window"))
        self._g_burning = registry.gauge(
            "ptpu_slo_burning",
            "1 when an objective burns in BOTH windows (sheds load)",
            labelnames=("objective",))
        self._g_threshold = registry.gauge(
            "ptpu_slo_threshold_ms", "Configured objective threshold",
            labelnames=("objective",))
        self._g_ok = registry.gauge(
            "ptpu_slo_ok", "1 when no objective is burning")
        for o in self.objectives:
            self._g_threshold.labels(objective=o.name).set(o.threshold_ms)
            self._g_burning.labels(objective=o.name).set(0.0)
        self._g_ok.set(1.0)

    # -- sampling ---------------------------------------------------------
    def _counts(self, obj: SLOObjective) -> Tuple[int, int]:
        """Cumulative (total, violating) for one objective, summed over
        the histogram's labelled children. The threshold rounds down to
        a bucket bound so `bad` is never underestimated."""
        fam = self.registry.get(obj.metric)
        if fam is None or not isinstance(fam, Histogram):
            return 0, 0
        total = bad = 0
        for child in fam.children().values():
            pairs = child.bucket_counts()      # cumulative (le, count)
            if not pairs:
                continue
            n = pairs[-1][1]
            bounds = [le for le, _ in pairs]
            # last bound <= threshold: everything above it counts bad
            i = bisect.bisect_right(bounds, obj.threshold_ms) - 1
            good = pairs[i][1] if i >= 0 else 0
            total += n
            bad += n - good
        return total, bad

    def tick(self, now: Optional[float] = None) -> None:
        """Record one snapshot per objective and refresh the verdict
        gauges. Call on an interval (start()) or inline from the serve
        loop — both work; more ticks only sharpen the windows."""
        ts = time.monotonic() if now is None else now
        with self._lock:
            for obj in self.objectives:
                total, bad = self._counts(obj)
                hist = self._history[obj.name]
                # a registry reset (warmup baseline) rewinds the
                # cumulative counts; stale pre-reset samples would read
                # as negative deltas — drop them
                while hist and hist[-1].total > total:
                    hist.pop()
                hist.append(_Sample(ts, total, bad))
                horizon = ts - self.long_window_s - 1.0
                while len(hist) > 2 and hist[1].ts <= horizon:
                    hist.popleft()
        self._refresh_gauges(ts)

    def _window_burn(self, obj: SLOObjective, window_s: float,
                     now: float) -> Tuple[float, int]:
        """(burn rate, observations) over the trailing window — delta
        between the newest sample and the newest sample at least
        `window_s` old (or the oldest retained)."""
        hist = self._history[obj.name]
        if not hist:
            return 0.0, 0
        latest = hist[-1]
        base = hist[0]
        for s in reversed(hist):
            if now - s.ts >= window_s:
                base = s
                break
        total = latest.total - base.total
        bad = latest.bad - base.bad
        if total <= 0:
            return 0.0, 0
        return (bad / total) / obj.budget, total

    def _evaluate_locked(self, now: float) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for obj in self.objectives:
            short, n_short = self._window_burn(obj, self.short_window_s,
                                               now)
            long_, n_long = self._window_burn(obj, self.long_window_s, now)
            burning = (n_short >= self.min_samples
                       and short >= self.burn_threshold
                       and long_ >= self.burn_threshold)
            out[obj.name] = {
                "metric": obj.metric,
                "threshold_ms": obj.threshold_ms,
                "target": obj.target,
                "burn_short": round(short, 4),
                "burn_long": round(long_, 4),
                "window_short_s": self.short_window_s,
                "window_long_s": self.long_window_s,
                "observations_short": n_short,
                "burning": burning,
            }
        return out

    def _refresh_gauges(self, now: float) -> None:
        with self._lock:
            ev = self._evaluate_locked(now)
        ok = True
        for name, st in ev.items():
            self._g_burn.labels(objective=name, window="short").set(
                st["burn_short"])
            self._g_burn.labels(objective=name, window="long").set(
                st["burn_long"])
            self._g_burning.labels(objective=name).set(
                1.0 if st["burning"] else 0.0)
            ok = ok and not st["burning"]
        self._g_ok.set(1.0 if ok else 0.0)

    # -- verdicts ---------------------------------------------------------
    def burning(self, name: str) -> bool:
        with self._lock:
            ev = self._evaluate_locked(time.monotonic())
        return ev[name]["burning"]

    def burning_objectives(self) -> List[str]:
        """Names of objectives currently burning (admission control
        sheds with the FIRST one as the labeled reason)."""
        with self._lock:
            ev = self._evaluate_locked(time.monotonic())
        return [n for n, st in ev.items() if st["burning"]]

    def any_burning(self) -> bool:
        return bool(self.burning_objectives())

    def verdict(self) -> dict:
        """The machine-readable `/slo` body: per-objective burn rates,
        thresholds, and the overall ok bit — same numbers the
        `ptpu_slo_*` gauges expose."""
        with self._lock:
            ev = self._evaluate_locked(time.monotonic())
        return {"ok": not any(st["burning"] for st in ev.values()),
                "burn_threshold": self.burn_threshold,
                "objectives": ev}

    # -- interval thread --------------------------------------------------
    def start(self, interval_s: float = 1.0) -> "SLOMonitor":
        if self._thread is not None:
            return self
        self._stop.clear()
        # synchronous baseline sample: without it, traffic completing
        # before the first interval tick would be invisible (the first
        # sample would already contain it and every delta would be 0)
        self.tick()

        def _run():
            while not self._stop.wait(interval_s):
                self.tick()

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name="ptpu-slo-monitor")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "SLOMonitor":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False
