"""Process-wide metrics registry: Counter / Gauge / Histogram with labels.

Port of paddle_tpu/obs/metrics.py, kept line for line (same `ptpu_*`
series names, same buckets and quantile estimate) so a scrape of either
engine reads the same way.

The serving telemetry core (OBSERVABILITY.md): every subsystem the serve
path crosses — ServeEngine, Scheduler, PagedKVCache — records into one
thread-safe registry, and three exposition paths read it back out:

1. `MetricsRegistry.render_prometheus()` — Prometheus text format
   (the `/metrics` scrape body);
2. `MetricsRegistry.emit_snapshot()` — one `obs_snapshot` single-line
   JSON record on stdout through the unified event emitter
   (utils/log.py), so log-scraping consumers get periodic metric state
   with zero extra infrastructure; `Snapshotter` runs it on an
   interval thread;
3. direct reads (`.value`, `.quantile(q)`, `.mean()`) — what
   chip_smoke.py and the tests key off.

Histograms are LOG-BUCKETED: bounds grow geometrically (default 10
buckets per decade across 1e-3..1e7, sized for millisecond latencies),
so one fixed ~100-int array covers microseconds to hours with a
bounded RELATIVE quantile error — the p50/p90/p99 estimate
log-interpolates inside the landing bucket and clamps to the observed
min/max, so the worst-case error is one bucket's growth factor
(~26%), and far less on smooth distributions. That is the right trade
for latency SLOs, where 5ms vs 6ms matters but 500ms vs 630ms is the
same outage.

Hot-path discipline: a counter inc is one lock + one float add, a
histogram observe is a bisect + two adds; nothing here ever touches
torch or device state, so instrumentation can never add a device sync.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from paddle_tpu_torch.utils.log import obs_event


def log_buckets(lo: float = 1e-3, hi: float = 1e7,
                per_decade: int = 10) -> Tuple[float, ...]:
    """Geometric bucket bounds: `per_decade` buckets per power of ten
    spanning [lo, hi]. Relative width of each bucket is
    10**(1/per_decade) (~1.26 at the default), which bounds the
    worst-case quantile estimation error."""
    k0 = round(math.log10(lo) * per_decade)
    k1 = round(math.log10(hi) * per_decade)
    return tuple(10.0 ** (k / per_decade) for k in range(k0, k1 + 1))


DEFAULT_BUCKETS = log_buckets()


def _fmt(v: float) -> str:
    """Compact float rendering for exposition ('0.001', '2', '1e+07')."""
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return f"{v:.6g}"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(names: Sequence[str], values: Sequence[str],
               extra: str = "") -> str:
    parts = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


# -- children (one per label-value set) -------------------------------------

class _CounterChild:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0               # guarded-by: self._lock

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, got {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0.0


class _GaugeChild:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0               # guarded-by: self._lock

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0.0


class _HistogramChild:
    """Fixed log-bucket histogram; `observe` is O(log buckets)."""

    __slots__ = ("_lock", "_bounds", "_counts", "_sum", "_count",
                 "_min", "_max")

    def __init__(self, bounds: Tuple[float, ...]):
        self._lock = threading.Lock()
        self._bounds = bounds           # immutable after construction
        self._counts = [0] * (len(bounds) + 1)   # guarded-by: self._lock
        self._sum = 0.0                 # guarded-by: self._lock
        self._count = 0                 # guarded-by: self._lock
        self._min = math.inf            # guarded-by: self._lock
        self._max = -math.inf           # guarded-by: self._lock

    def observe(self, value: float) -> None:
        v = float(value)
        i = bisect.bisect_left(self._bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def minimum(self) -> float:
        """Smallest observed value (nan when empty)."""
        with self._lock:
            return self._min if self._count else math.nan

    @property
    def maximum(self) -> float:
        """Largest observed value (nan when empty)."""
        with self._lock:
            return self._max if self._count else math.nan

    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else math.nan

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile (q in [0, 1]) from the buckets:
        find the bucket holding rank q*count, then log-interpolate
        between its bounds, clamped to the observed min/max. Relative
        error is bounded by one bucket's growth factor."""
        with self._lock:
            if not self._count:
                return math.nan
            counts = list(self._counts)
            total, mn, mx = self._count, self._min, self._max
        rank = min(max(q, 0.0), 1.0) * total
        cum = 0
        idx, in_bucket = len(counts) - 1, 1
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                idx, in_bucket = i, c
                break
            cum += c
        lo = self._bounds[idx - 1] if idx > 0 else mn
        hi = self._bounds[idx] if idx < len(self._bounds) else mx
        lo, hi = max(lo, mn), min(hi, mx)
        if hi <= lo:
            return lo
        frac = min(max((rank - cum) / in_bucket, 0.0), 1.0)
        if lo > 0:
            return lo * (hi / lo) ** frac       # geometric interpolation
        return lo + (hi - lo) * frac

    def bucket_counts(self) -> List[Tuple[float, int]]:
        """CUMULATIVE (le, count) pairs, Prometheus-style, ending +Inf."""
        with self._lock:
            counts = list(self._counts)
        out, cum = [], 0
        for bound, c in zip(self._bounds + (math.inf,), counts):
            cum += c
            out.append((bound, cum))
        return out

    def _reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self._bounds) + 1)
            self._sum = 0.0
            self._count = 0
            self._min = math.inf
            self._max = -math.inf


# -- families (name + label schema; children per label-value set) -----------

class _Family:
    """One named metric; labelled children are created on first use and
    cached by label VALUES (kwargs order never matters), so
    `m.labels(a="x", b="y") is m.labels(b="y", a="x")`. A family with
    no labelnames proxies the single default child's methods."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}  # guarded-by: self._lock
        if not self.labelnames:
            self._children[()] = self._new_child()

    def _new_child(self):
        raise NotImplementedError

    def labels(self, **labelvalues):
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(labelvalues)}")
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
            return child

    def _default(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; use .labels()")
        return self._children[()]

    def children(self) -> Dict[Tuple[str, ...], object]:
        with self._lock:
            return dict(self._children)

    def _reset(self) -> None:
        for child in self.children().values():
            child._reset()

    # -- exposition -------------------------------------------------------
    def _header(self) -> List[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        return lines

    def render(self) -> List[str]:
        lines = self._header()
        for key in sorted(self.children()):
            lines.extend(self._render_child(key, self._children[key]))
        return lines

    def _render_child(self, key, child) -> List[str]:
        lbl = _label_str(self.labelnames, key)
        return [f"{self.name}{lbl} {_fmt(child.value)}"]


class Counter(_Family):
    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    @property
    def value(self) -> float:
        return self._default().value

    def total(self) -> float:
        """Sum over every labelled child."""
        return sum(c.value for c in self.children().values())


class Gauge(_Family):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    @property
    def value(self) -> float:
        return self._default().value


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Optional[Iterable[float]] = None):
        self._bounds = tuple(sorted(buckets)) if buckets is not None \
            else DEFAULT_BUCKETS
        if not self._bounds:
            raise ValueError(f"{name}: need at least one bucket bound")
        super().__init__(name, help, labelnames)

    def _new_child(self):
        return _HistogramChild(self._bounds)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    @property
    def count(self) -> int:
        return self._default().count

    @property
    def sum(self) -> float:
        return self._default().sum

    def mean(self) -> float:
        return self._default().mean()

    def quantile(self, q: float) -> float:
        return self._default().quantile(q)

    # aggregates over all labelled children (bench verdict helpers)
    def total_count(self) -> int:
        return sum(c.count for c in self.children().values())

    def total_sum(self) -> float:
        return sum(c.sum for c in self.children().values())

    def max_value(self) -> float:
        vals = [c.maximum for c in self.children().values() if c.count]
        return max(vals) if vals else math.nan

    def _render_child(self, key, child) -> List[str]:
        lines = []
        for bound, cum in child.bucket_counts():
            lbl = _label_str(self.labelnames, key,
                             extra=f'le="{_fmt(bound)}"')
            lines.append(f"{self.name}_bucket{lbl} {cum}")
        lbl = _label_str(self.labelnames, key)
        lines.append(f"{self.name}_sum{lbl} {_fmt(child.sum)}")
        lines.append(f"{self.name}_count{lbl} {child.count}")
        return lines


# -- the registry -----------------------------------------------------------

class MetricsRegistry:
    """Thread-safe name -> metric-family map with get-or-create
    accessors (re-registering the same name returns the SAME family —
    two ServeEngines sharing the process registry share its series —
    and a kind/label-schema mismatch fails loud)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Family] = {}  # guarded-by: self._lock

    def _get_or_create(self, cls, name, help, labelnames, **kw) -> _Family:
        with self._lock:
            fam = self._metrics.get(name)
            if fam is None:
                fam = self._metrics[name] = cls(
                    name, help=help, labelnames=labelnames, **kw)
                return fam
        if not isinstance(fam, cls):
            raise ValueError(f"{name} already registered as {fam.kind}")
        if fam.labelnames != tuple(labelnames):
            raise ValueError(
                f"{name} already registered with labels {fam.labelnames}, "
                f"asked for {tuple(labelnames)}")
        return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Iterable[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def reset(self) -> None:
        """Zero every child IN PLACE (handles held by instrumented code
        stay valid) — the post-warmup reset ServeEngine.reset_stats()
        uses."""
        with self._lock:
            fams = list(self._metrics.values())
        for fam in fams:
            fam._reset()

    # -- exposition -------------------------------------------------------
    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4 (the /metrics body)."""
        with self._lock:
            fams = sorted(self._metrics.values(), key=lambda f: f.name)
        lines: List[str] = []
        for fam in fams:
            lines.extend(fam.render())
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> Dict[str, object]:
        """Flat JSON-able view: counters/gauges as values, histograms as
        {count, sum, mean, p50, p90, p99, max}. Labelled children key
        as name{a=x,b=y}."""
        with self._lock:
            fams = sorted(self._metrics.values(), key=lambda f: f.name)
        out: Dict[str, object] = {}
        for fam in fams:
            for key, child in sorted(fam.children().items()):
                k = fam.name + ("{" + ",".join(
                    f"{n}={v}" for n, v in zip(fam.labelnames, key)) + "}"
                    if key else "")
                if fam.kind == "histogram":
                    if not child.count:
                        out[k] = {"count": 0}
                        continue
                    out[k] = {
                        "count": child.count,
                        "sum": round(child.sum, 6),
                        "mean": round(child.mean(), 6),
                        "p50": round(child.quantile(0.5), 6),
                        "p90": round(child.quantile(0.9), 6),
                        "p99": round(child.quantile(0.99), 6),
                        "max": round(child.maximum, 6),
                    }
                else:
                    out[k] = round(child.value, 6)
        return out

    def emit_snapshot(self, **extra) -> dict:
        """One `obs_snapshot` single-line JSON record on stdout via the
        unified event emitter (ts/seq stamped like every stream)."""
        return obs_event("obs_snapshot", metrics=self.snapshot(), **extra)


class Snapshotter:
    """Daemon thread emitting `registry.emit_snapshot()` every
    `interval_s`; `with Snapshotter(reg, 10):` or start()/stop()."""

    def __init__(self, registry: MetricsRegistry, interval_s: float = 10.0):
        self.registry = registry
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Snapshotter":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="ptpu-obs-snapshot")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.registry.emit_snapshot()

    def stop(self, final_snapshot: bool = False) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if final_snapshot:
            self.registry.emit_snapshot()

    def __enter__(self) -> "Snapshotter":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry every subsystem records into unless
    handed an explicit one (ServeEngine/PagedKVCache take registry=)."""
    return _DEFAULT
