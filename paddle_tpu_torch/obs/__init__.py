"""Telemetry of the port (paddle_tpu/obs counterpart):

- `metrics` — thread-safe Counter/Gauge/Histogram registry, Prometheus
  text exposition and `obs_snapshot` JSON lines;
- `tracing` — per-request lifecycle spans as a Chrome trace;
- `http` — stdlib-only scrape server: `/metrics`, `/healthz`,
  `/readyz`, mountable extra routes;
- `flightrec` — FlightRecorder: bounded ring of recent events plus a
  state snapshot, dumped as a postmortem bundle on a watchdog stall or
  a crash;
- `goodput` — GoodputLedger (training goodput + per-cause lost time off
  the resilience event stream) and MFUMeter / analytic FLOPs helpers
  for `ptpu_train_mfu`;
- `devicemem` — DeviceMemoryMonitor: per-device in-use and peak
  gauges from the CUDA caching allocator, live tensors on the CPU.
"""

from paddle_tpu_torch.obs.metrics import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Snapshotter,
    default_registry,
    log_buckets,
)
from paddle_tpu_torch.obs.tracing import RequestTracer
from paddle_tpu_torch.obs.http import MetricsServer, json_route, obs_response
from paddle_tpu_torch.obs.flightrec import FlightRecorder
from paddle_tpu_torch.obs.goodput import (
    GoodputLedger,
    MFUMeter,
    causal_lm_step_flops,
    param_count,
    resolve_peak_flops,
)
from paddle_tpu_torch.obs.devicemem import DeviceMemoryMonitor

__all__ = [
    "DEFAULT_BUCKETS", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "Snapshotter", "default_registry", "log_buckets",
    "RequestTracer",
    "MetricsServer", "json_route", "obs_response",
    "FlightRecorder",
    "GoodputLedger", "MFUMeter", "causal_lm_step_flops", "param_count",
    "resolve_peak_flops",
    "DeviceMemoryMonitor",
]
