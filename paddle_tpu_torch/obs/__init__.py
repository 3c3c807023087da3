"""Telemetry of the port (paddle_tpu/obs counterpart):

- `metrics` — thread-safe Counter/Gauge/Histogram registry, Prometheus
  text exposition and `obs_snapshot` JSON lines;
- `tracing` — per-request lifecycle spans as a Chrome trace, merged
  with host spans (`merged_chrome_trace`) or stitched across processes
  by fleet trace id (`stitch_fragments`);
- `http` — stdlib-only scrape server: `/metrics`, `/healthz`,
  `/readyz`, mountable extra routes;
- `slo` — SLOMonitor: objectives over the live registry, multi-window
  burn rates, `/slo` verdict — what the serve front-end's admission
  control and the replica gauges read;
- `fleetmetrics` — federation of per-replica expositions into one
  fleet-wide scrape body (`/metrics/fleet` on the router);
- `flightrec` — FlightRecorder: bounded ring of recent events plus a
  state snapshot, dumped as a postmortem bundle on a watchdog stall or
  a crash;
- `goodput` — GoodputLedger (training goodput + per-cause lost time off
  the resilience event stream) and MFUMeter / analytic FLOPs helpers
  for `ptpu_train_mfu`;
- `devicemem` — DeviceMemoryMonitor: per-device in-use and peak
  gauges from the CUDA caching allocator, live tensors on the CPU;
- `straggler` — StragglerDetector: the slow dp worker by its input
  wait, over the workers' scrape bodies.
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
from paddle_tpu_torch.obs.tracing import (
    RequestTracer,
    merged_chrome_trace,
    stitch_fragments,
)
from paddle_tpu_torch.obs.http import MetricsServer, json_route, obs_response
from paddle_tpu_torch.obs.slo import SLOMonitor, SLOObjective, default_objectives
from paddle_tpu_torch.obs.fleetmetrics import (
    counter_totals,
    federate,
    histogram_buckets,
    parse_exposition,
)
from paddle_tpu_torch.obs.flightrec import FlightRecorder
from paddle_tpu_torch.obs.goodput import (
    GoodputLedger,
    MFUMeter,
    causal_lm_step_flops,
    param_count,
    resolve_peak_flops,
)
from paddle_tpu_torch.obs.devicemem import DeviceMemoryMonitor
from paddle_tpu_torch.obs.straggler import StragglerDetector

__all__ = [
    "DEFAULT_BUCKETS", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "Snapshotter", "default_registry", "log_buckets",
    "RequestTracer", "merged_chrome_trace", "stitch_fragments",
    "MetricsServer", "json_route", "obs_response",
    "SLOMonitor", "SLOObjective", "default_objectives",
    "counter_totals", "federate", "histogram_buckets", "parse_exposition",
    "FlightRecorder",
    "GoodputLedger", "MFUMeter", "causal_lm_step_flops", "param_count",
    "resolve_peak_flops",
    "DeviceMemoryMonitor", "StragglerDetector",
]
