"""Tracing / profiling (port of paddle_tpu/profiler; ≈ the reference's
platform/profiler + tools/timeline.py).

Two tiers, as JAX's:

1. Host-side event profiler — `RecordEvent` / `record_event` RAII spans
   aggregated into sorted op-time tables (≈ the reference's RecordEvent
   around every op run and EnableProfiler/DisableProfiler's tables).
   The port's Trainer, Executor and MeshTrainer record their steps.
2. Device tracer — `start_profiler(trace_dir)`/`stop_profiler`/
   `profiler` and `device_trace` capture a `torch.profiler` trace (CPU
   ops and, with a card, CUDA kernels over CUPTI);
   `device_trace.op_table` aggregates its kernels by name or by the op
   that launched them, and `annotate` names regions on the device
   timeline.

`timeline.py` merges the Chrome traces of host spans from several
processes (≈ tools/timeline.py:25-36).
"""

from paddle_tpu_torch.profiler.profiler import (
    RecordEvent,
    annotate,
    events_to_chrome_trace,
    get_events,
    profile_table,
    profiler,
    record_event,
    record_function,
    reset_profiler,
    save_profile,
    start_profiler,
    stop_profiler,
)
from paddle_tpu_torch.profiler.timeline import Timeline, merge_profiles
from paddle_tpu_torch.profiler.device_trace import (
    OpRow, device_trace, format_table, op_table)

__all__ = [
    "RecordEvent", "annotate", "events_to_chrome_trace", "get_events",
    "profile_table", "profiler", "record_event", "record_function",
    "reset_profiler", "save_profile", "start_profiler", "stop_profiler",
    "Timeline", "merge_profiles",
    "OpRow", "device_trace", "format_table", "op_table",
]
