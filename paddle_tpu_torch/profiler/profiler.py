"""Event profiler and device-trace capture (port of
paddle_tpu/profiler/profiler.py).

The host tier is JAX's, copied: `RecordEvent` spans recorded between
`start_profiler` and `stop_profiler`, aggregated into the sorted
op-time table (the reference's EnableProfiler / DisableProfiler) and
rendered as a Chrome trace. The device tier wraps `torch.profiler`
where JAX wraps `jax.profiler`: `start_profiler(trace_dir)` also
captures the CPU ops and, with a card present, its kernels, and
`stop_profiler` writes them to `trace_dir/<host>.<pid>.trace.json.gz`,
which `device_trace.op_table` reads and chrome://tracing or perfetto
load. `annotate` names a region on both timelines.
"""

from __future__ import annotations

import contextlib
import functools
import gzip
import json
import os
import socket
import threading
import time
from typing import Dict, List, Optional

import torch

from paddle_tpu_torch.utils.log import vlog

_lock = threading.Lock()
_events: List[dict] = []          # completed spans: name/ts/dur/tid (us)
_enabled = False
_trace_dir: Optional[str] = None
_capture: Optional["torch.profiler.profile"] = None
# Wall-clock anchor for the monotonic counter: timestamps are epoch-based
# microseconds so profiles from different processes merge on a common
# timeline (tools/timeline.py multi-trainer merge needs comparable ts).
_EPOCH_NS = time.time_ns() - time.perf_counter_ns()


def now_us() -> float:
    """Epoch-anchored monotonic microseconds — the shared timestamp
    base for host spans AND the request tracer (obs/tracing.py), so
    their Chrome traces merge on one timeline."""
    return (_EPOCH_NS + time.perf_counter_ns()) / 1e3


class RecordEvent:
    """RAII host-side span (≈ platform/profiler.h:72 RecordEvent).

    Usable as a context manager. Spans are recorded only while the
    profiler is enabled (between start_profiler and stop_profiler) —
    matching the reference's g_state gate.
    """

    def __init__(self, name: str):
        self.name = name
        self._start = 0.0

    def __enter__(self):
        self._start = now_us()
        return self

    def __exit__(self, *exc):
        if not _enabled:
            return False
        end = now_us()
        with _lock:
            _events.append({
                "name": self.name,
                "ts": self._start,
                "dur": end - self._start,
                "tid": threading.get_ident() & 0xFFFF,
            })
        return False


record_event = RecordEvent


def record_function(name: Optional[str] = None):
    """Decorator wrapping a function body in a RecordEvent span."""

    def deco(fn):
        ev_name = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with RecordEvent(ev_name):
                return fn(*args, **kwargs)

        return wrapped

    return deco


@contextlib.contextmanager
def annotate(name: str):
    """Named region in the DEVICE trace and the host event list:
    `torch.profiler.record_function` (a `user_annotation` over the CPU
    ops and a `gpu_user_annotation` over the kernels launched inside it,
    as `jax.profiler.TraceAnnotation` names a region) plus a
    RecordEvent."""
    with torch.profiler.record_function(name), RecordEvent(name):
        yield


def trace_file(trace_dir: str) -> str:
    """Where a capture into `trace_dir` is written:
    `<host>.<pid>.trace.json.gz`, the name `op_table` globs for."""
    return os.path.join(trace_dir,
                        f"{socket.gethostname()}.{os.getpid()}.trace.json.gz")


def start_capture() -> "torch.profiler.profile":
    """A started `torch.profiler` capture of the CPU ops (with their
    FLOPs) and, with a card present, its kernels, copies and memsets."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts, with_flops=True)
    prof.start()
    return prof


def stop_capture(prof: "torch.profiler.profile", trace_dir: str) -> str:
    """Stop `prof` (after the card's queued work ends) and write its
    Chrome trace into `trace_dir`, gzipped; returns the file. Kineto's
    trace carries no FLOPs, so each CPU op PyTorch counted them for
    (matmuls, convolutions) gets its count as `args["flops"]`, joined
    on the op's `External id`."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    prof.stop()
    flops = {e.id: int(e.flops) for e in prof.events()
             if e.flops and e.device_type == torch.autograd.DeviceType.CPU}
    os.makedirs(trace_dir, exist_ok=True)
    path = trace_file(trace_dir)
    raw = path[:-len(".gz")] + ".tmp"
    prof.export_chrome_trace(raw)
    try:
        with open(raw) as f:
            data = json.load(f)
    finally:
        os.remove(raw)
    for ev in data.get("traceEvents", []):
        n = (flops.get(ev.get("args", {}).get("External id"))
             if ev.get("cat") == "cpu_op" else None)
        if n:
            ev["args"]["flops"] = n
    with gzip.open(path, "wt") as f:
        json.dump(data, f)
    return path


def start_profiler(trace_dir: Optional[str] = None) -> None:
    """Enable host-span recording; if trace_dir is given, also start a
    torch.profiler capture written there by stop_profiler
    (≈ EnableProfiler(kAll))."""
    global _enabled, _trace_dir, _capture
    with _lock:
        _events.clear()
    _enabled = True
    _trace_dir = trace_dir
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        _capture = start_capture()
    vlog(1, f"profiler started (trace_dir={trace_dir})")


def stop_profiler(sorted_key: str = "total",
                  profile_path: Optional[str] = None,
                  print_table: bool = True) -> List[dict]:
    """Stop profiling; print the aggregated op-time table and optionally
    dump the raw events as a Chrome-trace json (≈ DisableProfiler's
    sorted table + profiler.proto dump, profiler.h:117-126).

    sorted_key in {"total", "calls", "max", "min", "ave"}.
    Returns the aggregated rows.
    """
    global _enabled, _trace_dir, _capture
    _enabled = False
    if _trace_dir:
        if _capture is not None:
            stop_capture(_capture, _trace_dir)
        _capture = None
        _trace_dir = None
    rows = profile_table(sorted_key)
    if print_table and rows:
        print(format_table(rows, sorted_key))
    if profile_path:
        save_profile(profile_path)
    return rows


def reset_profiler() -> None:
    with _lock:
        _events.clear()


def get_events() -> List[dict]:
    with _lock:
        return list(_events)


@contextlib.contextmanager
def profiler(sorted_key: str = "total", profile_path: Optional[str] = None,
             trace_dir: Optional[str] = None):
    """Context manager form (≈ fluid.profiler.profiler)."""
    start_profiler(trace_dir)
    try:
        yield
    finally:
        stop_profiler(sorted_key=sorted_key, profile_path=profile_path)


def profile_table(sorted_key: str = "total") -> List[dict]:
    """Aggregate recorded spans into per-name stats rows."""
    agg: Dict[str, dict] = {}
    for ev in get_events():
        row = agg.setdefault(ev["name"], {
            "name": ev["name"], "calls": 0, "total": 0.0,
            "min": float("inf"), "max": 0.0,
        })
        row["calls"] += 1
        row["total"] += ev["dur"]
        row["min"] = min(row["min"], ev["dur"])
        row["max"] = max(row["max"], ev["dur"])
    rows = []
    grand_total = sum(r["total"] for r in agg.values()) or 1.0
    for row in agg.values():
        row["ave"] = row["total"] / row["calls"]
        row["ratio"] = row["total"] / grand_total
        rows.append(row)
    key = {"total": "total", "calls": "calls", "max": "max", "min": "min",
           "ave": "ave"}.get(sorted_key, "total")
    rows.sort(key=lambda r: r[key], reverse=True)
    return rows


def format_table(rows: List[dict], sorted_key: str = "total") -> str:
    lines = [
        f"------------------->  Profiling Report (sorted by {sorted_key})"
        "  <-------------------",
        f"{'Event':<40}{'Calls':>8}{'Total(us)':>14}{'Min(us)':>12}"
        f"{'Max(us)':>12}{'Ave(us)':>12}{'Ratio':>8}",
    ]
    for r in rows:
        lines.append(
            f"{r['name'][:39]:<40}{r['calls']:>8}{r['total']:>14.1f}"
            f"{r['min']:>12.1f}{r['max']:>12.1f}{r['ave']:>12.1f}"
            f"{r['ratio']:>8.3f}")
    return "\n".join(lines)


def events_to_chrome_trace(events: Optional[List[dict]] = None,
                           pid: int = 0) -> dict:
    """Render host spans as Chrome trace format (chrome://tracing /
    perfetto), ≈ tools/timeline.py:36 _ChromeTraceFormatter."""
    events = get_events() if events is None else events
    trace = [{
        "name": ev["name"], "ph": "X", "cat": "host",
        "ts": ev["ts"], "dur": ev["dur"], "pid": pid, "tid": ev["tid"],
        "args": {},
    } for ev in events]
    meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": f"process {pid}"}}]
    return {"traceEvents": meta + trace, "displayTimeUnit": "ms"}


def save_profile(path: str, pid: int = 0) -> None:
    """Dump recorded host events as a Chrome-trace json file."""
    with open(path, "w") as f:
        json.dump(events_to_chrome_trace(pid=pid), f)
    vlog(1, f"profile written to {path}")
