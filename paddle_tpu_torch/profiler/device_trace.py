"""Device-tier op-time tables from torch.profiler traces (port of
paddle_tpu/profiler/device_trace.py).

The reference's device tier is CUPTI records aggregated into op-time
tables (platform/device_tracer.h:39, EnableProfiler/DisableProfiler
printing sorted tables). JAX parses `jax.profiler`'s HLO events; the
port parses the Chrome trace `torch.profiler` writes (Kineto, over
CUPTI):

- the device events are those with `cat` in `kernel`, `gpu_memcpy` and
  `gpu_memset` (a `gpu_user_annotation` spans kernels already counted);
- each one carries the `External id` of the host op that was innermost
  when it was launched (a `cpu_op` such as `aten::mm` or the port's
  `paddle_tpu_torch::flash_fwd` operator, or a `user_annotation`);
  `by="category"` groups kernels under that op's name, the counterpart
  of JAX's `hlo_category`, and `by="op"` keeps each kernel's name;
- `flops` is the launching op's `flops` (captured `with_flops=True`;
  PyTorch counts them for matmuls and convolutions), given to the first
  kernel the op launched, so an op of several kernels is counted once;
- `bytes_accessed` is 0: the trace records no bytes for a kernel, so
  `OpRow.gbps` reads 0 (a memcpy's bytes are not counted either).

Usage:
    with device_trace("/tmp/trace"):
        for _ in range(5):
            trainer.train_step(batch)
    table = op_table("/tmp/trace", steps=5)
    print(format_table(table))
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from paddle_tpu_torch.profiler.profiler import start_capture, stop_capture

#: the trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the trace categories of host ops a device event can link to
HOST_CATS = ("cpu_op", "user_annotation")


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace around a block into
    `log_dir/<host>.<pid>.trace.json.gz` (the start/stop pair the
    reference exposes as EnableProfiler/Disable)."""
    prof = start_capture()
    try:
        yield
    finally:
        stop_capture(prof, log_dir)


@dataclass
class OpRow:
    name: str                 # kernel name, or the host op launching it
    total_ms: float           # device time over the captured window
    count: int
    bytes_accessed: int       # 0: the trace records no kernel bytes
    flops: int

    @property
    def gbps(self) -> float:
        return (self.bytes_accessed / (self.total_ms / 1e3) / 1e9
                if self.total_ms else 0.0)

    @property
    def tflops(self) -> float:
        return (self.flops / (self.total_ms / 1e3) / 1e12
                if self.total_ms else 0.0)


def _load_events(log_dir: str) -> List[Tuple[dict, Optional[dict]]]:
    """(device event, the host op that launched it or None) from EVERY
    trace file under log_dir (several processes write one each;
    aggregating only one would understate an N-process job ~N×)."""
    paths = sorted(glob.glob(f"{log_dir}/**/*.trace.json.gz",
                             recursive=True))
    if not paths:
        raise FileNotFoundError(f"no trace.json.gz under {log_dir}")
    out: List[Tuple[dict, Optional[dict]]] = []
    for path in paths:
        with gzip.open(path, "rt") as f:
            data = json.load(f)
        evs = [ev for ev in data.get("traceEvents", [])
               if ev.get("ph") == "X"]
        # external ids are unique within one file
        host = {ev["args"]["External id"]: ev for ev in evs
                if ev.get("cat") in HOST_CATS
                and "External id" in ev.get("args", {})}
        out.extend((ev, host.get(ev.get("args", {}).get("External id")))
                   for ev in evs if ev.get("cat") in DEVICE_CATS)
    return out


def op_table(log_dir: str, by: str = "category", steps: int = 1,
             top: Optional[int] = None) -> List[OpRow]:
    """Aggregate device op time. by="category" groups by the host op
    that launched each kernel (`aten::mm`, `paddle_tpu_torch::flash_fwd`,
    ...; a device event with no host op under its own `cat`); by="op"
    keeps individual kernel names. Durations are divided by `steps` to
    report per-step numbers. Sorted by time, descending."""
    dur = collections.Counter()
    cnt = collections.Counter()
    flp = collections.Counter()
    counted = set()
    for ev, op in _load_events(log_dir):
        if by == "category":
            key = op["name"] if op is not None else ev["cat"]
        else:
            key = ev["name"]
        dur[key] += ev.get("dur", 0)
        cnt[key] += 1
        if op is not None and id(op) not in counted:
            counted.add(id(op))
            flp[key] += int(op["args"].get("flops", 0) or 0)
    rows = [OpRow(name=k, total_ms=dur[k] / 1e3 / steps,
                  count=max(cnt[k] // steps, 1),
                  bytes_accessed=0,
                  flops=flp[k] // steps)
            for k in dur]
    rows.sort(key=lambda r: -r.total_ms)
    return rows[:top] if top else rows


def format_table(rows: List[OpRow]) -> str:
    """EnableProfiler-style sorted table."""
    total = sum(r.total_ms for r in rows) or 1e-12
    lines = [f"{'ms/step':>9} {'%':>6} {'calls':>6} {'GB/s':>8} "
             f"{'TF/s':>7}  name",
             "-" * 72]
    for r in rows:
        lines.append(f"{r.total_ms:9.3f} {100 * r.total_ms / total:6.1f} "
                     f"{r.count:6d} {r.gbps:8.1f} {r.tflops:7.2f}  "
                     f"{r.name[:40]}")
    lines.append(f"{total:9.3f}  total device time")
    return "\n".join(lines)
