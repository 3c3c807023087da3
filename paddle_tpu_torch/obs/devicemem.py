"""Device memory telemetry (port of paddle_tpu/obs/devicemem.py).

Polls per-device memory into two gauge families so a training scrape
shows the footprint and the high-water mark:

- `ptpu_hbm_bytes_in_use{device=}` — current allocated bytes;
- `ptpu_hbm_peak_bytes{device=}` — peak watermark.

On a card the source of truth is PyTorch's caching allocator,
`torch.cuda.memory_stats(dev)` (`allocated_bytes.all.current` and
`.peak`, the figures `torch.cuda.memory_allocated` and
`max_memory_allocated` read), where JAX reads `Device.memory_stats()`.
A CPU device has no allocator stats, so the monitor sums the distinct
storages of the live tensors on it (found through `gc`, the
counterpart of `jax.live_arrays()`) and tracks its own peak across
samples, which never falls. `sample()` is an explicit poll (no device
sync); callers decide the cadence.
"""

from __future__ import annotations

import gc
from typing import Dict, Optional, Sequence

import torch

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.obs.metrics import MetricsRegistry, default_registry


def _live_bytes(dev: torch.device) -> int:
    """Bytes of the distinct untyped storages of live tensors on `dev`."""
    return sum(_live_storages(dev).values())


def _live_storages(dev: torch.device) -> Dict[int, int]:
    """The distinct untyped storages of live tensors on `dev`: data
    pointer -> bytes. Traced tensors (a trace's FakeTensors) hold none."""
    from torch._subclasses.fake_tensor import FakeTensor
    seen: Dict[int, int] = {}
    for obj in gc.get_objects():
        # type(), not isinstance(): isinstance reads __class__, which
        # some lazily deprecated objects answer with a warning
        if (not issubclass(type(obj), torch.Tensor)
                or issubclass(type(obj), FakeTensor)):
            continue
        try:
            if obj.device != dev:
                continue
            storage = obj.untyped_storage()
            ptr = storage.data_ptr()
        except (RuntimeError, NotImplementedError, ReferenceError):
            continue     # meta, sparse, freed or fake (traced) tensors
        seen[ptr] = storage.nbytes()
    return seen


class DeviceMemoryMonitor:
    """Per-device memory gauges, labelled `d{index}`. `devices` defaults
    to every CUDA device (raises without a card); pass `devices=["cpu"]`
    to account the CPU's live tensors."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 devices: Optional[Sequence] = None):
        reg = registry if registry is not None else default_registry()
        self._g_bytes = reg.gauge(
            "ptpu_hbm_bytes_in_use",
            "Current allocated device memory bytes",
            labelnames=("device",))
        self._g_peak = reg.gauge(
            "ptpu_hbm_peak_bytes",
            "Peak allocated device memory bytes seen",
            labelnames=("device",))
        if devices is None:
            resolve_device(None)          # raises without a card
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self._devices = [resolve_device(d) for d in devices]
        self._own_peak: Dict[str, float] = {}
        #: True once any sampled device reported allocator stats
        self.allocator_backed = False

    def sample(self) -> Dict[str, Dict[str, float]]:
        """Poll every device; update gauges; return
        {device_label: {"bytes_in_use": .., "peak_bytes": ..}}."""
        out: Dict[str, Dict[str, float]] = {}
        for dev in self._devices:
            label = f"d{dev.index or 0}"
            if dev.type == "cuda":
                self.allocator_backed = True
                stats = torch.cuda.memory_stats(dev)
                in_use = float(stats.get("allocated_bytes.all.current", 0))
                peak = float(stats.get("allocated_bytes.all.peak", in_use))
            else:
                in_use = float(_live_bytes(dev))
                peak = in_use
            self._own_peak[label] = max(self._own_peak.get(label, 0.0),
                                        peak)
            peak = self._own_peak[label]
            self._g_bytes.labels(device=label).set(in_use)
            self._g_peak.labels(device=label).set(peak)
            out[label] = {"bytes_in_use": in_use, "peak_bytes": peak}
        return out
