"""Training goodput ledger and MFU accounting (port of
paddle_tpu/obs/goodput.py).

Two independent pieces share the module because both turn raw step
mechanics into the two numbers a training fleet is judged by:

- **GoodputLedger** — goodput = productive-step-time / tracked wall
  time. It consumes the `resilience` event stream through the
  `utils.log.add_event_tap` hook, so the supervisor/trainer
  emit sites stay untouched: every rollback, bad-step skip, preempt,
  retry or chaos injection the run prints is *also* counted here, and
  the per-cause lost-time counters reconcile exactly with the event
  stream by construction. Time is attributed per attempt window: an
  `attempt()` that saw no fault event is productive; one that saw
  faults is charged to the worst cause observed (severity order
  below). Explicit `pause(cause)` windows cover the time a run spends
  outside attempts — checkpoint saves, rollback restores.

- **MFUMeter** — model FLOPs utilization from an analytic per-step
  FLOP count (`causal_lm_step_flops`, the JAX package's convention: 6
  FLOPs per parameter per token for the dense path, ``6*B*T^2*D`` per
  layer for causal attention) against the card's peak from this
  module's own table (`PEAK_FLOPS`, keyed by
  `torch.cuda.get_device_name()`). On hosts where the peak is unknown
  (CPU) and no `PTPU_PEAK_FLOPS` override is set the meter registers
  nothing — the gauge is cleanly absent rather than lying.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Optional

import torch

from paddle_tpu_torch.obs.metrics import MetricsRegistry, default_registry
from paddle_tpu_torch.utils.log import add_event_tap, remove_event_tap
from paddle_tpu_torch.utils.tree import flatten_with_keys

# worst-first: an attempt that both retried and rolled back is charged
# to the rollback (the retry time is subsumed by the larger failure)
SEVERITY = ("rollback", "preempt", "hang", "bad_step_skip",
            "ckpt_reject", "retry", "chaos_inject")


class GoodputLedger:
    """Attributes training wall time to productive work or a fault
    cause, fed by the resilience event stream (zero emit-site
    changes)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 stream: str = "resilience"):
        reg = registry if registry is not None else default_registry()
        self._stream = stream
        self._c_productive = reg.counter(
            "ptpu_goodput_productive_seconds_total",
            "Attempt time with no fault event observed")
        self._c_lost = reg.counter(
            "ptpu_goodput_lost_seconds_total",
            "Attempt/pause time charged to a fault or pause cause",
            labelnames=("cause",))
        self._c_events = reg.counter(
            "ptpu_goodput_events_total",
            "Resilience events seen by the goodput tap",
            labelnames=("cause",))
        self._g_goodput = reg.gauge(
            "ptpu_train_goodput",
            "productive seconds / (productive + lost) seconds")
        self._lock = threading.Lock()
        self._window: Optional[set] = None  # guarded-by: self._lock
        self._installed = False
        self._t_start: Optional[float] = None

    # -- event tap --------------------------------------------------------
    def install(self) -> "GoodputLedger":
        if not self._installed:
            add_event_tap(self._tap)
            self._installed = True
            self._t_start = time.perf_counter()
        return self

    def uninstall(self) -> None:
        if self._installed:
            remove_event_tap(self._tap)
            self._installed = False

    @property
    def installed(self) -> bool:
        return self._installed

    def _tap(self, stream: str, rec: Dict) -> None:
        if stream != self._stream:
            return
        evt = str(rec.get("evt", ""))
        if not evt:
            return
        self._c_events.labels(cause=evt).inc()
        with self._lock:
            if self._window is not None:
                self._window.add(evt)

    # -- time attribution -------------------------------------------------
    @contextlib.contextmanager
    def attempt(self):
        """One step attempt: productive unless a fault event lands
        inside the window."""
        with self._lock:
            self._window = set()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                causes = self._window or set()
                self._window = None
            cause = next((c for c in SEVERITY if c in causes), None)
            if cause is None and causes:
                cause = sorted(causes)[0]   # unknown event kinds still lose
            if cause is None:
                self._c_productive.inc(dt)
            else:
                self._c_lost.labels(cause=cause).inc(dt)
            self._update_gauge()

    @contextlib.contextmanager
    def pause(self, cause: str):
        """Non-attempt lost time with an explicit cause (checkpoint
        save, rollback restore)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._c_lost.labels(cause=cause).inc(time.perf_counter() - t0)
            self._update_gauge()

    def _update_gauge(self) -> None:
        p = self._c_productive.value
        lost = self._c_lost.total()
        self._g_goodput.set(p / (p + lost) if (p + lost) > 0 else 1.0)

    # -- accessors (tests, goodput_report) --------------------------------
    def goodput(self) -> float:
        return self._g_goodput.value

    def lost_seconds(self) -> Dict[str, float]:
        return {key[0]: child.value
                for key, child in self._c_lost.children().items()}

    def event_counts(self) -> Dict[str, float]:
        return {key[0]: child.value
                for key, child in self._c_events.children().items()}

    def productive_seconds(self) -> float:
        return self._c_productive.value

    def wall_seconds(self) -> float:
        if self._t_start is None:
            return 0.0
        return time.perf_counter() - self._t_start


# -- FLOPs accounting --------------------------------------------------------

def param_count(params) -> int:
    """Total scalar count of a module's parameters, or of the leaves of
    a tree of tensors or arrays."""
    if isinstance(params, torch.nn.Module):
        return int(sum(p.numel() for p in params.parameters()))
    return int(sum(leaf.numel() if isinstance(leaf, torch.Tensor)
                   else getattr(leaf, "size", 0)
                   for _, leaf in flatten_with_keys(params)))


def causal_lm_step_flops(*, batch_size: int, seq_len: int, d_model: int,
                         n_layers: int, n_params: int,
                         include_attention: bool = True) -> float:
    """Analytic train-step FLOPs for a causal transformer LM.

    Dense path: 6 FLOPs per parameter per token (fwd 2 + bwd 4).
    Attention: ``6 * B * T^2 * D`` per layer — the JAX package's
    convention (paddle_tpu/benchmark/models.py bench_causal_lm), so the
    two packages' MFU figures count the same work.
    """
    tokens = batch_size * seq_len
    flops = 6.0 * tokens * float(n_params)
    if include_attention:
        flops += 6.0 * batch_size * float(seq_len) ** 2 * d_model * n_layers
    return flops


# Dense peaks by `torch.cuda.get_device_name()` and operand width in
# bits: the H100 SXM figures of NVIDIA's data sheet, bf16/fp16 on the
# tensor cores and float32 outside them (the port leaves TF32 off, so a
# float32 product runs at the float32 rate — not the TPU rule of half
# the bf16 rate).
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {16: 989.4e12, 32: 66.9e12},
}


def resolve_peak_flops(dtype_bits: int = 16) -> Optional[float]:
    """Peak FLOP/s for MFU: `PTPU_PEAK_FLOPS` env override first, then
    `PEAK_FLOPS` keyed by the card's name, else None (CPU, or a card
    the table does not list)."""
    env = os.environ.get("PTPU_PEAK_FLOPS", "").strip()
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    if not torch.cuda.is_available():
        return None
    return PEAK_FLOPS.get(torch.cuda.get_device_name(), {}).get(dtype_bits)


class MFUMeter:
    """Publishes `ptpu_train_mfu` from per-step wall time. Registers
    nothing when the platform peak is unknown (gauge cleanly absent on
    CPU) — callers can pass `peak_flops` explicitly to force it."""

    def __init__(self, flops_per_step: float,
                 peak_flops: Optional[float] = None,
                 registry: Optional[MetricsRegistry] = None,
                 alpha: float = 0.25):
        self._flops = float(flops_per_step or 0.0)
        self._peak = (peak_flops if peak_flops is not None
                      else resolve_peak_flops())
        self._alpha = alpha
        self._ema: Optional[float] = None
        self.enabled = bool(self._flops > 0 and self._peak)
        if self.enabled:
            reg = registry if registry is not None else default_registry()
            self._g_mfu = reg.gauge(
                "ptpu_train_mfu",
                "Model FLOPs utilization of the training step (0..1)")

    def observe_step(self, seconds: float) -> Optional[float]:
        """Feed one productive step's wall time; returns current MFU."""
        if not self.enabled or seconds <= 0:
            return None
        mfu = self._flops / (seconds * self._peak)
        self._ema = (mfu if self._ema is None
                     else self._alpha * mfu + (1 - self._alpha) * self._ema)
        self._g_mfu.set(self._ema)
        return self._ema

    @property
    def mfu(self) -> Optional[float]:
        return self._ema
