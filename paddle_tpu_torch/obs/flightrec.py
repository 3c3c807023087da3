"""Flight recorder: postmortem ring buffer + state snapshot dumps (port
of paddle_tpu/obs/flightrec.py).

A long-lived serving replica fails in ways a live scrape cannot
explain after the fact: by the time an operator looks, the stalled
step, the queue that backed up, and the preemption storm that caused
it are gone. The flight recorder keeps the LAST `capacity` structured
events (the same `serve`/`resilience`/`obs` records utils/log.py
emits on stdout, captured via its event-tap hook — zero changes at
any emit site) in a bounded ring, and on a trigger dumps a single
JSON bundle:

    {"trigger": ..., "context": {...}, "events": [...ring...],
     "state": <snapshot_fn()>, "dumped_ts": <monotonic s>}

Triggers wired by `train_resilient` (resilience/supervisor.py):
- watchdog stall       — RunSupervisor.on_hang fires mid-step;
- training crash       — a step raises.
The serve front-end (serve/frontend.py) wires a watchdog stall of an
engine step, SLO burn onset, the drain deadline and an engine-loop
crash.

`snapshot_fn` is typically a metrics-registry snapshot (training) or
the engine's debug state (serving). It is called
best-effort from WHATEVER thread triggered the dump (a watchdog
firing means the engine thread is wedged, so a locked snapshot could
never be taken); a snapshot that raises is recorded as an error
rather than losing the bundle.

Bundles write to `out_dir` (flightrec-<trigger>-<n>.json) and are
announced as an `obs_postmortem` event on the obs stream, so log
scrapers see the dump happen; the latest bundle is also held in
memory for the `/debug/flightrec` route.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence

from paddle_tpu_torch.obs.metrics import MetricsRegistry
from paddle_tpu_torch.utils.log import add_event_tap, obs_event, remove_event_tap


class FlightRecorder:
    """Bounded in-memory ring of recent events + triggered postmortem
    bundles. `install()` hooks the process-wide event streams; always
    `uninstall()` (or use as a context manager) so a torn-down replica
    does not keep recording."""

    def __init__(self, capacity: int = 512,
                 streams: Sequence[str] = ("serve", "resilience"),
                 snapshot_fn: Optional[Callable[[], dict]] = None,
                 out_dir: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.capacity = int(capacity)
        self.streams = frozenset(streams)
        self.snapshot_fn = snapshot_fn
        self.out_dir = out_dir
        self._lock = threading.Lock()
        self._ring: Deque[dict] = deque(maxlen=self.capacity)  # guarded-by: self._lock
        self._dumps: List[str] = []          # guarded-by: self._lock
        self._last: Optional[dict] = None    # guarded-by: self._lock
        self._seq = 0                        # guarded-by: self._lock
        self._installed = False
        self._c_dumps = None
        if registry is not None:
            self._c_dumps = registry.counter(
                "ptpu_flightrec_dumps_total",
                "Flight-recorder postmortem bundles dumped", ("trigger",))

    # -- capture -----------------------------------------------------------
    def install(self) -> "FlightRecorder":
        if not self._installed:
            add_event_tap(self._tap)
            self._installed = True
        return self

    def uninstall(self) -> None:
        if self._installed:
            remove_event_tap(self._tap)
            self._installed = False

    @property
    def installed(self) -> bool:
        return self._installed

    def __enter__(self) -> "FlightRecorder":
        return self.install()

    def __exit__(self, *exc) -> bool:
        self.uninstall()
        return False

    def _tap(self, stream: str, rec: dict) -> None:
        if stream not in self.streams:
            return
        with self._lock:
            self._ring.append({"stream": stream, **rec})

    def record(self, stream: str, evt: str, **fields) -> None:
        """Append an event to the ring directly (no stdout emission) —
        for components that want flight-recorder-only breadcrumbs."""
        rec = {"stream": stream, "evt": evt, **fields}
        rec["ts"] = round(time.monotonic(), 6)
        with self._lock:
            self._ring.append(rec)

    # -- postmortem --------------------------------------------------------
    def _snapshot(self) -> dict:
        if self.snapshot_fn is None:
            return {}
        try:
            return self.snapshot_fn()
        except Exception as e:  # snapshot is best-effort by design
            return {"snapshot_error": repr(e)}

    def dump(self, trigger: str, **context) -> dict:
        """Freeze the ring + a state snapshot into one bundle; write it
        to out_dir when configured and announce it on the obs stream.
        Safe to call from any thread, including a watchdog observing a
        wedged engine loop."""
        with self._lock:
            events = list(self._ring)
            self._seq += 1
            seq = self._seq
        bundle = {
            "trigger": trigger,
            "context": context,
            "events": events,
            "state": self._snapshot(),
            "dumped_ts": round(time.monotonic(), 6),
        }
        path = None
        if self.out_dir:
            try:
                os.makedirs(self.out_dir, exist_ok=True)
                path = os.path.join(
                    self.out_dir, f"flightrec-{trigger}-{seq}.json")
                with open(path, "w") as f:
                    json.dump(bundle, f, default=str)
            except OSError as e:
                bundle["write_error"] = repr(e)
                path = None
        if path:
            bundle["path"] = path
        with self._lock:
            self._last = bundle
            if path:
                self._dumps.append(path)
        if self._c_dumps is not None:
            self._c_dumps.labels(trigger=trigger).inc()
        obs_event("obs_postmortem", trigger=trigger,
                  path=path, events=len(events), **context)
        return bundle

    # -- reads -------------------------------------------------------------
    def ring(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def last_bundle(self) -> Optional[dict]:
        with self._lock:
            return self._last

    def dump_paths(self) -> List[str]:
        with self._lock:
            return list(self._dumps)

    def debug_payload(self) -> Dict[str, object]:
        """JSON body for /debug/flightrec: recorder config, dump
        inventory, and the latest bundle inline."""
        with self._lock:
            return {
                "capacity": self.capacity,
                "streams": sorted(self.streams),
                "installed": self._installed,
                "ring_len": len(self._ring),
                "dumps": list(self._dumps),
                "last": self._last,
            }
