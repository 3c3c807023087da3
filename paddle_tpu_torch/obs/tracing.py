"""Per-request lifecycle tracing for the serve engine.

Port of paddle_tpu/obs/tracing.py's RequestTracer (the class is a copy;
the profiler-merging helpers `merged_chrome_trace`/`stitch_fragments`
wait for the profiler port). `now_us` is a copy of
paddle_tpu/profiler/profiler.py's clock, so traces of either package
share one epoch-anchored timeline.

Each request's life is a sequence of host-side SPANS —
queued -> prefill -> decode, re-entering queued on preemption — plus
instant marks (per prefill chunk, first token, preempt, done).
ServeEngine/Scheduler drive the transitions (engine/engine.py), and
the tracer turns them into:

- derived latencies (`durations_ms`) — what feeds the TTFT / TPOT /
  queue-wait / e2e histograms in the metrics registry;
- a Chrome-trace JSON (`to_chrome_trace`) with one trace-row (tid)
  per request, timestamped on the epoch-anchored `now_us` clock.

Completed requests are retained in a bounded deque (`keep_last`) so a
long-lived engine cannot leak trace state; live requests hold only
their own spans.

FLEET TRACING: a request that crosses processes (router -> replica)
carries an `x-ptpu-trace` header; each process tags its local req_id
with the fleet trace id via `set_trace_id`, and `trace_fragment(tid)`
exports just that request's spans (each span arg-tagged with the
trace id) as a standalone Chrome-trace fragment. The router's
/trace/<id> endpoint fetches every replica's fragment plus its own
relay spans and stitches them per-process with the timeline merger —
one trace id, one timeline, per-process pids. Because now_us() is
epoch-anchored, fragments from different processes line up without
clock shifting.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

# Wall-clock anchor for the monotonic counter: timestamps are epoch-based
# microseconds so traces from different processes merge on one timeline.
_EPOCH_NS = time.time_ns() - time.perf_counter_ns()


def now_us() -> float:
    """Epoch-anchored monotonic microseconds."""
    return (_EPOCH_NS + time.perf_counter_ns()) / 1e3


# span names, in lifecycle order
QUEUED, PREFILL, DECODE = "queued", "prefill", "decode"


class RequestTracer:
    """Records span transitions per req_id; every hook is a no-op when
    `enabled` is False (flip at runtime — no engine restart)."""

    def __init__(self, keep_last: int = 2048, enabled: bool = True,
                 process_name: str = "serve requests"):
        self.enabled = enabled
        self.process_name = process_name
        self._lock = threading.Lock()
        self._events: Dict[int, List[dict]] = {}     # guarded-by: self._lock
        self._open: Dict[int, dict] = {}             # guarded-by: self._lock
        self._done: Deque[Tuple[int, List[dict]]] = deque(maxlen=keep_last)  # guarded-by: self._lock
        self._trace_of: Dict[int, str] = {}          # guarded-by: self._lock
        self._req_of: Dict[str, int] = {}            # guarded-by: self._lock

    # -- lifecycle hooks (engine-facing) ----------------------------------
    def on_enqueue(self, req_id: int) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._open_span(req_id, QUEUED)

    def on_admit(self, req_id: int) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._open_span(req_id, PREFILL)

    def on_chunk(self, req_id: int, start: int, length: int) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._mark(req_id, "chunk", start=start, length=length)

    def on_first_token(self, req_id: int) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._mark(req_id, "first_token")
            self._open_span(req_id, DECODE)

    def on_preempt(self, req_id: int) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._mark(req_id, "preempt")
            self._open_span(req_id, QUEUED)   # back to the wait queue

    def on_finish(self, req_id: int, reason: str = "") -> None:
        if not self.enabled:
            return
        with self._lock:
            self._mark(req_id, "done", reason=reason)
            self._close_span(req_id)
            evs = self._events.pop(req_id, None)
            if evs is not None:
                if len(self._done) == self._done.maxlen:
                    # the deque is about to evict its oldest entry —
                    # drop that request's trace-id mapping with it so
                    # the id maps stay bounded by keep_last too
                    old_rid, _ = self._done[0]
                    old_tid = self._trace_of.pop(old_rid, None)
                    if old_tid is not None:
                        self._req_of.pop(old_tid, None)
                self._done.append((req_id, evs))

    # -- fleet trace ids ---------------------------------------------------
    def set_trace_id(self, req_id: int, trace_id: str) -> None:
        """Tag a local request with the fleet-wide trace id it arrived
        with (`x-ptpu-trace`); idempotent, survives until the request
        is evicted from the done deque."""
        if not self.enabled or not trace_id:
            return
        with self._lock:
            self._trace_of[req_id] = trace_id
            self._req_of[trace_id] = req_id

    def trace_id_of(self, req_id: int) -> Optional[str]:
        with self._lock:
            return self._trace_of.get(req_id)

    def request_of_trace(self, trace_id: str) -> Optional[int]:
        with self._lock:
            return self._req_of.get(trace_id)

    # -- generic spans (router relay rows) ---------------------------------
    def span_begin(self, req_id: int, name: str) -> None:
        """Open an arbitrary named span (closing any open one) — what
        the router uses for its route/relay rows, where the lifecycle
        hooks above don't apply."""
        if not self.enabled:
            return
        with self._lock:
            self._open_span(req_id, name)

    def span_end(self, req_id: int) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._close_span(req_id)

    def mark(self, req_id: int, name: str, **args) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._mark(req_id, name, **args)

    # -- internals (lock held) --------------------------------------------
    # requires-lock: self._lock
    def _open_span(self, req_id: int, name: str) -> None:
        self._close_span(req_id)
        ev = {"name": name, "ph": "X", "ts": now_us(), "dur": None}
        self._open[req_id] = ev
        self._events.setdefault(req_id, []).append(ev)

    # requires-lock: self._lock
    def _close_span(self, req_id: int) -> None:
        ev = self._open.pop(req_id, None)
        if ev is not None:
            ev["dur"] = now_us() - ev["ts"]

    # requires-lock: self._lock
    def _mark(self, req_id: int, name: str, **args) -> None:
        self._events.setdefault(req_id, []).append(
            {"name": name, "ph": "i", "ts": now_us(), "args": args})

    # -- reads ------------------------------------------------------------
    def _events_of(self, req_id: int) -> List[dict]:
        with self._lock:
            evs = list(self._events.get(req_id, ()))
            if not evs:
                for rid, done in self._done:
                    if rid == req_id:
                        evs = list(done)
            return evs

    def durations_ms(self, req_id: int) -> Dict[str, float]:
        """Total CLOSED-span wall time per phase (ms), summed across
        preemption re-entries; phases with no closed span are absent."""
        out: Dict[str, float] = {}
        for ev in self._events_of(req_id):
            if ev["ph"] == "X" and ev["dur"] is not None:
                out[ev["name"]] = out.get(ev["name"], 0.0) + ev["dur"] / 1e3
        return out

    def to_chrome_trace(self, pid: int = 1) -> dict:
        """Chrome trace: one tid per request, spans as 'X' (unfinished
        ones clipped to now), marks as thread-scoped instants. Spans of
        requests tagged with a fleet trace id carry it in args."""
        with self._lock:
            per_req = [(rid, list(evs)) for rid, evs in self._done]
            per_req += [(rid, list(evs))
                        for rid, evs in sorted(self._events.items())]
            trace_of = dict(self._trace_of)
        events: List[dict] = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": self.process_name}}]
        now = now_us()
        for rid, evs in per_req:
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": rid, "args": {"name": f"req {rid}"}})
            events.extend(self._chrome_events(
                rid, evs, pid, now, trace_of.get(rid)))
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    @staticmethod
    def _chrome_events(rid: int, evs: List[dict], pid: int, now: float,
                       trace_id: Optional[str]) -> List[dict]:
        out: List[dict] = []
        span_args = {"trace_id": trace_id} if trace_id else {}
        for ev in evs:
            if ev["ph"] == "X":
                out.append({
                    "name": ev["name"], "ph": "X", "cat": "request",
                    "ts": ev["ts"],
                    "dur": ev["dur"] if ev["dur"] is not None
                    else now - ev["ts"],
                    "pid": pid, "tid": rid, "args": dict(span_args)})
            else:
                args = dict(ev.get("args", {}))
                args.update(span_args)
                out.append({
                    "name": ev["name"], "ph": "i", "s": "t",
                    "cat": "request", "ts": ev["ts"],
                    "pid": pid, "tid": rid, "args": args})
        return out

    def trace_fragment(self, trace_id: str, pid: int = 1) -> Optional[dict]:
        """Standalone Chrome-trace fragment for ONE fleet trace id —
        what a replica serves on /trace/<id> and the router stitches
        into the cross-process timeline. None when the id is unknown
        here (the router treats that as 'not my request')."""
        with self._lock:
            rid = self._req_of.get(trace_id)
            if rid is None:
                return None
            evs = list(self._events.get(rid, ()))
            if not evs:
                for drid, done in self._done:
                    if drid == rid:
                        evs = list(done)
        events: List[dict] = [
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": self.process_name}},
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": rid,
             "args": {"name": f"req {rid}"}},
        ]
        events.extend(self._chrome_events(rid, evs, pid, now_us(), trace_id))
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "trace_id": trace_id, "req_id": rid}

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._open.clear()
            self._done.clear()
            self._trace_of.clear()
            self._req_of.clear()

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
