"""The structured event streams (port of paddle_tpu/utils/log.py).

Every stream (`serve`, `obs`) emits single-line JSON records on STDOUT
(`{"evt": "serve_done", ...}`) so log scrapers consume one format.
Every record is stamped with a monotonic `ts` (seconds, time.monotonic)
and a per-stream gap-free `seq`; `evt` always sorts first. Loggers are
named `paddle_tpu_torch.<stream>`, so a caller silences a stream with
`logging.getLogger("paddle_tpu_torch.serve").disabled = True`.
"""

from __future__ import annotations

import json
import logging
import sys
import threading
import time
from typing import Dict


class _StdoutHandler(logging.Handler):
    """Writes to whatever sys.stdout is AT EMIT TIME (not at import):
    pytest's capsys and subprocess pipes both swap sys.stdout, and a
    handler bound to the import-time stream would bypass them."""

    def emit(self, record: logging.LogRecord) -> None:
        try:
            stream = sys.stdout
            stream.write(record.getMessage() + "\n")
            stream.flush()
        except Exception:
            pass  # logging must never take the run down


_STREAMS: Dict[str, logging.Logger] = {}
_SEQ: Dict[str, int] = {}
_SEQ_LOCK = threading.Lock()


def _stream_logger(stream: str) -> logging.Logger:
    lg = _STREAMS.get(stream)
    if lg is None:
        lg = logging.getLogger(f"paddle_tpu_torch.{stream}")
        if not lg.handlers:
            lg.addHandler(_StdoutHandler())
            lg.setLevel(logging.INFO)
            lg.propagate = False
        _STREAMS[stream] = lg
    return lg


def emit_event(stream: str, evt: str, **fields) -> dict:
    """One single-line JSON record on stdout; returns the dict.

    "evt" sorts first; `ts` (monotonic seconds) and `seq` (per-stream,
    0-based, gap-free) are stamped LAST; non-JSON-native values go
    through str()."""
    with _SEQ_LOCK:
        seq = _SEQ.get(stream, 0)
        _SEQ[stream] = seq + 1
    rec = {"evt": evt, **fields}
    rec["ts"] = round(time.monotonic(), 6)
    rec["seq"] = seq
    _stream_logger(stream).info(json.dumps(rec, sort_keys=False, default=str))
    return rec


def serve_event(evt: str, **fields) -> dict:
    """Serve stream (logger `paddle_tpu_torch.serve`). Canonical
    events: `serve_admit`, `serve_prefill` / `serve_decode` (per-step
    batch shape + KV-cache occupancy), `serve_preempt`, `serve_cancel`,
    `serve_done` (per-request TTFT ms, decode tokens/sec, token
    count), `serve_config_clamp`."""
    return emit_event("serve", evt, **fields)


def obs_event(evt: str, **fields) -> dict:
    """Telemetry stream (logger `paddle_tpu_torch.obs`). Canonical
    events: `obs_snapshot` (metrics-registry dump)."""
    return emit_event("obs", evt, **fields)
