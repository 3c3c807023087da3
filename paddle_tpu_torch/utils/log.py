"""Leveled logging and the structured event streams (port of
paddle_tpu/utils/log.py).

Verbosity comes from FLAGS_v / GLOG_v, re-read PER CALL, and
`set_verbosity` overrides it at runtime, so a test or an operator can
raise it mid-run.

Every stream (`resilience`, `serve`, `obs`) emits single-line JSON
records on STDOUT (`{"evt": "rollback", ...}`) so log scrapers consume
one format. Every record is stamped with a monotonic `ts` (seconds,
time.monotonic) and a per-stream gap-free `seq`; `evt` always sorts
first. Loggers are named `paddle_tpu_torch.<stream>`, so a caller
silences a stream with
`logging.getLogger("paddle_tpu_torch.serve").disabled = True`.
In-process taps (`add_event_tap`) see every record too: the goodput
ledger and the flight recorder feed on them.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

_LOGGER = logging.getLogger("paddle_tpu_torch")
if not _LOGGER.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter(
        "%(levelname).1s %(asctime)s paddle_tpu_torch %(message)s",
        "%H:%M:%S"))
    _LOGGER.addHandler(_h)
    _LOGGER.setLevel(logging.INFO)
    _LOGGER.propagate = False

# runtime override; None defers to the env (read per call)
_VERBOSITY_OVERRIDE: Optional[int] = None


def get_verbosity() -> int:
    if _VERBOSITY_OVERRIDE is not None:
        return _VERBOSITY_OVERRIDE
    try:
        return int(os.environ.get("FLAGS_v", os.environ.get("GLOG_v", "0")))
    except ValueError:
        return 0


def set_verbosity(level: Optional[int]) -> Optional[int]:
    """Set the VLOG threshold at runtime (None reverts to the env
    vars). Returns the previous override so callers can restore it."""
    global _VERBOSITY_OVERRIDE
    prev = _VERBOSITY_OVERRIDE
    _VERBOSITY_OVERRIDE = None if level is None else int(level)
    return prev


def vlog(level: int, msg: str, *args) -> None:
    if level <= get_verbosity():
        _LOGGER.info(msg, *args)


def info(msg: str, *args) -> None:
    _LOGGER.info(msg, *args)


def warning(msg: str, *args) -> None:
    _LOGGER.warning(msg, *args)


def error(msg: str, *args) -> None:
    _LOGGER.error(msg, *args)


# -- unified event streams ---------------------------------------------------

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

# In-process event taps: callables invoked with (stream, record) for
# every emitted event AFTER it hits stdout. Taps run OUTSIDE _SEQ_LOCK,
# from a copy of the list, and their exceptions are swallowed: a broken
# tap must never take the run down or reorder sequence numbers.
_TAPS: List[Callable[[str, dict], None]] = []   # guarded-by: _TAPS_LOCK
_TAPS_LOCK = threading.Lock()


def add_event_tap(fn: Callable[[str, dict], None]) -> None:
    """Register a tap called with (stream, record) for every event."""
    with _TAPS_LOCK:
        if fn not in _TAPS:
            _TAPS.append(fn)


def remove_event_tap(fn: Callable[[str, dict], None]) -> None:
    """Unregister a tap; unknown taps are ignored."""
    with _TAPS_LOCK:
        try:
            _TAPS.remove(fn)
        except ValueError:
            pass


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
    with _TAPS_LOCK:
        taps = list(_TAPS)
    for tap in taps:
        try:
            tap(stream, rec)
        except Exception:
            pass  # a broken tap must never take the run down
    return rec


def resilience_event(evt: str, **fields) -> dict:
    """Resilience stream (logger `paddle_tpu_torch.resilience`).
    Canonical events: `preempt`, `ckpt_reject`, `bad_step_skip`,
    `rollback`, `retry`, `retry_budget_exhausted`, `chaos_inject`,
    `chaos_net`, `hang`."""
    return emit_event("resilience", evt, **fields)


def serve_event(evt: str, **fields) -> dict:
    """Serve stream (logger `paddle_tpu_torch.serve`). Canonical
    events: `serve_admit`, `serve_prefill` / `serve_decode` (per-step
    batch shape + KV-cache occupancy), `serve_preempt`, `serve_cancel`,
    `serve_done` (per-request TTFT ms, decode tokens/sec, token
    count), `serve_config_clamp`."""
    return emit_event("serve", evt, **fields)


def obs_event(evt: str, **fields) -> dict:
    """Telemetry stream (logger `paddle_tpu_torch.obs`). Canonical
    events: `obs_snapshot` (metrics-registry dump), `obs_postmortem`
    (a flight-recorder bundle)."""
    return emit_event("obs", evt, **fields)


class scoped_timer:
    """`with scoped_timer("phase"):` — logs wall time of the block at
    VLOG(1)."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        vlog(1, "%s took %.3fs", self.name, time.perf_counter() - self.t0)
        return False
