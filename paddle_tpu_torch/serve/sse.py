"""Server-sent-events framing + a stdlib streaming HTTP client (port of
paddle_tpu/serve/sse.py, a copy: standard library only).

SSE is the transport of the serving front-end (frontend.py): one
`data:` frame per sampled token, a final `{"done": true, ...}` frame
carrying the finish reason and full token list, then the `[DONE]`
sentinel. A client that received `[DONE]` saw an UNTRUNCATED stream —
that is the invariant the SIGTERM drain test and serve_bench's router
scenario assert (zero streams cut off mid-generation).

The client half rides http.client (no third-party deps): it keeps the
socket exposed so a test can CLOSE it mid-stream — exactly how a
browser cancels — and the front-end turns the resulting write failure
into `engine.cancel()`.
"""

from __future__ import annotations

import json
import ssl
from http.client import HTTPConnection, HTTPSConnection
from typing import Iterator, Optional, Tuple
from urllib.parse import urlsplit

DONE_SENTINEL = "[DONE]"


def sse_event(data) -> bytes:
    """One SSE frame. Dicts are JSON-encoded; strings pass through
    (the `[DONE]` sentinel)."""
    payload = data if isinstance(data, str) else json.dumps(data)
    return f"data: {payload}\n\n".encode()


def iter_sse(fp) -> Iterator[str]:
    """Yield the data payload of each SSE frame from a readable byte
    stream — INCLUDING the `[DONE]` sentinel, then stop (so a consumer
    can tell a clean end from an EOF truncation). Multi-line data
    frames are joined per the SSE spec; comment/field lines are
    ignored."""
    data_lines = []
    while True:
        raw = fp.readline()
        if not raw:                       # EOF mid-stream: truncated
            if data_lines:
                yield "\n".join(data_lines)
            return
        line = raw.decode("utf-8", "replace").rstrip("\r\n")
        if line.startswith("data:"):
            data_lines.append(line[5:].lstrip(" "))
            continue
        if line == "" and data_lines:     # blank line: dispatch frame
            payload = "\n".join(data_lines)
            data_lines = []
            yield payload
            if payload == DONE_SENTINEL:
                return


class SSEStream:
    """A live streaming completion: iterate `events()` for decoded
    frames; `close()` mid-iteration drops the socket (client
    cancellation). `done` flips only when `[DONE]` arrived — a stream
    that ends without it was truncated."""

    def __init__(self, conn: HTTPConnection, resp):
        self._conn = conn
        self.resp = resp
        self.status = resp.status
        self.done = False
        self.events_seen = 0

    def events(self) -> Iterator[dict]:
        for payload in iter_sse(self.resp):
            if payload == DONE_SENTINEL:
                self.done = True
                break
            self.events_seen += 1
            yield json.loads(payload)
        self.close()

    def __iter__(self) -> Iterator[dict]:
        return self.events()

    def close(self) -> None:
        # close the RESPONSE too: it holds its own reference to the
        # socket (makefile), so closing only the connection would leave
        # the fd open and the server would never see the disconnect
        for obj in (self.resp, self._conn):
            try:
                obj.close()
            except Exception:
                pass


def _connect(url: str, timeout: float) -> Tuple[HTTPConnection, str]:
    parts = urlsplit(url)
    if parts.scheme == "https":
        # serve fronts run self-signed certs (make_server_tls_context):
        # encrypt the hop, skip hostname/CA verification — this client
        # talks to replicas it just started, not the open internet
        conn: HTTPConnection = HTTPSConnection(
            parts.hostname, parts.port or 443, timeout=timeout,
            context=ssl._create_unverified_context())
    else:
        conn = HTTPConnection(parts.hostname, parts.port or 80,
                              timeout=timeout)
    path = parts.path or "/"
    if parts.query:
        path += "?" + parts.query
    return conn, path


def stream_completion(base_url: str, payload: dict,
                      timeout: float = 120.0,
                      headers: Optional[dict] = None) -> SSEStream:
    """POST `payload` to `{base_url}/v1/completions` and return the
    live SSE stream (status != 200 means shed/error — read
    `.resp.read()` for the body). Extra `headers` merge over the
    defaults — how a client pins its own `x-ptpu-trace` id."""
    conn, _ = _connect(base_url, timeout)
    body = json.dumps(payload).encode()
    hdrs = {"Content-Type": "application/json",
            "Accept": "text/event-stream"}
    if headers:
        hdrs.update(headers)
    conn.request("POST", "/v1/completions", body=body, headers=hdrs)
    return SSEStream(conn, conn.getresponse())


def collect_stream(base_url: str, payload: dict,
                   timeout: float = 120.0,
                   headers: Optional[dict] = None) -> dict:
    """Drive one streaming completion to the end; returns
    {status, tokens, done (saw [DONE]), final (the done frame or
    None), trace_id (from the done frame — the handle for the fleet's
    /trace/<id>), shed_body (on non-200)}."""
    s = stream_completion(base_url, payload, timeout=timeout,
                          headers=headers)
    if s.status != 200:
        body = s.resp.read().decode("utf-8", "replace")
        s.close()
        return {"status": s.status, "tokens": [], "done": False,
                "final": None, "trace_id": None, "shed_body": body}
    tokens, final = [], None
    for ev in s.events():
        if "token" in ev:
            tokens.append(ev["token"])
        if ev.get("done"):
            final = ev
    return {"status": 200, "tokens": tokens, "done": s.done,
            "final": final,
            "trace_id": (final or {}).get("trace_id"),
            "shed_body": None}


def http_get(url: str, timeout: float = 10.0) -> Tuple[int, str]:
    """Tiny GET helper (scrapes, probes): (status, body)."""
    conn, path = _connect(url, timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode("utf-8", "replace")
    finally:
        conn.close()


def parse_prometheus_values(text: str) -> dict:
    """Flat {series: value} view of a Prometheus text exposition —
    labelled series key as `name{a="x"}` verbatim, unlabelled as
    `name`. What the router's scrape loop and serve_bench's verdicts
    read replicas' gauges/counters with."""
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            key, val = line.rsplit(" ", 1)
            out[key] = float(val)
        except ValueError:
            continue
    return out
