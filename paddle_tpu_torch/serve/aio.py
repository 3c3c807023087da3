"""Asyncio connection layer shared by the serve front-end and router
(port of paddle_tpu/serve/aio.py, a copy: standard library only).

The engine was designed for this split from day one: ALL engine
mutation happens on ONE engine-loop thread, and connection handlers
only touch thread-safe queues. So the connection side is free to be an
event loop instead of a thread per connection — thousands of idle SSE
streams become coroutines parked on queues, and the process holds a
CONSTANT number of OS threads no matter how many clients are attached
(`ptpu_serve_conn_threads` vs `ptpu_serve_open_connections` is the
scaling claim, and serve_bench's `soak` cell measures it).

One daemon "acceptor" thread owns a private event loop and an
`asyncio.start_server`. Each accepted connection runs `_client()`:
parse ONE request (HTTP/1.0 style — SSE bodies are close-delimited, no
chunking, `Connection: close`), invoke the async handler, close. That
is byte-compatible with the stdlib `http.client` front the tests and
the SSE client (serve/sse.py) already speak.

What the loop buys over ThreadingHTTPServer:

- DISCONNECTS come from the transport: a parked `reader.read()`
  coroutine resolves the moment the peer closes, replacing the old
  per-stream `select` + `MSG_PEEK` poll.
- BACKPRESSURE is per-connection: every write awaits
  `writer.drain()` under a deadline (`write_deadline_s`); a client
  that stops reading trips `SlowClientError`, the transport is
  aborted, and the caller evicts the stream (frees its KV) instead of
  wedging a handler thread on a full socket buffer.
- TLS is one `ssl.SSLContext` on the listening transport
  (`make_server_tls_context`), no extra moving parts.

Blocking sub-paths that async handlers still need (KV prefix pulls,
replica probes) go through `loop.run_in_executor` — the default
executor is a small bounded pool, so the thread count stays flat.
"""

from __future__ import annotations

import asyncio
import json
import socket
import ssl
import threading
from http.client import responses as _STATUS_TEXT
from typing import Awaitable, Callable, Dict, Optional, Tuple

from paddle_tpu_torch.serve.sse import DONE_SENTINEL

_MAX_BODY_BYTES = 16 * 1024 * 1024    # absurdly-large-body guard
_REQUEST_TIMEOUT_S = 30.0             # header+body must arrive by then


class SlowClientError(Exception):
    """The peer failed to drain our writes within the write deadline:
    a stalled reader. The transport has already been aborted when this
    raises — the caller's job is to cancel the stream's engine work."""


class AioRequest:
    """One parsed request: method, path, lower-cased header dict, and
    the (possibly empty) body bytes — already fully read, so handlers
    never touch the socket for input."""

    __slots__ = ("method", "path", "headers", "body")

    def __init__(self, method: str, path: str, headers: Dict[str, str],
                 body: bytes):
        self.method = method
        self.path = path
        self.headers = headers
        self.body = body

    def header(self, name: str, default: Optional[str] = None
               ) -> Optional[str]:
        return self.headers.get(name.lower(), default)


class AioConnection:
    """The write half handed to handlers: deadline-bounded writes,
    response helpers, and the transport-level disconnect watch."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter,
                 write_deadline_s: float = 30.0):
        self.reader = reader
        self.writer = writer
        self.write_deadline_s = write_deadline_s
        self._watch_task: Optional[asyncio.Task] = None

    async def write(self, data: bytes) -> None:
        """Write + drain under the slow-client deadline. On deadline
        the transport is ABORTED (RST, not a lingering FIN) before
        SlowClientError raises, so the stalled peer can never pin
        kernel buffers for a closed stream."""
        self.writer.write(data)
        try:
            await asyncio.wait_for(self.writer.drain(),
                                   self.write_deadline_s)
        except asyncio.TimeoutError:
            self.abort()
            raise SlowClientError(
                f"client failed to drain within "
                f"{self.write_deadline_s:.1f}s") from None

    async def send(self, status: int, ctype: str, body: bytes,
                   extra_headers: Optional[dict] = None) -> None:
        """One complete close-delimited response."""
        text = _STATUS_TEXT.get(status, "")
        head = [f"HTTP/1.0 {status} {text}",
                f"Content-Type: {ctype}",
                f"Content-Length: {len(body)}"]
        for k, v in (extra_headers or {}).items():
            head.append(f"{k}: {v}")
        head.append("Connection: close")
        await self.write("\r\n".join(head).encode("latin-1")
                         + b"\r\n\r\n" + body)

    async def start_sse(self) -> None:
        """Response head for a close-delimited SSE body (no
        Content-Length: the stream length is unknown by design)."""
        await self.write(b"HTTP/1.0 200 OK\r\n"
                         b"Content-Type: text/event-stream\r\n"
                         b"Cache-Control: no-cache\r\n"
                         b"Connection: close\r\n\r\n")

    def watch_disconnect(self, on_gone: Callable[[], None]) -> None:
        """Park a coroutine on the read half: an SSE client sends
        nothing after its request, so ANY read completion (EOF or RST)
        means it hung up — the transport tells us the moment it
        happens, between tokens included. Replaces the old per-stream
        MSG_PEEK poll."""
        async def _watch():
            try:
                while True:
                    data = await self.reader.read(4096)
                    if not data:
                        break
            except (ConnectionError, OSError):
                pass
            on_gone()
        self._watch_task = asyncio.get_running_loop().create_task(_watch())

    def cancel_watch(self) -> None:
        if self._watch_task is not None:
            self._watch_task.cancel()
            self._watch_task = None

    def abort(self) -> None:
        """Hard-drop the transport (no FIN handshake, no draining)."""
        transport = self.writer.transport
        if transport is not None:
            transport.abort()

    async def close(self) -> None:
        self.cancel_watch()
        try:
            if self.writer.can_write_eof():
                self.writer.write_eof()
        except (ConnectionError, OSError, RuntimeError):
            pass
        try:
            self.writer.close()
            await asyncio.wait_for(self.writer.wait_closed(), 5.0)
        except (ConnectionError, OSError, asyncio.TimeoutError):
            pass


def make_server_tls_context(certfile: str, keyfile: str) -> ssl.SSLContext:
    """Server-side TLS for the listening transport (stdlib ssl only)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(certfile, keyfile)
    return ctx


async def read_http_request(reader: asyncio.StreamReader
                            ) -> Optional[AioRequest]:
    """Parse one request off the stream; None on immediate EOF (the
    peer connected and left), ValueError on a malformed request."""
    line = await reader.readline()
    if not line:
        return None
    parts = line.decode("latin-1", "replace").split()
    if len(parts) < 2:
        raise ValueError("malformed request line")
    method, path = parts[0], parts[1]
    headers: Dict[str, str] = {}
    while True:
        raw = await reader.readline()
        if raw in (b"\r\n", b"\n", b""):
            break
        key, _, val = raw.decode("latin-1", "replace").partition(":")
        headers[key.strip().lower()] = val.strip()
    try:
        length = int(headers.get("content-length", "0") or "0")
    except ValueError:
        raise ValueError("malformed Content-Length")
    if not 0 <= length <= _MAX_BODY_BYTES:
        raise ValueError(f"body length {length} out of bounds")
    body = await reader.readexactly(length) if length else b""
    return AioRequest(method, path, headers, body)


# handler signature: receives the parsed request and the connection
Handler = Callable[[AioRequest, AioConnection], Awaitable[None]]


class AsyncHTTPServer:
    """`asyncio.start_server` on a private loop owned by ONE daemon
    acceptor thread. `start()` returns once the port is bound (read it
    back from `.port` — port=0 is ephemeral); `stop()` tears the loop
    down from any thread. `on_open`/`on_close` fire in-loop around
    each connection (the open-connections gauge). `sock_sndbuf` /
    `write_buffer_limit` shrink the server-side buffering so tests can
    trip the slow-client deadline with small streams."""

    def __init__(self, host: str, port: int, handler: Handler,
                 name: str = "ptpu-aio",
                 tls_context: Optional[ssl.SSLContext] = None,
                 on_open: Optional[Callable[[], None]] = None,
                 on_close: Optional[Callable[[], None]] = None,
                 write_deadline_s: float = 30.0,
                 sock_sndbuf: int = 0,
                 write_buffer_limit: int = 0,
                 request_timeout_s: float = _REQUEST_TIMEOUT_S):
        self.host = host
        self.port = port
        self.handler = handler
        self.name = name
        self.tls_context = tls_context
        self.on_open = on_open
        self.on_close = on_close
        self.write_deadline_s = write_deadline_s
        self.sock_sndbuf = sock_sndbuf
        self.write_buffer_limit = write_buffer_limit
        self.request_timeout_s = request_timeout_s
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._thread: Optional[threading.Thread] = None
        self._boot_error: Optional[BaseException] = None

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "AsyncHTTPServer":
        if self._thread is not None:
            return self
        self.loop = asyncio.new_event_loop()
        bound = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(bound,), daemon=True, name=self.name)
        self._thread.start()
        bound.wait(timeout=30)
        if self._boot_error is not None:
            raise self._boot_error
        return self

    def _run(self, bound: threading.Event) -> None:
        loop = self.loop
        asyncio.set_event_loop(loop)
        try:
            server = loop.run_until_complete(asyncio.start_server(
                self._client, self.host, self.port, ssl=self.tls_context))
            self._server = server
            self.port = server.sockets[0].getsockname()[1]
        except OSError as e:
            self._boot_error = e
            bound.set()
            loop.close()
            return
        bound.set()
        try:
            loop.run_forever()
        finally:
            server.close()
            loop.run_until_complete(server.wait_closed())
            pending = [t for t in asyncio.all_tasks(loop) if not t.done()]
            for t in pending:
                t.cancel()
            if pending:
                loop.run_until_complete(asyncio.gather(
                    *pending, return_exceptions=True))
            loop.close()

    def stop(self) -> None:
        """Safe from any thread; idempotent."""
        loop, self.loop = self.loop, None
        thread, self._thread = self._thread, None
        if loop is not None and thread is not None:
            try:
                loop.call_soon_threadsafe(loop.stop)
            except RuntimeError:
                pass
            thread.join(timeout=10)

    def call_soon_threadsafe(self, fn: Callable[[], None]) -> bool:
        """Bridge for non-loop threads (the engine loop's token
        callbacks); False once the loop is gone."""
        loop = self.loop
        if loop is None:
            return False
        try:
            loop.call_soon_threadsafe(fn)
            return True
        except RuntimeError:
            return False

    # -- per-connection ---------------------------------------------------
    async def _client(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        sock = writer.get_extra_info("socket")
        if self.sock_sndbuf and sock is not None:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                            self.sock_sndbuf)
        if self.write_buffer_limit:
            writer.transport.set_write_buffer_limits(
                high=self.write_buffer_limit)
        conn = AioConnection(reader, writer,
                             write_deadline_s=self.write_deadline_s)
        if self.on_open is not None:
            self.on_open()
        try:
            try:
                req = await asyncio.wait_for(read_http_request(reader),
                                             self.request_timeout_s)
            except (ValueError, asyncio.IncompleteReadError,
                    asyncio.TimeoutError):
                await conn.send(400, "application/json",
                                b'{"error": "bad request"}\n')
                return
            if req is None:
                return
            await self.handler(req, conn)
        except SlowClientError:
            pass        # transport already aborted; stream was evicted
        except (ConnectionError, OSError):
            pass        # peer vanished mid-response
        finally:
            await conn.close()
            if self.on_close is not None:
                self.on_close()


async def aiter_sse(reader: asyncio.StreamReader,
                    timeout_s: Optional[float] = None):
    """Async twin of sse.iter_sse: yield each frame's data payload —
    INCLUDING the `[DONE]` sentinel, then stop; EOF mid-frame yields
    the partial frame (the consumer sees the truncation). `timeout_s`
    bounds each line read (asyncio.TimeoutError on a stalled peer —
    the async stand-in for a socket read timeout)."""
    data_lines = []
    while True:
        if timeout_s is not None:
            raw = await asyncio.wait_for(reader.readline(), timeout_s)
        else:
            raw = await reader.readline()
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


async def aio_http_request(host: str, port: int, method: str, path: str,
                           body: Optional[bytes] = None,
                           headers: Optional[dict] = None,
                           connect_timeout_s: float = 5.0
                           ) -> Tuple[int, Dict[str, str],
                                      asyncio.StreamReader,
                                      asyncio.StreamWriter]:
    """Async upstream request (the router's relay half): connect,
    send, parse the status line + headers, hand back the live reader
    so the caller can stream the close-delimited body (aiter_sse for
    SSE, read() for JSON). The caller owns closing the writer."""
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host, port), connect_timeout_s)
    try:
        payload = body or b""
        head = [f"{method} {path} HTTP/1.0",
                f"Host: {host}:{port}",
                f"Content-Length: {len(payload)}"]
        for k, v in (headers or {}).items():
            head.append(f"{k}: {v}")
        head.append("Connection: close")
        writer.write("\r\n".join(head).encode("latin-1")
                     + b"\r\n\r\n" + payload)
        await writer.drain()
        status_line = await asyncio.wait_for(reader.readline(),
                                             connect_timeout_s)
        parts = status_line.decode("latin-1", "replace").split(None, 2)
        if len(parts) < 2 or not parts[1].isdigit():
            raise OSError(f"malformed status line {status_line!r}")
        status = int(parts[1])
        resp_headers: Dict[str, str] = {}
        while True:
            raw = await asyncio.wait_for(reader.readline(),
                                         connect_timeout_s)
            if raw in (b"\r\n", b"\n", b""):
                break
            key, _, val = raw.decode("latin-1", "replace").partition(":")
            resp_headers[key.strip().lower()] = val.strip()
        return status, resp_headers, reader, writer
    except BaseException:
        writer.transport.abort()
        raise


async def aio_read_body(reader: asyncio.StreamReader,
                        headers: Dict[str, str],
                        timeout_s: float = 30.0) -> bytes:
    """Read a non-SSE response body: Content-Length when present,
    close-delimited otherwise."""
    raw_len = headers.get("content-length")
    if raw_len is not None:
        try:
            return await asyncio.wait_for(
                reader.readexactly(int(raw_len)), timeout_s)
        except (ValueError, asyncio.IncompleteReadError):
            return b""
    return await asyncio.wait_for(reader.read(_MAX_BODY_BYTES), timeout_s)


def close_writer_abruptly(writer: asyncio.StreamWriter) -> None:
    """Drop an upstream connection without awaiting the close
    handshake (hedging loser, failover teardown)."""
    try:
        writer.transport.abort()
    except (ConnectionError, OSError, RuntimeError):
        pass


def json_body(obj) -> bytes:
    return json.dumps(obj).encode() + b"\n"
