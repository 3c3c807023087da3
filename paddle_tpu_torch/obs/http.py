"""Stdlib-only HTTP scrape endpoint for the metrics registry (port of
paddle_tpu/obs/http.py).

One small ThreadingHTTPServer (no third-party deps — the container
rule) serving the observability surface every replica exposes:

- `GET /metrics` -> Prometheus text exposition 0.0.4 of the bound
  registry (obs/metrics.py render_prometheus);
- `GET /healthz` -> `ok` — pure LIVENESS: the process is up and can
  answer a socket. Never consults engine state, so a draining or
  still-compiling replica is alive, just not ready;
- `GET /readyz` -> READINESS: 200 only when the bound `readiness`
  callback says so (the serve front-end reports not-ready until the
  engine's one compiled step is warm, and again once a drain begins),
  503 with the reason in the body otherwise. Routers and k8s probes
  gate on THIS one; a replica failing /readyz but passing /healthz is
  cold or draining, not dead;
- any extra mounted route (e.g. `/slo` -> the SLOMonitor verdict JSON,
  obs/slo.py) via `routes={path: callable -> (status, ctype, body)}`;
- parameterised routes (e.g. `/trace/<id>`) via
  `prefix_routes={prefix: callable(path) -> (status, ctype, body)}` —
  exact routes win, then the longest matching prefix gets the FULL
  path so it can parse the tail itself.

`port=0` binds an ephemeral port (read it back from `.port` — what
tests use); the server runs on a daemon thread so it can never hold a
draining process open. A scrape renders under the registry locks
child-by-child, so it is safe concurrent with the serve loop's
recording — that is the point: pull-based exposition without pausing
the engine.

`obs_response()` is the routing logic factored out of the server so
the serve front-end (paddle_tpu/serve/frontend.py in the JAX package),
which multiplexes these paths
with its own /v1/* API on ONE port, answers byte-identically to a
standalone MetricsServer.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from paddle_tpu_torch.obs.metrics import MetricsRegistry, default_registry

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# (status, content-type, body)
Response = Tuple[int, str, bytes]
# readiness callback: (ready, reason) — reason lands in the 503 body
Readiness = Callable[[], Tuple[bool, str]]


def json_route(fn: Callable[[], dict]) -> Callable[[], Response]:
    """Wrap a dict-producing callable (e.g. SLOMonitor.verdict) as a
    mountable JSON route."""
    def route() -> Response:
        return 200, "application/json", (
            json.dumps(fn()) + "\n").encode()
    return route


def obs_response(path: str, registry: MetricsRegistry,
                 readiness: Optional[Readiness] = None,
                 routes: Optional[Dict[str, Callable[[], Response]]] = None,
                 prefix_routes: Optional[
                     Dict[str, Callable[[str], Response]]] = None
                 ) -> Optional[Response]:
    """Answer one observability GET; None when the path is not ours
    (the caller 404s or falls through to its own API)."""
    path = path.split("?")[0]
    if routes and path in routes:
        return routes[path]()
    if prefix_routes:
        for pfx in sorted(prefix_routes, key=len, reverse=True):
            if path.startswith(pfx):
                return prefix_routes[pfx](path)
    if path == "/metrics":
        return 200, CONTENT_TYPE, registry.render_prometheus().encode()
    if path == "/healthz":
        return 200, "text/plain", b"ok\n"
    if path == "/readyz":
        if readiness is None:
            return 200, "text/plain", b"ready\n"
        ready, reason = readiness()
        if ready:
            return 200, "text/plain", b"ready\n"
        return 503, "text/plain", f"not ready: {reason}\n".encode()
    return None


class MetricsServer:
    """`with MetricsServer(registry, port=9090) as srv:` or
    start()/stop(); `srv.url` is the scrape address. `readiness` gates
    /readyz; `routes` mounts extra GET paths (e.g. /slo)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 readiness: Optional[Readiness] = None,
                 routes: Optional[Dict[str, Callable[[], Response]]] = None,
                 prefix_routes: Optional[
                     Dict[str, Callable[[str], Response]]] = None):
        self.registry = registry if registry is not None \
            else default_registry()
        self.host = host
        self.port = port
        self.readiness = readiness
        self.routes = dict(routes or {})
        self.prefix_routes = dict(prefix_routes or {})
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def start(self) -> "MetricsServer":
        if self._server is not None:
            return self
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):                           # noqa: N802 (stdlib)
                resp = obs_response(self.path, outer.registry,
                                    outer.readiness, outer.routes,
                                    outer.prefix_routes)
                if resp is None:
                    resp = (404, "text/plain", b"not found\n")
                status, ctype, body = resp
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):               # silence stderr
                pass

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="ptpu-metrics-http")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False
