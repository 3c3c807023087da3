"""ServeFrontend: the HTTP/SSE serving front-end over ServeEngine (port of
paddle_tpu/serve/frontend.py over the port's engine: the same routes,
frames, metric series and drain contract).

One process, one port, two planes:

- DATA PLANE — `POST /v1/completions`: JSON body in, server-sent
  events out (one frame per sampled token tagged with its candidate
  `index` + in-candidate `pos`, a final done frame with the finish
  reason + best token list, then `[DONE]`). `n` requests parallel
  sampling — the engine forks n candidates off ONE shared prefill
  (COW prompt blocks) and their frames interleave on the same
  response; `best_of >= n` decodes extra silent candidates that only
  compete in the mean-logprob ranking the done frame reports.
  Streaming falls out of the engine's iteration-level scheduling: the
  engine thread runs `step()` continuously and per-token callbacks fan
  tokens out to per-request queues that handler COROUTINES drain. A
  client that disconnects mid-stream cancels its whole group — the
  engine frees every candidate's KV blocks (shared prefix blocks drop
  one refcount each) and the loss shows up as
  `requests{reason="cancelled"}`.
  `POST /v1/tokenize` maps a raw string to the ids the completions
  route would prefill (serve/tokenizer.py) — `"prompt"` accepts either
  form. `GET /kvblocks/<digest>` serves this replica's host-tier
  entries to peers, and the router's `x-ptpu-kv-source` hint makes a
  request PULL its warm prefix from the advertising peer before it is
  enqueued (serve/kvxfer.py — disaggregated prefill/decode serving).
- CONTROL PLANE — the same telemetry the engine records is what
  admits, sheds, and drains: `/metrics` (Prometheus scrape),
  `/healthz` (pure liveness), `/readyz` (503 until the one step
  program has run a step — on the card its CUDA graph is captured when
  the engine is built and replayed from then on — 503 again once a
  drain begins — the router and k8s
  probes stop routing here), `/slo` (the SLOMonitor's machine-readable
  verdict). Admission control rejects with 503 while an SLO objective
  BURNS (obs/slo.py multi-window burn rate over the live TTFT /
  TPOT / queue-wait histograms) or the wait queue is full — every shed
  is a labeled `ptpu_serve_sheds_total{reason=...}` increment, so
  overload is observable from the same scrape that caused it.

INTROSPECTION + POSTMORTEM (OBSERVABILITY.md §introspection). Each
request carries a fleet trace id (the router's `x-ptpu-trace` header,
minted locally when absent) that tags its tracer spans and rides the
done frame back to the client; `/trace/<id>` serves that request's
span fragment for the router's cross-process stitcher. `/debug`
exposes the engine-loop-refreshed scheduler/KV-pool/tier snapshot
(handler threads never touch the engine), and a FlightRecorder
(obs/flightrec.py) keeps the recent serve/resilience event ring,
dumping a postmortem bundle on watchdog stall (`watchdog_s` arms a
RunSupervisor watchdog around engine steps), SLO burn onset, drain
deadline, or an engine-loop crash — `/debug/flightrec` shows the
latest bundle. `/debug/stall/<s>` (armed only with `enable_chaos`)
wedges the next engine step on purpose: the serve_bench fleet-obs
cell uses it to prove a real stall produces a bundle naming the
stuck request.

THREADING. The engine is single-threaded by design (one step program,
host-side allocator bookkeeping). All engine mutation happens on ONE
loop thread. The engine's CUDA graph is captured on the thread that
built the engine and replayed on this loop thread; PyTorch keeps the
current device, the current stream and the grad mode per thread, so the
loop sets the engine's device and runs every step — the pre-step
flushes, the replay and the step's one synchronisation — on that
thread's current stream under `torch.inference_mode()`. The
connection side is an asyncio event loop on ONE acceptor thread
(serve/aio.py): each connection is a coroutine that only enqueues work
(submissions, cancellations) onto thread-safe queues and parks on its
stream's event, woken from the engine thread
via `loop.call_soon_threadsafe`. Thousands of idle SSE streams cost
coroutines, not OS threads — `ptpu_serve_conn_threads` stays flat
while `ptpu_serve_open_connections` climbs. Disconnects come from the
transport (a parked read resolves on peer close); writes are
backpressured per-connection with a slow-client eviction deadline
(`write_deadline_s` → `ptpu_serve_slow_client_evictions_total`), so a
stalled reader frees its KV instead of wedging the fan-out. The
registry and SLO monitor are thread-safe, so scrapes and admission
checks never touch the engine.

FRONT-DOOR SECURITY. `tls_cert`/`tls_key` wrap the listening
transport in stdlib TLS (the url property flips to https), and
`auth_token` requires `Authorization: Bearer <token>` on every route
except `/healthz` (liveness probes stay credential-free) — mismatch
is a 401 before any routing or admission work happens.

PREEMPTIBILITY. SIGTERM (or `begin_drain()`) flips readiness off,
sheds new work with reason="draining", lets every in-flight stream run
to completion bounded by `drain_deadline_s` (stragglers past the
deadline are cancelled and counted in
`ptpu_serve_drain_cancelled_total`), then stops and reports exit code
75 (resilience/errors.py PREEMPT_EXIT_CODE) — same contract as the
training runtime, so a fleet scheduler can tell "drained clean, safe
to reschedule" from "crashed".
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import queue
import signal
import threading
import time
import uuid
from collections import deque
from http.client import HTTPConnection
from typing import Dict, List, Optional, Tuple
from urllib.parse import urlsplit

import torch

from paddle_tpu_torch.engine.engine import ServeEngine
from paddle_tpu_torch.engine.scheduler import Request
from paddle_tpu_torch.obs.flightrec import FlightRecorder
from paddle_tpu_torch.obs.http import json_route, obs_response
from paddle_tpu_torch.obs.slo import SLOMonitor
from paddle_tpu_torch.resilience.errors import PREEMPT_EXIT_CODE
from paddle_tpu_torch.resilience.supervisor import RunSupervisor
from paddle_tpu_torch.serve.aio import AioConnection, AioRequest, \
    AsyncHTTPServer, SlowClientError, make_server_tls_context
from paddle_tpu_torch.serve.kvxfer import KVXferMetrics, encode_tier_blob, \
    pull_prefix
from paddle_tpu_torch.serve.sse import DONE_SENTINEL, sse_event
from paddle_tpu_torch.serve.tokenizer import ByteTokenizer
from paddle_tpu_torch.utils.log import serve_event

_DIR_INTERVAL_S = 0.25   # default /kvprefixes + /debug refresh cadence


class _Stream:
    """Plumbing for one in-flight completion GROUP (1 primary +
    n - 1 forked candidates share one HTTP response): the engine
    thread feeds `q` via `push()`; the handler coroutine drains it.
    Items: ("token", int, cand_index), ("done", reason, tokens, extra)
    where extra is None for n == 1 and {"best_index", "candidates"}
    for a parallel-sampling group, ("error", message).

    The queue stays a thread-safe `queue.Queue` (warmup drains it
    BLOCKING before any event loop exists); `attach()` bridges it to
    the connection coroutine — after that every push also wakes the
    stream's asyncio.Event via `loop.call_soon_threadsafe`, so a
    parked consumer resumes without polling. `gone` is flipped in-loop
    by the transport disconnect watcher."""

    __slots__ = ("params", "q", "req", "streamed", "cand_pos",
                 "loop", "ev", "gone")

    def __init__(self, params: dict):
        self.params = params
        self.q: "queue.Queue" = queue.Queue()
        self.req: Optional[Request] = None
        self.streamed = 0
        self.cand_pos: Dict[int, int] = {}   # candidate -> tokens sent
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self.ev: Optional[asyncio.Event] = None
        self.gone = False

    def attach(self, loop: asyncio.AbstractEventLoop,
               ev: asyncio.Event) -> None:
        """Bind the consumer side; call BEFORE submitting to the
        engine so no push can miss the wake-up."""
        self.ev = ev
        self.loop = loop

    def push(self, item: tuple) -> None:
        """Engine-thread producer: enqueue + wake the parked
        coroutine (a no-op wake before attach/after loop teardown)."""
        self.q.put(item)
        loop, ev = self.loop, self.ev
        if loop is not None and ev is not None:
            try:
                loop.call_soon_threadsafe(ev.set)
            except RuntimeError:
                pass                    # loop already closed (teardown)


class ServeFrontend:
    """`ServeFrontend(engine).start()` binds the port (`.port` after
    start — port=0 is ephemeral), spawns the engine loop, and serves
    until `stop()` / a drain completes. `slo=None` builds a monitor
    with default objectives over the engine's registry."""

    def __init__(self, engine: ServeEngine, host: str = "127.0.0.1",
                 port: int = 0, slo: Optional[SLOMonitor] = None,
                 slo_interval_s: float = 0.25,
                 max_queue_depth: int = 64,
                 drain_deadline_s: float = 30.0,
                 default_max_new_tokens: int = 64,
                 default_deadline_ms: Optional[float] = None,
                 warmup: bool = True,
                 dir_interval_s: float = _DIR_INTERVAL_S,
                 watchdog_s: float = 0.0,
                 flightrec_out: Optional[str] = None,
                 flightrec_capacity: int = 256,
                 enable_chaos: bool = False,
                 router_url: Optional[str] = None,
                 register_interval_s: float = 2.0,
                 tier_spill_interval_s: float = 0.0,
                 phase: str = "mixed",
                 tokenizer_seed: int = 0,
                 tls_cert: Optional[str] = None,
                 tls_key: Optional[str] = None,
                 auth_token: Optional[str] = None,
                 write_deadline_s: float = 30.0,
                 sock_sndbuf: int = 0,
                 write_buffer_limit: int = 0):
        self.engine = engine
        self.host = host
        self.port = port
        # front-door security: TLS on the listening transport + bearer
        # auth (everything except /healthz) — both optional, both
        # enforced before any routing happens
        if bool(tls_cert) != bool(tls_key):
            raise ValueError("tls_cert and tls_key must be set together")
        self.tls_cert = tls_cert
        self.tls_key = tls_key
        self.auth_token = auth_token
        # slow-client eviction: a stream whose peer can't drain a write
        # within this deadline is cancelled (KV freed) and its
        # transport aborted. sock_sndbuf/write_buffer_limit shrink the
        # server-side buffering so tests can trip it with tiny streams.
        self.write_deadline_s = write_deadline_s
        self.sock_sndbuf = sock_sndbuf
        self.write_buffer_limit = write_buffer_limit
        self.obs = engine.obs
        self.slo = slo if slo is not None else SLOMonitor(engine.obs)
        self.slo_interval_s = slo_interval_s
        self.max_queue_depth = max_queue_depth
        self.drain_deadline_s = drain_deadline_s
        self.default_max_new_tokens = default_max_new_tokens
        self.default_deadline_ms = default_deadline_ms
        self.dir_interval_s = dir_interval_s
        self._warmup = warmup
        self._enable_chaos = enable_chaos
        self.exit_code: Optional[int] = None
        # dynamic membership (RESILIENCE.md §fleet): a router url turns
        # on the registration heartbeat — POST /register {"url": ...}
        # every register_interval_s, so the replica joins the fleet
        # without being on the router's argv, and a RESTARTED replica
        # (new process, same port) re-admits itself within one beat.
        self.router_url = router_url.rstrip("/") if router_url else None
        self.register_interval_s = register_interval_s
        # disaggregated serving (serve/kvxfer.py): the phase rides the
        # registration heartbeat and the /kvprefixes advertisement so
        # the router can specialize routing (prefill-heavy traffic to
        # prefill replicas, the decode continuation to decode ones)
        if phase not in ("prefill", "decode", "mixed"):
            raise ValueError(f"phase {phase!r}: want prefill|decode|mixed")
        self.phase = phase
        self._kvx = KVXferMetrics(engine.obs)
        # byte-level front door: string prompts + /v1/tokenize. Needs
        # vocab >= 16; a tiny test vocab just disables string prompts.
        try:
            self.tokenizer: Optional[ByteTokenizer] = ByteTokenizer(
                engine.model.vocab, seed=tokenizer_seed)
        except ValueError:
            self.tokenizer = None
        # warm restarts: > 0 spills the host KV tier to the engine's
        # tier_spill_dir every interval ON TOP of the drain-time spill,
        # so even a SIGKILLed replica warm-starts from a recent
        # snapshot (the spill replaces atomically; a torn write is
        # never visible)
        self.tier_spill_interval_s = tier_spill_interval_s
        self._spill_next = 0.0               # engine-loop thread only
        self._register_thread: Optional[threading.Thread] = None
        self._stop_register = threading.Event()

        self._server: Optional[AsyncHTTPServer] = None
        self._engine_thread: Optional[threading.Thread] = None
        self._work = threading.Event()       # engine loop wake-up
        self._stopped = threading.Event()    # engine loop exited
        self._submit: "deque[_Stream]" = deque()
        self._cancel: "deque[_Stream]" = deque()
        self._lock = threading.Lock()
        self._active: Dict[int, _Stream] = {}    # guarded-by: self._lock
        self._open_streams = 0               # guarded-by: self._lock
        # fleet prefix directory advertisement (/kvprefixes): the
        # engine loop snapshots {len, digest, tier} rows from the
        # prefix index + device int8 compressed pool + host tier
        # (tier in device|device_int8|host, hottest first) every
        # _DIR_INTERVAL_S; handler threads serve the snapshot (never
        # touch the engine)
        self._directory: List[dict] = []     # guarded-by: self._lock
        self._dir_next = 0.0                 # engine-loop thread only
        # /debug snapshot: refreshed on the engine loop at the same
        # cadence as the directory; handler threads serve the copy
        self._debug_snapshot: dict = {}      # guarded-by: self._lock
        self._stall_s = 0.0                  # guarded-by: self._lock
        self._draining = False
        self._drain_started = 0.0
        self._drain_dumped = False           # engine-loop thread only
        self._burn_prev = False              # engine-loop thread only
        self._stop_requested = False
        self._warm = False

        # postmortem plane: the flight recorder taps the process event
        # streams (ring of recent serve/resilience records) and, when
        # watchdog_s > 0, a RunSupervisor watchdog wraps engine steps
        # so a wedged step dumps a bundle while the stall is live
        self.flightrec = FlightRecorder(
            capacity=flightrec_capacity,
            snapshot_fn=self._flight_snapshot,
            out_dir=flightrec_out,
            registry=engine.obs)
        self._sup: Optional[RunSupervisor] = None
        if watchdog_s > 0:
            self._sup = RunSupervisor(
                watchdog_timeout_s=watchdog_s, on_hang=self._on_hang)

        m = self.obs
        self._m_sheds = m.counter(
            "ptpu_serve_sheds_total",
            "Admission rejections (503) by cause",
            labelnames=("reason",))
        self._m_drain_cancelled = m.counter(
            "ptpu_serve_drain_cancelled_total",
            "In-flight streams cancelled at the drain deadline")
        self._m_draining = m.gauge(
            "ptpu_serve_draining", "1 while a drain is in progress")
        self._m_ready = m.gauge(
            "ptpu_serve_ready",
            "1 when /readyz reports ready (warm and not draining)")
        self._m_ready.set(0.0)
        # the asyncio scaling claim, as a gauge pair: connections climb
        # with load, OS threads stay flat (engine loop + acceptor +
        # a constant) — serve_bench's soak cell asserts exactly this
        self._m_open_conns = m.gauge(
            "ptpu_serve_open_connections",
            "Live front-door connections (idle SSE streams park here "
            "as coroutines, not threads)")
        self._m_conn_threads = m.gauge(
            "ptpu_serve_conn_threads",
            "OS threads in the process at the last connection event "
            "(flat vs open_connections under the asyncio front door)")
        self._m_evictions = m.counter(
            "ptpu_serve_slow_client_evictions_total",
            "Streams cancelled at the per-connection write deadline "
            "(stalled readers; their KV blocks are freed)")
        self._m_token_write = m.histogram(
            "ptpu_serve_token_write_seconds",
            "Per-token SSE write+drain latency")

    # -- readiness --------------------------------------------------------
    def readiness(self):
        """The /readyz truth: a replica is routable iff its one step
        program is warm (ptpu_engine_compiles >= 1, which the engine
        publishes after a step has run through the program — explicit
        warmup() or real traffic both warm it) AND it is not
        draining."""
        if not (self._warm or self.engine._m_compiles.value >= 1.0):
            return False, "engine cold (compiled step not warm)"
        if self._draining:
            return False, "draining"
        return True, ""

    def _set_ready_gauge(self) -> None:
        self._m_ready.set(1.0 if self.readiness()[0] else 0.0)

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "ServeFrontend":
        if self._server is not None:
            return self
        # The engine loop must be LIVE before warmup: the engine is
        # single-threaded, so the warmup request has to ride the loop
        # like any other submission (stepping from this thread would
        # race it once real traffic lands) — and the warmup step must
        # replay the program on the thread every later step runs on,
        # the path /readyz vouches for. Starting the loop first makes
        # warmup() take its engine-loop branch instead of the
        # direct-generate fallback.
        self._engine_thread = threading.Thread(
            target=self._engine_loop, daemon=True, name="ptpu-serve-engine")
        self._engine_thread.start()
        if self._warmup:
            self.warmup()
        self.slo.start(self.slo_interval_s)
        self.flightrec.install()
        if self._sup is not None:
            self._sup.start_watchdog()
        tls_ctx = None
        if self.tls_cert and self.tls_key:
            tls_ctx = make_server_tls_context(self.tls_cert, self.tls_key)
        # ONE acceptor thread owns the event loop; every connection is
        # a coroutine (serve/aio.py) — HTTP/1.0 close-delimited, no
        # chunking, byte-compatible with the threaded front it replaces
        self._server = AsyncHTTPServer(
            self.host, self.port, self._a_dispatch,
            name="ptpu-serve-http", tls_context=tls_ctx,
            on_open=self._conn_opened, on_close=self._conn_closed,
            write_deadline_s=self.write_deadline_s,
            sock_sndbuf=self.sock_sndbuf,
            write_buffer_limit=self.write_buffer_limit)
        self._server.start()
        self.port = self._server.port
        serve_event("serve_listening", host=self.host, port=self.port,
                    url=self.url)
        if self.router_url:
            self._register_thread = threading.Thread(
                target=self._register_loop, daemon=True,
                name="ptpu-serve-register")
            self._register_thread.start()
        return self

    def _register_once(self) -> bool:
        """One POST /register heartbeat to the router; False when the
        router is unreachable (normal during rolling restarts — the
        next beat retries)."""
        parts = urlsplit(self.router_url)
        try:
            conn = HTTPConnection(parts.hostname, parts.port or 80,
                                  timeout=5.0)
            try:
                conn.request(
                    "POST", "/register",
                    body=json.dumps({"url": self.url,
                                     "phase": self.phase}).encode(),
                    headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                resp.read()
                return resp.status == 200
            finally:
                conn.close()
        except OSError:
            return False

    def _register_loop(self) -> None:
        registered = False
        while not self._stop_register.is_set():
            ok = self._register_once()
            if ok and not registered:
                serve_event("serve_registered", router=self.router_url,
                            url=self.url)
            registered = ok
            self._stop_register.wait(self.register_interval_s)

    @property
    def url(self) -> str:
        scheme = "https" if self.tls_cert else "http"
        return f"{scheme}://{self.host}:{self.port}"

    def warmup(self) -> None:
        """Run one tiny request through the engine so the step program
        has run a step BEFORE /readyz flips — a router never sees a
        replica whose first real request would be its first step.
        The engine is single-threaded: once the loop thread is live,
        the warmup request must ride it like any other submission
        (stepping from this thread would race the loop)."""
        if self._warm:
            return
        vocab = self.engine.model.vocab
        if self._engine_thread is not None and self._engine_thread.is_alive():
            stream = _Stream({
                "prompt": [vocab - 1] * 2, "max_new_tokens": 2,
                "temperature": 0.0, "top_k": 0, "seed": 0,
                "eos_id": None, "deadline_ms": None})
            self._submit.append(stream)
            self._work.set()
            while True:
                item = stream.q.get(timeout=120)
                if item[0] in ("done", "error"):
                    break
        else:
            self.engine.generate([[vocab - 1] * 2], max_new_tokens=2)
        self.engine.reset_stats()
        # reset_stats zeroes gauges in place; restore the compile gauge
        # from the program cache (one captured CUDA graph on the card,
        # the eager step on the CPU) — the step really is warm, and
        # /readyz gates on exactly this series
        self.engine._m_compiles.set(self.engine.step_graph.compiles)
        self._warm = True
        self._set_ready_gauge()

    def install_signals(self) -> "ServeFrontend":
        """SIGTERM/SIGINT -> drain (main thread only: CLI entry)."""
        def _on_signal(signum, frame):
            serve_event("serve_sigterm", signal=int(signum))
            self.begin_drain()
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, _on_signal)
        return self

    def begin_drain(self) -> None:
        """Stop admitting, finish what's in flight (bounded), exit 75.
        Idempotent; safe from any thread (including a signal
        handler — it only flips flags and an Event)."""
        if self._draining:
            return
        self._draining = True
        self._drain_started = time.monotonic()
        self._m_draining.set(1.0)
        self._set_ready_gauge()
        self._stop_requested = True
        self._work.set()

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        """Block until the engine loop exits (drain complete or
        stop()); returns the exit code (75 for a drain)."""
        self._stopped.wait(timeout)
        return self.exit_code

    def stop(self) -> None:
        """Immediate non-drain shutdown (tests): cancels in-flight work
        and tears the server down without the preempt exit code."""
        self._stop_requested = True
        self._work.set()
        self._stopped.wait(timeout=10)
        self._teardown()

    def _teardown(self) -> None:
        self._stop_register.set()
        if self._register_thread is not None:
            self._register_thread.join(timeout=5)
            self._register_thread = None
        self.slo.stop()
        self.flightrec.uninstall()
        if self._sup is not None:
            self._sup.stop_watchdog()
        if self._server is not None:
            self._server.stop()
            self._server = None

    # -- engine loop ------------------------------------------------------
    def _engine_loop(self) -> None:
        """The engine thread: every step runs here, on the engine's
        device and this thread's current stream (the one the step
        program's replay and synchronisation use), under
        inference_mode — the thread-local state a fresh thread does not
        inherit from the one that built the engine."""
        dev = self.engine.device
        with contextlib.ExitStack() as ctx:
            if dev.type == "cuda":
                ctx.enter_context(torch.cuda.device(dev))
            ctx.enter_context(torch.inference_mode())
            self._serve_loop()

    def _serve_loop(self) -> None:
        eng = self.engine
        try:
            while True:
                self._drain_control_queues()
                progressed = False
                if eng.scheduler.has_work():
                    progressed = self._step_once()
                    self._flush_finished()
                now = time.monotonic()
                if now >= self._dir_next:
                    self._dir_next = now + self.dir_interval_s
                    snapshot = eng.kv_prefix_directory()
                    debug = eng.debug_state()
                    with self._lock:
                        self._directory = snapshot
                        self._debug_snapshot = debug
                    self._check_slo_burn()
                if (self.tier_spill_interval_s > 0
                        and now >= self._spill_next):
                    self._spill_next = now + self.tier_spill_interval_s
                    self._spill_tier("interval")
                if self._draining:
                    if self._drain_finished():
                        break
                elif self._stop_requested:
                    self._abort_active("shutdown")
                    break
                if not progressed:
                    self._work.wait(0.02)
                    self._work.clear()
        except Exception as e:
            # an engine-loop crash is exactly what the flight recorder
            # exists for: freeze the event ring + engine state before
            # the thread dies, then re-raise so the failure stays loud
            self.flightrec.dump("engine_exception", error=repr(e))
            serve_event("serve_engine_crash", error=repr(e))
            raise
        finally:
            # spill the host tier LAST, with no traffic left to mutate
            # it: the successor process warm-starts from exactly the
            # state the drain left behind
            self._spill_tier("drain")
            if self._draining:
                self.exit_code = PREEMPT_EXIT_CODE
                serve_event("serve_drained",
                            drain_s=round(time.monotonic()
                                          - self._drain_started, 3),
                            exit_code=self.exit_code)
            self._stopped.set()

    def _spill_tier(self, cause: str) -> None:
        """Spill the host KV tier to the engine's tier_spill_dir
        (engine-loop thread only — the tier's lock makes the read
        consistent, the rename makes the write atomic). No-op without
        a tier or a dir; a failed spill is an event, never a crash."""
        eng = self.engine
        if eng.host_tier is None or not eng.tier_spill_dir:
            return
        try:
            blocks = eng.host_tier.spill(eng.tier_spill_dir)
        except OSError as e:
            serve_event("tier_spill_failed", cause=cause, error=repr(e))
            return
        if blocks or cause == "drain":
            serve_event("tier_spill", cause=cause, blocks=blocks,
                        dir=eng.tier_spill_dir)

    def _step_once(self) -> bool:
        """One engine step, under the hung-step watchdog when armed.
        An armed chaos stall (POST /debug/stall/<s>) sleeps INSIDE the
        watched window, so the watchdog observes it exactly like a real
        wedged step and fires the postmortem hook mid-stall."""
        with self._lock:
            stall, self._stall_s = self._stall_s, 0.0
        if self._sup is None:
            if stall:
                time.sleep(stall)
            return self.engine.step()
        with self._sup.watch_step(self.engine.steps):
            if stall:
                time.sleep(stall)
            return self.engine.step()

    def _check_slo_burn(self) -> None:
        """Dump one flight-recorder bundle per burn EPISODE (edge
        trigger): the moment an objective starts burning is when the
        ring still holds the traffic that caused it."""
        burning = self.slo.burning_objectives()
        if burning and not self._burn_prev:
            self.flightrec.dump("slo_burn", objectives=burning)
        self._burn_prev = bool(burning)

    def _on_hang(self, step: int, elapsed: float) -> None:
        """RunSupervisor watchdog callback — runs on the WATCHDOG
        thread while the engine thread is wedged; the snapshot is
        best-effort by design (obs/flightrec.py)."""
        self.flightrec.dump("watchdog_hang", step=step,
                            elapsed_s=round(elapsed, 3))

    def _flight_snapshot(self) -> dict:
        state = self.engine.debug_state()
        with self._lock:
            state["open_streams"] = self._open_streams
            state["active_req_ids"] = sorted(self._active)
        state["draining"] = self._draining
        return state

    def _drain_control_queues(self) -> None:
        """Apply handler-thread intents on the engine thread: new
        submissions, then cancellations (a disconnect may target a
        request submitted moments ago)."""
        while self._submit:
            stream = self._submit.popleft()
            p = stream.params
            n_stream = p.get("n", 1)        # candidates the client sees

            def _fork_cb(i, s=stream, n_stream=n_stream):
                # candidates in [n, best_of) decode silently: they only
                # compete in the best-of ranking, never reach the wire
                if i >= n_stream:
                    return None
                return lambda tok, s=s, i=i: s.push(("token", tok, i))

            try:
                req = self.engine.add_request(
                    p["prompt"], max_new_tokens=p["max_new_tokens"],
                    temperature=p["temperature"], top_k=p["top_k"],
                    seed=p["seed"], eos_id=p["eos_id"],
                    deadline_ms=p["deadline_ms"],
                    n=p.get("best_of", 1),
                    fork_callback=_fork_cb,
                    callback=lambda tok, s=stream: s.push(("token", tok, 0)))
                stream.req = req
                self.engine.tracer.set_trace_id(
                    req.req_id, p.get("trace_id"))
                with self._lock:
                    self._active[req.req_id] = stream
            except Exception as e:       # bad prompt: surface as 400
                stream.push(("error", str(e)))
        while self._cancel:
            stream = self._cancel.popleft()
            if stream.req is not None:
                # a disconnect tears down the WHOLE group: every
                # candidate's block refs drop, shared prompt refcounts
                # return to baseline
                self.engine.cancel_group(stream.req)
                with self._lock:
                    self._active.pop(stream.req.req_id, None)

    @staticmethod
    def _group_done(req: Request) -> bool:
        """A stream's done frame goes out when its WHOLE group is
        terminal: the primary plus every fork. Before the fork happens
        (mid-prefill) only a cancellation is terminal — any other
        finish implies the prefill completed, which forks first."""
        if not req.finish_reason:
            return False
        if req.n_candidates == 1:
            return True
        if len(req.forks) < req.n_candidates - 1:
            return req.finish_reason == "cancelled"
        return all(f.finish_reason for f in req.forks)

    @staticmethod
    def _rank_group(req: Request) -> "tuple[int, list]":
        """best-of-n ranking: mean per-token log-probability under each
        candidate's own sampling distribution (sum would just prefer
        short outputs). Ties break to the LOWEST candidate index, so
        n == best_of degenerates deterministically to candidate 0's
        behavior under greedy (all candidates identical)."""
        cands = sorted([req] + req.forks, key=lambda r: r.cand_index)
        infos = [{"index": r.cand_index,
                  "tokens": ServeEngine._generated_of(r),
                  "reason": r.finish_reason,
                  "logprob": round(
                      r.logprob_sum / max(1, len(r.generated)), 6)}
                 for r in cands]
        best = max(infos, key=lambda c: c["logprob"])
        return best["index"], infos

    def _flush_finished(self) -> None:
        """Push done frames for request GROUPS the last step finished
        (for n > 1 the frame waits until every candidate is done)."""
        with self._lock:
            done = [(rid, s) for rid, s in self._active.items()
                    if s.req is not None and self._group_done(s.req)]
            for rid, _ in done:
                del self._active[rid]
        for rid, s in done:
            if s.req.n_candidates == 1:
                s.push(("done", s.req.finish_reason,
                        ServeEngine._generated_of(s.req), None))
            else:
                best_idx, cands = self._rank_group(s.req)
                best = cands[best_idx]
                n_stream = s.params.get("n", 1)
                s.push(("done", best["reason"], best["tokens"],
                        {"best_index": best_idx,
                         # silent best_of-only candidates stay
                         # server-side; the wire sees n candidates
                         "candidates": cands[:n_stream]}))

    def _drain_finished(self) -> bool:
        """True once every in-flight stream completed (or the deadline
        cancelled it) and no handler is still writing."""
        deadline_hit = (time.monotonic() - self._drain_started
                        > self.drain_deadline_s)
        if deadline_hit:
            if not self._drain_dumped:
                # dump BEFORE aborting so the snapshot still names the
                # streams the deadline is about to cancel
                self._drain_dumped = True
                with self._lock:
                    stuck = sorted(self._active)
                self.flightrec.dump("drain_deadline", stuck_req_ids=stuck)
            self._abort_active("drain_deadline", count_drain=True)
        with self._lock:
            # read both under the lock: a handler that already popped its
            # stream from _active but hasn't finished its final write yet
            # is only visible through _open_streams.
            engine_idle = not self._active
            streams_open = self._open_streams > 0
        return (engine_idle and not self.engine.scheduler.has_work()
                and (not streams_open or deadline_hit))

    def _abort_active(self, reason: str, count_drain: bool = False) -> None:
        with self._lock:
            aborted = list(self._active.values())
            self._active.clear()
        for s in aborted:
            if s.req is not None:
                self.engine.cancel_group(s.req)
                if count_drain:
                    self._m_drain_cancelled.inc()
            s.push(("done", "cancelled", [], None))

    def _directory_payload(self) -> dict:
        """The /kvprefixes body: this replica's warm-prefix
        advertisement for the router's fleet prefix directory, plus its
        serving phase (argv-seeded replicas never POST /register, so
        the phase has to ride the scrape). `direct_int8` advertises the
        mixed-step direct-read capability: with it the router prices
        this replica's device_int8 rows like device-fp rows (no promote
        round-trip on a hit); older replicas never send the field and
        keep the old ordering."""
        with self._lock:
            return {"prefixes": list(self._directory),
                    "phase": self.phase,
                    "direct_int8": bool(getattr(self.engine,
                                                "kv_direct_int8", False))}

    def _debug_payload(self) -> dict:
        """The /debug body: the engine-loop-refreshed scheduler/KV
        snapshot plus front-end stream state — everything a handler
        thread can serve without touching the engine."""
        with self._lock:
            return {
                "engine": dict(self._debug_snapshot),
                "open_streams": self._open_streams,
                "active_req_ids": sorted(self._active),
                "draining": self._draining,
                "warm": self._warm,
                "dir_interval_s": self.dir_interval_s,
                "watchdog_s": (self._sup.watchdog_timeout_s
                               if self._sup is not None else 0.0),
            }

    def _kvblocks_route(self, path: str):
        """GET /kvblocks/<digest> -> one host-tier entry in the kvxfer
        wire envelope (serve/kvxfer.py), or 404 when this replica does
        not hold it. Served straight off the handler thread: the tier
        is thread-safe and the engine loop is never involved, so a
        peer's pull can never stall this replica's own decoding."""
        digest = path[len("/kvblocks/"):].strip("/")
        tier = self.engine.host_tier
        blob = (encode_tier_blob(tier, digest)
                if tier is not None and digest else None)
        if blob is None:
            return (404, "application/json",
                    b'{"error": "unknown kv block"}\n')
        return 200, "application/octet-stream", blob

    def _trace_route(self, path: str):
        """GET /trace/<id> -> this replica's span fragment for one
        fleet trace id (404 when the id never landed here — the router
        probes every replica and keeps the ones that answer)."""
        tid = path[len("/trace/"):].strip("/")
        frag = self.engine.tracer.trace_fragment(tid)
        if not tid or frag is None:
            return 404, "application/json", b'{"error": "unknown trace"}\n'
        return (200, "application/json",
                json.dumps(frag).encode() + b"\n")

    def _stall_route(self, path: str):
        """GET /debug/stall/<seconds> (chaos builds only): arm a
        deliberate sleep inside the next WATCHED engine step — the
        fleet-obs bench cell's way of inducing a real stall."""
        if not self._enable_chaos:
            return (403, "application/json",
                    b'{"error": "chaos routes disabled"}\n')
        tail = path[len("/debug/stall"):].strip("/")
        try:
            seconds = float(tail) if tail else 1.0
        except ValueError:
            return 400, "application/json", b'{"error": "bad seconds"}\n'
        seconds = max(0.0, min(seconds, 30.0))
        with self._lock:
            self._stall_s = seconds
        self._work.set()
        return (200, "application/json",
                json.dumps({"stall_s": seconds}).encode() + b"\n")

    # -- connection events (acceptor-loop thread) -------------------------
    def _conn_opened(self) -> None:
        self._m_open_conns.inc()
        self._m_conn_threads.set(float(threading.active_count()))

    def _conn_closed(self) -> None:
        self._m_open_conns.dec()
        self._m_conn_threads.set(float(threading.active_count()))

    # -- HTTP handlers (coroutines on the serve/aio.py loop) --------------
    async def _a_dispatch(self, req: AioRequest,
                          conn: AioConnection) -> None:
        if self.auth_token and req.path.split("?")[0] != "/healthz":
            # /healthz stays credential-free: a liveness probe must
            # never fail for a config (secret-rotation) reason
            if req.header("authorization", "") \
                    != f"Bearer {self.auth_token}":
                await conn.send(401, "application/json",
                                b'{"error": "unauthorized"}\n',
                                {"WWW-Authenticate": "Bearer"})
                return
        if req.method == "GET":
            await self._a_get(req, conn)
        elif req.method == "POST":
            await self._a_post(req, conn)
        else:
            await conn.send(405, "text/plain", b"method not allowed\n")

    async def _a_get(self, req: AioRequest, conn: AioConnection) -> None:
        self._set_ready_gauge()     # traffic may have warmed the engine
        resp = obs_response(
            req.path, self.obs, readiness=self.readiness,
            routes={"/slo": json_route(self.slo.verdict),
                    "/kvprefixes": json_route(self._directory_payload),
                    "/debug": json_route(self._debug_payload),
                    "/debug/flightrec": json_route(
                        self.flightrec.debug_payload)},
            prefix_routes={"/trace/": self._trace_route,
                           "/debug/stall": self._stall_route,
                           "/kvblocks/": self._kvblocks_route})
        if resp is None:
            resp = (404, "text/plain", b"not found\n")
        await conn.send(*resp)

    async def _a_shed(self, conn: AioConnection, reason: str) -> None:
        self._m_sheds.labels(reason=reason).inc()
        serve_event("serve_shed", reason=reason,
                    queue_depth=self.engine.scheduler.queue_depth)
        body = json.dumps({"error": "overloaded", "reason": reason,
                           "retry_after_s": 1.0}).encode() + b"\n"
        await conn.send(503, "application/json", body,
                        {"Retry-After": "1"})

    def _admission_shed_reason(self) -> Optional[str]:
        """Why a new request must bounce, or None to admit. Order
        matters: a draining replica sheds everything; a full queue is
        backpressure regardless of SLO state; then the SLO verdict."""
        if self._draining or self._stop_requested:
            return "draining"
        if self.engine.scheduler.queue_depth >= self.max_queue_depth:
            return "queue_full"
        burning = self.slo.burning_objectives()
        if burning:
            return f"slo_{burning[0]}"
        return None

    def _parse_completion(self, req: AioRequest
                          ) -> Tuple[Optional[dict], Optional[bytes]]:
        """(params, None), or (None, body) for a 400 response."""
        try:
            body = json.loads(req.body or b"{}")
            prompt = body["prompt"]
            if isinstance(prompt, str):
                if self.tokenizer is None:
                    raise ValueError(
                        "string prompts need the byte tokenizer "
                        "(model vocab < 16)")
                prompt = self.tokenizer.encode(prompt)
            elif (not isinstance(prompt, list)
                    or not all(isinstance(t, int) for t in prompt)):
                raise ValueError(
                    "prompt must be a list of token ids or a string")
            n = int(body.get("n", 1))
            best_of = int(body.get("best_of", n))
            if n < 1:
                raise ValueError(f"n {n} < 1")
            if best_of < n:
                raise ValueError(
                    f"best_of {best_of} < n {n}: the ranked pool must "
                    "contain every returned candidate")
            return {
                "prompt": prompt,
                "max_new_tokens": int(body.get(
                    "max_new_tokens", self.default_max_new_tokens)),
                "temperature": float(body.get("temperature", 0.0)),
                "top_k": int(body.get("top_k", 0)),
                "seed": int(body.get("seed", 0)),
                "eos_id": body.get("eos_id"),
                "deadline_ms": body.get("deadline_ms",
                                        self.default_deadline_ms),
                "stream": bool(body.get("stream", True)),
                "n": n,
                "best_of": best_of,
                # fleet trace id: the router propagates its minted id
                # via x-ptpu-trace; a direct client gets one minted
                # here, so every stream is traceable either way
                "trace_id": (req.header("x-ptpu-trace")
                             or uuid.uuid4().hex[:16]),
            }, None
        except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
            return None, json.dumps({"error": str(e)}).encode() + b"\n"

    async def _a_tokenize(self, req: AioRequest,
                          conn: AioConnection) -> None:
        """POST /v1/tokenize: {"text": "..."} (or "prompt") -> the
        token ids /v1/completions would prefill for that string.
        Engine-free — the mapping is pure (vocab, seed)."""
        try:
            body = json.loads(req.body or b"{}")
            text = body.get("text", body.get("prompt"))
            if not isinstance(text, str):
                raise ValueError('want {"text": "<string>"}')
            if self.tokenizer is None:
                raise ValueError(
                    "no tokenizer: model vocab < 16")
            tokens = self.tokenizer.encode(text)
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            await conn.send(400, "application/json",
                            json.dumps({"error": str(e)}).encode() + b"\n")
            return
        payload = {"tokens": tokens, "count": len(tokens),
                   "vocab": self.tokenizer.vocab,
                   "seed": self.tokenizer.seed}
        await conn.send(200, "application/json",
                        json.dumps(payload).encode() + b"\n")

    def _maybe_pull_kv(self, req: AioRequest, prompt: List[int]) -> None:
        """Honor the router's transfer hint (x-ptpu-kv-source): pull
        the warm prefix from the named peer into OUR host tier before
        the request is enqueued, so admission's revival walk finds the
        blocks as if they were local. Blocking HTTP — the async
        handler runs it in the loop's executor; a failed pull just
        means the request re-prefills."""
        source = req.header("x-ptpu-kv-source")
        tier = self.engine.host_tier
        if not source or tier is None or source.rstrip("/") == self.url:
            return
        max_len = None
        raw_len = req.header("x-ptpu-kv-len")
        if raw_len is not None:
            try:
                max_len = int(raw_len)
            except ValueError:
                max_len = None
        pull_prefix(tier, source.rstrip("/"), prompt,
                    self.engine.cache.block_size, metrics=self._kvx,
                    max_len=max_len)

    async def _a_post(self, req: AioRequest, conn: AioConnection) -> None:
        path = req.path.split("?")[0]
        if path == "/v1/tokenize":
            await self._a_tokenize(req, conn)
            return
        if path != "/v1/completions":
            await conn.send(404, "text/plain", b"not found\n")
            return
        params, err = self._parse_completion(req)
        if params is None:
            await conn.send(400, "application/json", err)
            return
        reason = self._admission_shed_reason()
        if reason is not None:
            await self._a_shed(conn, reason)
            return
        if req.header("x-ptpu-kv-source"):
            # blocking peer pull: off the loop, into the executor
            await asyncio.get_running_loop().run_in_executor(
                None, self._maybe_pull_kv, req, params["prompt"])
        stream = _Stream(params)
        # bind the wake-up bridge BEFORE the engine can see the stream
        stream.attach(asyncio.get_running_loop(), asyncio.Event())
        with self._lock:
            self._open_streams += 1
        try:
            self._submit.append(stream)
            self._work.set()
            if params["stream"]:
                await self._a_stream_response(conn, stream)
            else:
                await self._a_aggregate_response(conn, stream)
        finally:
            with self._lock:
                self._open_streams -= 1

    def _stream_timeout(self, params: dict) -> float:
        """Worst-case seconds to wait for the next queue item before
        declaring the engine wedged."""
        if params["deadline_ms"] is not None:
            return max(params["deadline_ms"] / 1e3 * 4, 30.0)
        return 300.0

    @staticmethod
    async def _a_next_item(stream: _Stream,
                           deadline: float) -> Optional[tuple]:
        """Next queue item, or None at the absolute loop-time
        deadline, or ("gone",) when the disconnect watcher fired. The
        clear-check-wait order makes the wake-up race-free: a push
        landing between the empty get and the wait re-sets the event
        AFTER the clear, so the wait returns immediately."""
        loop = asyncio.get_running_loop()
        while True:
            stream.ev.clear()
            try:
                return stream.q.get_nowait()
            except queue.Empty:
                pass
            if stream.gone:
                return ("gone",)
            remaining = deadline - loop.time()
            if remaining <= 0:
                return None
            try:
                await asyncio.wait_for(stream.ev.wait(), remaining)
            except asyncio.TimeoutError:
                pass

    async def _a_stream_response(self, conn: AioConnection,
                                 stream: _Stream) -> None:
        # the transport tells us about a hang-up the moment it
        # happens — an SSE client sends nothing after its request, so
        # a completed read (EOF or RST) means it is gone, even while
        # the stream is parked between tokens
        def _gone() -> None:
            stream.gone = True
            stream.ev.set()
        conn.watch_disconnect(_gone)
        deadline = (asyncio.get_running_loop().time()
                    + self._stream_timeout(stream.params))
        try:
            await conn.start_sse()
            while True:
                item = await self._a_next_item(stream, deadline)
                if item is None or item[0] == "gone":
                    # engine wedged past the deadline, or client left
                    self._request_cancel(stream)
                    return
                if item[0] == "token":
                    _, tok, cand = item
                    pos = stream.cand_pos.get(cand, 0)
                    # `index` tags the CANDIDATE (parallel sampling);
                    # `pos` is the token's position within that
                    # candidate's stream
                    t0 = time.perf_counter()
                    await conn.write(sse_event(
                        {"token": tok, "index": cand, "pos": pos}))
                    self._m_token_write.observe(time.perf_counter() - t0)
                    stream.cand_pos[cand] = pos + 1
                    stream.streamed += 1
                elif item[0] == "done":
                    _, reason, tokens, extra = item
                    frame = {"done": True, "reason": reason,
                             "tokens": tokens,
                             "req_id": stream.req.req_id
                             if stream.req else None,
                             "trace_id": stream.params.get("trace_id")}
                    if extra is not None:
                        frame.update(extra)
                    await conn.write(sse_event(frame)
                                     + sse_event(DONE_SENTINEL))
                    return
                else:                              # ("error", msg)
                    await conn.write(sse_event(
                        {"error": item[1], "done": True,
                         "reason": "error"}) + sse_event(DONE_SENTINEL))
                    return
        except SlowClientError:
            # the peer stopped draining: its transport is already
            # aborted — evict the stream so its KV frees NOW
            self._m_evictions.inc()
            serve_event("serve_slow_client_evicted",
                        req_id=stream.req.req_id if stream.req else None,
                        streamed=stream.streamed,
                        deadline_s=self.write_deadline_s)
            self._request_cancel(stream)
        except (ConnectionError, OSError):
            # client went away mid-stream: free its KV now
            self._request_cancel(stream)
        finally:
            conn.cancel_watch()

    async def _a_aggregate_response(self, conn: AioConnection,
                                    stream: _Stream) -> None:
        tokens: List[int] = []
        timeout = self._stream_timeout(stream.params)
        loop = asyncio.get_running_loop()
        while True:
            item = await self._a_next_item(stream, loop.time() + timeout)
            if item is None:
                self._request_cancel(stream)
                await conn.send(504, "application/json",
                                b'{"error": "timed out"}\n')
                return
            if item[0] == "token":
                if item[2] == 0:        # aggregate body reports best /
                    tokens.append(item[1])   # candidate list, not a mix
            elif item[0] == "done":
                _, reason, full, extra = item
                payload = {
                    "tokens": full or tokens, "reason": reason,
                    "req_id": stream.req.req_id if stream.req else None,
                    "trace_id": stream.params.get("trace_id"),
                }
                if extra is not None:
                    payload.update(extra)
                body = json.dumps(payload).encode() + b"\n"
                await conn.send(200, "application/json", body)
                return
            elif item[0] == "error":
                await conn.send(400, "application/json",
                                json.dumps({"error": item[1]}).encode()
                                + b"\n")
                return

    def _request_cancel(self, stream: _Stream) -> None:
        self._cancel.append(stream)
        self._work.set()
