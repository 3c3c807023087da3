"""Router: one front door over N serve replicas (port of
paddle_tpu/serve/router.py, a copy: standard library only, so a router
of either package fronts replicas of either).

Scale-out story (ROADMAP "serve millions"): each replica is a
ServeFrontend process with its own engine, KV pool and telemetry; the
router is a thin streaming proxy that decides WHICH replica sees a
request and otherwise copies bytes. Three decisions, all driven by the
replicas' own scraped telemetry — the router holds no model state:

- STICKY PREFIX ROUTING. Prefix caching only pays when requests that
  share a prompt prefix land on the SAME replica (each engine's block
  pool is private). The primary replica is a stable hash — crc32, not
  Python's per-process-salted `hash()` — of the first `prefix_len`
  prompt tokens, modulo the READY set: every request with the same
  system prompt hashes to the same replica while the fleet is stable,
  so the fleet-wide hit rate tracks the single-replica hit rate
  instead of decaying ~1/N (serve_bench's router scenario measures
  exactly this). When a replica dies, the hash re-maps over the
  survivors only — no request is sticky to a corpse.
- FLEET PREFIX DIRECTORY. The hash is a degenerate directory (it
  predicts where a prefix SHOULD be warm); the real one is scraped:
  each replica advertises its warm prefixes on /kvprefixes as
  (length, crc32 digest, tier) rows — "device" for prefix-index
  blocks still in the pool, "host" for blocks demoted to the RAM tier
  (engine/kvtier.py). plan_route checks the incoming prompt against
  the directory and prefers the READY replica holding the LONGEST
  matching prefix at the HOTTEST tier (device beats host beats
  nothing), falling back to the hash primary when no replica has it.
  After a restart, rebalance, or failover the directory finds warm KV
  wherever it actually lives instead of where the hash says it should.
  A digest collision can only misroute (the receiving replica
  re-matches on exact tokens before reusing anything) — a perf risk,
  never a correctness one.
- TELEMETRY-RANKED FALLBACK. When the primary is not routable (failed
  /readyz: cold or draining; scrape failure; or it sheds 503), the
  request falls back to the remaining ready replicas ranked by their
  scraped `ptpu_kv_hit_rate` (desc — a warm cache serves a prefix
  cheapest) then `ptpu_sched_queue_depth` (asc — shortest line). The
  scrape loop refreshes each replica's gauges every
  `scrape_interval_s` on a daemon thread.
- DRAIN, SAME CONTRACT AS REPLICAS. SIGTERM stops admission (503
  reason="draining"), lets in-flight proxied streams finish to a
  bounded deadline, and exits PREEMPT_EXIT_CODE (75) — a router is as
  preemptible as the replicas behind it.

FLEET FAULT TOLERANCE (RESILIENCE.md §fleet). The router is where a
replica failure is turned back into a successful client request:

- DYNAMIC MEMBERSHIP. The argv replica list is only the bootstrap
  seed: replicas heartbeat `POST /register {"url": ...}` and are
  admitted once a health probe passes. Every replica carries a
  circuit breaker (closed -> open -> half-open): `breaker_fails`
  consecutive scrape/connect failures open it — the replica is
  evicted from routing — and after `breaker_open_s` ONE half-open
  probe per scrape tick decides rejoin vs re-open. A re-register from
  an evicted replica forces the probe immediately, so a warm restart
  is routable within one scrape interval.
- RETRY BUDGET. Failover re-attempts draw from a RetryBudget token
  bucket (resilience/retry.py) deposited by successful traffic: when
  the whole fleet degrades, the bucket drains and requests shed 503
  reason="retry_budget" instead of amplifying the overload into a
  retry storm.
- HEDGED REQUESTS. A request whose first response byte hasn't arrived
  after ~`hedge_ttft_mult` x the scraped TTFT p95 fires ONE hedge to
  the next-ranked replica; first response wins, the loser's connection
  is closed so its engine cancels and its KV blocks free. Hedges spend
  the same retry budget (no hedge storms either).
- FAILOVER WITH STREAM RESUME. The relay is frame-level (SSE), not
  byte-level: when a replica dies mid-stream the router re-sends the
  request to the next candidate and SKIPS the frames the client
  already has — decode is greedy and every replica holds identical
  weights, so the replayed frames are identical and the client sees
  one untruncated stream ending in `[DONE]`.

DISAGGREGATED SERVING (serve/kvxfer.py). With `kv_transfer` on, a
directory hit on a replica OTHER than the routed target no longer
re-routes the request — the router attaches transfer hints
(`x-ptpu-kv-source`: the advertising replica's url, `x-ptpu-kv-len`:
the matched prefix length) and the target PULLS the warm blocks into
its own host tier before admission. Replicas also advertise a serving
PHASE (`prefill` | `decode` | `mixed`, via /register and /kvprefixes):
when the fleet has a ready replica of the wanted phase, requests are
classified by prompt-vs-decode weight (prompt len >=
`phase_prefill_ratio` x max_new_tokens -> prefill-heavy) and sharded
over the matching replicas first — a prefill replica computes and
demotes the prefix, the decode replica pulls it and streams. A failed
pull costs nothing here: the target just re-prefills.

The relay is unbuffered per frame, so the `[DONE]` untruncated-stream
invariant survives the extra hop, and a client disconnect propagates:
the router's write fails, it drops the replica connection, the
replica's write fails, the engine cancels and frees KV blocks.

FLEET OBSERVABILITY (OBSERVABILITY.md §fleet). The router is also the
fleet's one observability front door:

- every proxied request gets a TRACE ID (minted here, or the client's
  own `x-ptpu-trace` passed through) injected on the replica hop; the
  router records its own route/relay spans under the same id, and
  `GET /trace/<id>` fetches each replica's span fragment and stitches
  router + replica rows into ONE Chrome trace with per-process pids —
  TTFT decomposes hop by hop;
- `GET /metrics/fleet` scrapes every replica's exposition and serves
  the federated merge (obs/fleetmetrics.py): counters sum exactly,
  log-bucketed histograms merge bucket-by-bucket (identical layout by
  construction), gauges re-label per replica;
- `GET /debug` is the replica table as the router sees it — ready
  state, breaker state, scraped gauges, prefix-directory size, and
  scrape staleness (also exported as
  `ptpu_router_scrape_age_seconds{replica}`, so routing-on-stale-data
  is visible on the scrape plane too). Scrapes run on per-replica
  threads with their own `scrape_timeout_s`, so one wedged replica
  cannot stall the loop past its interval — its staleness gauge just
  keeps growing while the rest of the fleet stays fresh.

ASYNC FRONT DOOR (serve/aio.py). The router's connection layer is the
same asyncio server the replicas use: every client stream is a
coroutine on one acceptor-thread event loop, client disconnects come
from the transport (the relay's write fails immediately, not at the
next frame), and client writes are backpressured per-connection with a
slow-client deadline — a stalled reader is aborted instead of pinning
a relay. Upstream replica hops are plain asyncio connections
(aio_http_request); the hedge race that used to burn two threads per
hedged request is two coroutines on the same loop. Blocking sub-paths
(scrape probes on /register, the /metrics/fleet and /trace fan-outs)
run on the default executor — the router's thread count is constant
in the number of attached clients, exactly like the replicas'.

FLEET ADMISSION (opt-in: `fleet_admission`). The scrape loop already
reads each replica's exposition; with admission on it also lifts the
replica's own SLO burn-rate verdicts (`ptpu_slo_burning{objective=…}`
gauges, obs/slo.py) into the routing table. A request whose planned
primary is burning its error budget sheds HERE — 503 + Retry-After at
the router, `ptpu_router_fleet_sheds_total{reason="primary_burn"}` —
before the burning replica spends admission work on it, and is
deliberately NOT spilled onto the healthy remainder (pushing a hot
shard's traffic onto its neighbours is how one burning replica
torches the fleet). When EVERY candidate is burning the request sheds
reason="fleet_burn". Burn state is exported per replica as
`ptpu_router_replica_burning` whether or not admission is enforcing.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import re
import signal
import threading
import time
import uuid
import zlib
from http.client import HTTPConnection
from http.client import responses as _STATUS_TEXT
from typing import Dict, List, Optional, Sequence, Tuple
from urllib.parse import urlsplit

from paddle_tpu_torch.obs.fleetmetrics import federate
from paddle_tpu_torch.obs.http import CONTENT_TYPE, json_route, obs_response
from paddle_tpu_torch.obs.metrics import MetricsRegistry
from paddle_tpu_torch.obs.tracing import RequestTracer, stitch_fragments
from paddle_tpu_torch.resilience.errors import PREEMPT_EXIT_CODE
from paddle_tpu_torch.resilience.retry import RetryBudget
from paddle_tpu_torch.serve.aio import (AioConnection, AioRequest,
                                  AsyncHTTPServer, SlowClientError,
                                  aio_http_request, aio_read_body,
                                  aiter_sse, close_writer_abruptly)
from paddle_tpu_torch.serve.sse import (DONE_SENTINEL, parse_prometheus_values,
                                  sse_event)
from paddle_tpu_torch.utils.log import serve_event


def prefix_shard(prompt: Sequence[int], n: int, prefix_len: int = 32) -> int:
    """Stable shard index for a prompt: crc32 over the first
    `prefix_len` token ids (little-endian u32 each) mod n. Identical
    prefixes -> identical replica, across processes and runs."""
    head = list(prompt[:prefix_len])
    raw = b"".join(int(t & 0xFFFFFFFF).to_bytes(4, "little") for t in head)
    return zlib.crc32(raw) % max(n, 1)


def prefix_digest(tokens: Sequence[int]) -> str:
    """8-hex-digit digest of a token prefix: crc32 over the ids as
    little-endian u32. MUST match engine/kvtier.py's prefix_digest
    (the replica side of the /kvprefixes advertisement) — duplicated
    here so a standalone router never imports the engine stack;
    tests/test_torch_kvtier.py pins the two functions equal, and JAX's."""
    raw = b"".join(int(t & 0xFFFFFFFF).to_bytes(4, "little")
                   for t in tokens)
    return format(zlib.crc32(raw), "08x")


# directory tier ranking: a device-resident fp prefix serves with zero
# copies, a device-int8 one needs only an on-device dequantize promotion
# (no DMA), a host-tier one needs a DMA revival, anything else
# re-prefills. A replica advertising the direct_int8 capability on
# /kvprefixes reads int8 blocks in place — no promote at all — so
# _directory_best re-prices ITS device_int8 rows up to the device rank;
# the table itself keeps the legacy ordering for older replicas.
_TIER_RANK = {"device": 2, "device_int8": 1, "host": 0}

# breaker state as a gauge level (ptpu_router_breaker_state)
_BREAKER_LEVEL = {"closed": 0.0, "half_open": 1.0, "open": 2.0}

# advertised serving phase as a gauge level (ptpu_router_replica_phase)
_PHASE_LEVEL = {"mixed": 0.0, "prefill": 1.0, "decode": 2.0}

_LE_RE = re.compile(r'le="([^"]+)"')

# a replica's own SLO burn verdict in its exposition (obs/slo.py):
# ptpu_slo_burning{objective="queue_wait"} 1.0 while the short window
# burns error budget faster than the alert threshold
_SLO_BURN_RE = re.compile(r'^ptpu_slo_burning\{objective="([^"]+)"\}$')


def _bucket_quantile(vals: dict, family: str, q: float) -> float:
    """histogram_quantile over a flat scrape dict (same walk as
    serve_bench's verdicts): smallest bucket bound covering the q-rank,
    NaN when the family has no samples."""
    per_le: Dict[float, float] = {}
    prefix = family + "_bucket{"
    for key, v in vals.items():
        if not key.startswith(prefix):
            continue
        m = _LE_RE.search(key)
        if not m:
            continue
        le = float("inf") if m.group(1) == "+Inf" else float(m.group(1))
        per_le[le] = per_le.get(le, 0.0) + v
    if not per_le:
        return float("nan")
    bounds = sorted(per_le)
    total = per_le[bounds[-1]]
    if total <= 0:
        return float("nan")
    rank = q * total
    for le in bounds:
        if per_le[le] >= rank:
            return le
    return float("inf")


class ReplicaState:
    """What the scrape loop knows about one replica right now."""

    __slots__ = ("url", "host", "port", "ready", "reason", "hit_rate",
                 "queue_depth", "last_scrape", "prefixes", "fails",
                 "breaker", "open_until", "ttft_p95_ms", "registered",
                 "scraping", "phase", "burning", "direct_int8")

    def __init__(self, url: str):
        parts = urlsplit(url)
        self.url = url.rstrip("/")
        self.host = parts.hostname
        self.port = parts.port or 80
        self.ready = False
        self.reason = "never scraped"
        self.hit_rate = 0.0
        self.queue_depth = 0.0
        self.last_scrape = 0.0
        # fleet prefix directory rows: {(len, digest): tier}
        self.prefixes: Dict[Tuple[int, str], str] = {}
        # circuit breaker: consecutive scrape/connect failures ->
        # closed -> open (evicted) -> half_open (one probe) -> closed
        self.fails = 0
        self.breaker = "closed"
        self.open_until = 0.0
        self.ttft_p95_ms = 0.0
        self.registered = False     # joined via POST /register
        self.scraping = False       # a scrape thread is on it right now
        # disaggregated serving phase (prefill|decode|mixed): from the
        # /register heartbeat or the /kvprefixes advertisement
        self.phase = "mixed"
        # SLO objectives the replica itself reports as burning
        # (ptpu_slo_burning gauges at 1.0) — fleet admission's input
        self.burning: Tuple[str, ...] = ()
        # mixed-step direct-read capability from /kvprefixes: int8
        # prefix rows on this replica serve without a promote
        self.direct_int8 = False


class _RelayState:
    """Per-request relay progress shared across failover attempts:
    whether the client already has status+headers, and how many data
    frames it has received (replayed frames up to `sent` are skipped
    on a resumed stream)."""

    __slots__ = ("started", "sent")

    def __init__(self):
        self.started = False
        self.sent = 0


class _Upstream:
    """One open replica response: parsed status + lower-cased headers
    plus the live reader for the close-delimited body. close() aborts
    the transport (no FIN handshake) — dropping a replica stream this
    way is what makes its engine cancel and free KV blocks."""

    __slots__ = ("status", "headers", "reader", "writer")

    def __init__(self, status: int, headers: Dict[str, str],
                 reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.status = status
        self.headers = headers
        self.reader = reader
        self.writer = writer

    def getheader(self, name: str, default: Optional[str] = None
                  ) -> Optional[str]:
        return self.headers.get(name.lower(), default)

    def close(self) -> None:
        close_writer_abruptly(self.writer)


class Router:
    """`Router(["http://h:p1", "http://h:p2"]).start()` binds `.port`
    and proxies `/v1/completions`; `/metrics`, `/healthz`, `/readyz`
    describe the router itself (ready iff >=1 replica is ready). The
    url list is the bootstrap seed — replicas may also join live via
    `POST /register`."""

    def __init__(self, replica_urls: Sequence[str],
                 host: str = "127.0.0.1", port: int = 0,
                 prefix_len: int = 32,
                 scrape_interval_s: float = 0.5,
                 drain_deadline_s: float = 30.0,
                 connect_timeout_s: float = 10.0,
                 enable_directory: bool = True,
                 scrape_timeout_s: float = 2.0,
                 breaker_fails: int = 3,
                 breaker_open_s: float = 2.0,
                 retry_budget_ratio: float = 0.2,
                 retry_budget_burst: float = 16.0,
                 enable_hedge: bool = True,
                 hedge_ttft_mult: float = 3.0,
                 hedge_min_s: float = 0.05,
                 hedge_max_s: float = 2.0,
                 kv_transfer: bool = False,
                 phase_prefill_ratio: float = 2.0,
                 fleet_admission: bool = False):
        self.replicas = [ReplicaState(u) for u in replica_urls]
        self.host = host
        self.port = port
        self.prefix_len = prefix_len
        # False reverts routing to pure hash stickiness (A/B baseline)
        self.enable_directory = enable_directory
        self.scrape_interval_s = scrape_interval_s
        self.drain_deadline_s = drain_deadline_s
        self.connect_timeout_s = connect_timeout_s
        self.scrape_timeout_s = scrape_timeout_s
        self.breaker_fails = max(1, int(breaker_fails))
        self.breaker_open_s = breaker_open_s
        self.enable_hedge = enable_hedge
        self.hedge_ttft_mult = hedge_ttft_mult
        self.hedge_min_s = hedge_min_s
        self.hedge_max_s = hedge_max_s
        # kv_transfer flips a directory hit from RE-ROUTING (promote
        # the advertising replica) to TRANSFER HINTS (keep the routed
        # target, tell it where to pull the warm blocks from). Opt-in:
        # re-routing is still the right default for a homogeneous
        # fleet with no transfer plane.
        self.kv_transfer = kv_transfer
        # prompt_len >= ratio * max_new_tokens classifies a request as
        # prefill-heavy when phase-specialized replicas exist
        self.phase_prefill_ratio = phase_prefill_ratio
        # opt-in: shed at the router when the planned replica reports
        # ptpu_slo_burning (see the FLEET ADMISSION docstring section)
        self.fleet_admission = fleet_admission
        self.exit_code: Optional[int] = None

        self.obs = MetricsRegistry()    # the router's OWN process story
        self.retry_budget = RetryBudget(ratio=retry_budget_ratio,
                                        burst=retry_budget_burst,
                                        registry=self.obs)
        self._m_routed = self.obs.counter(
            "ptpu_router_requests_total",
            "Requests proxied, by replica and route kind",
            labelnames=("replica", "kind"))  # kind=primary|directory|fallback
        self._m_sheds = self.obs.counter(
            "ptpu_router_sheds_total",
            "Requests the router itself bounced (503)",
            labelnames=("reason",))  # reason=draining|no_replica|retry_budget
        self._m_replica_ready = self.obs.gauge(
            "ptpu_router_replica_ready", "1 when the replica passes /readyz",
            labelnames=("replica",))
        self._m_replica_hit = self.obs.gauge(
            "ptpu_router_replica_hit_rate",
            "Replica's scraped ptpu_kv_hit_rate", labelnames=("replica",))
        self._m_replica_depth = self.obs.gauge(
            "ptpu_router_replica_queue_depth",
            "Replica's scraped ptpu_sched_queue_depth",
            labelnames=("replica",))
        self._m_inflight = self.obs.gauge(
            "ptpu_router_inflight", "Streams currently being proxied")
        self._m_draining = self.obs.gauge(
            "ptpu_router_draining", "1 while the router drains")
        self._m_dir_hits = self.obs.counter(
            "ptpu_router_directory_hits_total",
            "Requests routed to a replica the prefix directory "
            "identified as holding a warm matching prefix")
        self._m_replica_prefixes = self.obs.gauge(
            "ptpu_router_replica_prefixes",
            "Warm prefixes the replica advertises on /kvprefixes",
            labelnames=("replica",))
        self._m_scrape_age = self.obs.gauge(
            "ptpu_router_scrape_age_seconds",
            "Seconds since the replica's gauges were last scraped "
            "successfully (-1 = never); routing decisions are only as "
            "fresh as this", labelnames=("replica",))
        self._m_retries = self.obs.counter(
            "ptpu_router_retries_total",
            "Failover re-attempts, by what failed on the previous try",
            labelnames=("kind",))       # kind=connect|shed|stream
        self._m_hedges = self.obs.counter(
            "ptpu_router_hedges_total",
            "Hedged requests fired against a slow first replica",
            labelnames=("outcome",))    # outcome=won|lost|denied
        self._m_breaker = self.obs.gauge(
            "ptpu_router_breaker_state",
            "Replica circuit breaker: 0 closed, 1 half-open, 2 open "
            "(evicted from routing)", labelnames=("replica",))
        self._m_membership = self.obs.counter(
            "ptpu_router_membership_events_total",
            "Dynamic-membership transitions",
            labelnames=("event",))      # event=register|evict|rejoin
        self._m_replica_ttft = self.obs.gauge(
            "ptpu_router_replica_ttft_p95_ms",
            "Replica's scraped TTFT p95 (bucket upper bound) — the "
            "base of the hedge delay", labelnames=("replica",))
        self._m_kvx_hints = self.obs.counter(
            "ptpu_router_kvxfer_hints_total",
            "Requests served with a KV transfer hint attached (the "
            "target was told to pull the warm prefix from a peer)")
        self._m_phase_routed = self.obs.counter(
            "ptpu_router_phase_routed_total",
            "Requests sharded over phase-matching replicas",
            labelnames=("phase",))      # phase=prefill|decode
        self._m_replica_phase = self.obs.gauge(
            "ptpu_router_replica_phase",
            "Replica's advertised serving phase: 0 mixed, 1 prefill, "
            "2 decode", labelnames=("replica",))
        self._m_replica_burning = self.obs.gauge(
            "ptpu_router_replica_burning",
            "1 when the replica's own exposition reports any "
            "ptpu_slo_burning objective alight", labelnames=("replica",))
        self._m_fleet_sheds = self.obs.counter(
            "ptpu_router_fleet_sheds_total",
            "Requests shed at the router by fleet admission before a "
            "burning replica saw them",
            labelnames=("reason",))     # reason=primary_burn|fleet_burn

        # router-side spans under the fleet trace id: one synthetic
        # request id per proxied POST, stitched with the replica's
        # engine spans by /trace/<id>
        self.tracer = RequestTracer(keep_last=512, process_name="router")
        self._trace_seq = itertools.count(1)

        self._server: Optional[AsyncHTTPServer] = None
        self._scrape_thread: Optional[threading.Thread] = None
        self._stop_scrape = threading.Event()
        # One lock covers the router's mutable shared state: the in-flight
        # count AND every ReplicaState field the scrape loop and handler
        # threads both touch (including membership appends). Network I/O
        # never happens under it.
        self._lock = threading.Lock()
        self._inflight = 0          # guarded-by: self._lock
        self._draining = False      # guarded-by: self._lock
        self._drained = threading.Event()

    # -- membership / circuit breaker -------------------------------------
    def _note_failure(self, r: ReplicaState, reason: str) -> None:
        """One scrape/connect/stream failure on `r`: demote from
        routing and advance the breaker — `breaker_fails` consecutive
        failures open it (eviction), a failed half-open probe re-opens
        it."""
        evicted = False
        with self._lock:
            r.ready = False
            r.reason = reason
            r.fails += 1
            if r.breaker == "closed" and r.fails >= self.breaker_fails:
                r.breaker = "open"
                r.open_until = time.monotonic() + self.breaker_open_s
                evicted = True
            elif r.breaker == "half_open":
                r.breaker = "open"
                r.open_until = time.monotonic() + self.breaker_open_s
            state, fails = r.breaker, r.fails
        self._m_replica_ready.labels(replica=r.url).set(0.0)
        self._m_breaker.labels(replica=r.url).set(_BREAKER_LEVEL[state])
        if evicted:
            self._m_membership.labels(event="evict").inc()
            serve_event("router_evict", replica=r.url, fails=fails,
                        reason=reason)

    def register_replica(self, url: str,
                         phase: Optional[str] = None) -> ReplicaState:
        """Admit (or re-admit) a replica by base url: the programmatic
        half of POST /register. New url -> appended to the table and
        probed; evicted url -> breaker forced half-open and probed NOW,
        so a restarted replica is routable without waiting out
        `breaker_open_s`. `phase` (when the heartbeat carries one)
        updates the replica's advertised serving phase."""
        url = url.rstrip("/")
        with self._lock:
            r = next((x for x in self.replicas if x.url == url), None)
            is_new = r is None
            if is_new:
                r = ReplicaState(url)
                r.registered = True
                self.replicas.append(r)
            elif r.breaker == "open":
                r.breaker = "half_open"
                r.open_until = 0.0
            if phase in _PHASE_LEVEL:
                r.phase = phase
            ready = r.ready
            phase_pub = r.phase
        self._m_replica_phase.labels(replica=r.url).set(
            _PHASE_LEVEL[phase_pub])
        if is_new:
            self._m_membership.labels(event="register").inc()
            serve_event("router_register", replica=url, phase=phase_pub,
                        replicas=len(self.replicas))
        if not ready:
            # probe on the caller's thread (never under the lock): a
            # passing probe flips it ready/rejoined immediately
            self._scrape_once(r)
        return r

    async def _a_register(self, req: AioRequest,
                          conn: AioConnection) -> None:
        try:
            body = json.loads(req.body or b"{}")
            url = str(body.get("url") or "")
            phase = body.get("phase")
        except (ValueError, json.JSONDecodeError):
            url, phase = "", None
        if not url.startswith("http"):
            payload = json.dumps({"ok": False,
                                  "error": "body must be {'url': "
                                           "'http://host:port'}"})
            await conn.send(400, "application/json",
                            payload.encode() + b"\n")
            return
        # register_replica probes the new member over blocking HTTP:
        # off the loop, onto the (bounded) default executor
        r = await asyncio.get_running_loop().run_in_executor(
            None, self.register_replica, url, phase)
        with self._lock:
            known = len(self.replicas)
            ready = r.ready
        await conn.send(200, "application/json", json.dumps(
            {"ok": True, "ready": ready, "replicas": known}).encode()
            + b"\n")

    # -- scrape loop ------------------------------------------------------
    def _scrape_once(self, r: ReplicaState) -> None:
        # HTTP happens into locals; ReplicaState fields are published in
        # one locked write so handler threads (plan_route, _proxy's
        # connect-failure demotion) never see a half-updated replica.
        ready = False
        reason = ""
        vals = {}
        prefixes: Dict[Tuple[int, str], str] = {}
        phase: Optional[str] = None
        direct_int8 = False
        try:
            conn = HTTPConnection(r.host, r.port,
                                  timeout=self.scrape_timeout_s)
            try:
                conn.request("GET", "/readyz")
                resp = conn.getresponse()
                body = resp.read().decode("utf-8", "replace").strip()
                ready = resp.status == 200
                reason = "" if ready else body
                conn.request("GET", "/metrics")
                resp = conn.getresponse()
                text = resp.read().decode("utf-8", "replace")
                # fleet prefix directory: tolerate replicas without the
                # endpoint (404 / bad JSON -> empty advertisement, the
                # scrape itself still counts as healthy)
                conn.request("GET", "/kvprefixes")
                presp = conn.getresponse()
                pbody = presp.read()
                if presp.status == 200:
                    try:
                        payload = json.loads(pbody)
                        # phase rides the same advertisement: argv-
                        # seeded replicas never POST /register
                        if payload.get("phase") in _PHASE_LEVEL:
                            phase = payload["phase"]
                        # capability field (absent on older replicas)
                        direct_int8 = bool(payload.get("direct_int8",
                                                       False))
                        for row in payload.get("prefixes", []):
                            prefixes[(int(row["len"]),
                                      str(row["digest"]))] = \
                                str(row.get("tier", "device"))
                    except (ValueError, KeyError, TypeError):
                        prefixes = {}
                        direct_int8 = False
            finally:
                conn.close()
            vals = parse_prometheus_values(text)
        except OSError as e:
            self._note_failure(r, f"scrape failed: {e}")
            with self._lock:
                last_scrape = r.last_scrape
            age = (time.monotonic() - last_scrape) if last_scrape else -1.0
            self._m_scrape_age.labels(replica=r.url).set(age)
            return
        ttft = _bucket_quantile(vals, "ptpu_serve_ttft_ms", 0.95)
        # the replica's own SLO burn verdicts, straight from its
        # exposition — fleet admission sheds on these (when enabled)
        burning = tuple(sorted(
            m.group(1) for key, val in vals.items()
            for m in (_SLO_BURN_RE.match(key),) if m and val >= 1.0))
        with self._lock:
            rejoined = r.breaker != "closed"
            r.breaker = "closed"
            r.fails = 0
            r.open_until = 0.0
            r.ready = ready
            r.reason = reason
            r.prefixes = prefixes
            r.burning = burning
            r.direct_int8 = direct_int8
            if phase is not None:
                r.phase = phase
            phase_pub = r.phase
            if vals:
                r.hit_rate = vals.get("ptpu_kv_hit_rate", 0.0)
                r.queue_depth = vals.get("ptpu_sched_queue_depth", 0.0)
                if ttft == ttft and ttft != float("inf"):   # not NaN/Inf
                    r.ttft_p95_ms = ttft
                r.last_scrape = time.monotonic()
            hit_rate, queue_depth = r.hit_rate, r.queue_depth
            last_scrape, ttft_pub = r.last_scrape, r.ttft_p95_ms
        if rejoined:
            self._m_membership.labels(event="rejoin").inc()
            serve_event("router_rejoin", replica=r.url, ready=ready)
        self._m_replica_ready.labels(replica=r.url).set(1.0 if ready else 0.0)
        self._m_breaker.labels(replica=r.url).set(0.0)
        self._m_replica_hit.labels(replica=r.url).set(hit_rate)
        self._m_replica_depth.labels(replica=r.url).set(queue_depth)
        self._m_replica_prefixes.labels(replica=r.url).set(
            float(len(prefixes)))
        self._m_replica_ttft.labels(replica=r.url).set(ttft_pub)
        self._m_replica_phase.labels(replica=r.url).set(
            _PHASE_LEVEL[phase_pub])
        self._m_replica_burning.labels(replica=r.url).set(
            1.0 if burning else 0.0)
        # staleness: keeps GROWING while scrapes fail, so alerting can
        # tell "replica down" from "replica briefly slow"
        age = (time.monotonic() - last_scrape) if last_scrape else -1.0
        self._m_scrape_age.labels(replica=r.url).set(age)

    def _scrape_guard(self, r: ReplicaState) -> None:
        try:
            self._scrape_once(r)
        finally:
            with self._lock:
                r.scraping = False

    def scrape_now(self, wait_s: Optional[float] = None) -> None:
        """One pass over every replica, each on its own thread with its
        own `scrape_timeout_s` — a wedged /metrics handler delays ONLY
        its replica (whose in-flight flag also stops pileup across
        ticks); the rest of the fleet stays fresh. Joins up to `wait_s`
        (default: one scrape timeout + slack) so startup and tests see
        a synchronous pass."""
        with self._lock:
            reps = list(self.replicas)
        now = time.monotonic()
        threads: List[threading.Thread] = []
        for r in reps:
            with self._lock:
                if r.scraping:          # previous scrape still stuck on it
                    skip, half_open = True, False
                elif r.breaker == "open" and now < r.open_until:
                    skip, half_open = True, False   # evicted: wait out open_s
                else:
                    skip = False
                    half_open = r.breaker == "open"
                    if half_open:
                        r.breaker = "half_open"     # one probe
                    r.scraping = True
                last_scrape = r.last_scrape
            if skip:
                age = (now - last_scrape) if last_scrape else -1.0
                self._m_scrape_age.labels(replica=r.url).set(age)
                continue
            if half_open:
                self._m_breaker.labels(replica=r.url).set(
                    _BREAKER_LEVEL["half_open"])
            t = threading.Thread(target=self._scrape_guard, args=(r,),
                                 daemon=True, name="ptpu-router-scrape-one")
            t.start()
            threads.append(t)
        deadline = time.monotonic() + (
            wait_s if wait_s is not None else self.scrape_timeout_s + 0.5)
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))

    def _scrape_loop(self) -> None:
        # wait_s=0: the periodic tick never waits on the scrape
        # threads, so the cadence stays `scrape_interval_s` even while
        # one replica's scrape is timing out — a black-holed member
        # must not slow down how fast a DEAD member is detected. The
        # per-replica `scraping` flag stops pileup on the slow one.
        while not self._stop_scrape.wait(self.scrape_interval_s):
            self.scrape_now(wait_s=0.0)

    # -- routing policy ---------------------------------------------------
    def _directory_best(self, prompt: Sequence[int], snapshot: dict
                        ) -> Tuple[Optional[ReplicaState], int]:
        """The ready replica advertising the LONGEST prefix of `prompt`
        at the HOTTEST tier plus that matched length, or (None, 0) when
        the fleet directory has no match. Digests are memoized per
        length: one crc32 per distinct advertised prefix length, not
        per (replica, row). A direct_int8-capable replica's device_int8
        rows rank AT the device rung — its mixed step reads them in
        place, no promote — while replicas without the capability keep
        the legacy device > device_int8 > host ordering."""
        best: Optional[ReplicaState] = None
        best_score = (-1, -1)
        memo: Dict[int, str] = {}
        for r, (ready, _, _, prefixes, _, _, direct) in snapshot.items():
            if not ready:
                continue
            for (ln, dg), tier in prefixes.items():
                rank = (_TIER_RANK["device"]
                        if direct and tier == "device_int8"
                        else _TIER_RANK.get(tier, -1))
                score = (ln, rank)
                if ln > len(prompt) or score <= best_score:
                    continue
                if ln not in memo:
                    memo[ln] = prefix_digest(prompt[:ln])
                if memo[ln] == dg:
                    best, best_score = r, score
        return best, max(0, best_score[0])

    def _classify_phase(self, prompt: Sequence[int],
                        max_new_tokens: Optional[int]) -> str:
        """Which phase specialization serves this request best:
        "prefill" when the prompt dominates the work (prompt len >=
        phase_prefill_ratio x expected decode tokens), else "decode"."""
        max_new = max(1, int(max_new_tokens)
                      if max_new_tokens is not None else 64)
        if len(prompt) >= self.phase_prefill_ratio * max_new:
            return "prefill"
        return "decode"

    def _plan(self, prompt: Sequence[int],
              max_new_tokens: Optional[int] = None
              ) -> Tuple[List[ReplicaState], Optional[ReplicaState],
                         Optional[ReplicaState], int, Optional[str]]:
        """(candidates in try-order, directory pick or None, sticky,
        matched directory prefix length, phase specialization applied
        or None). The hash primary maps over the READY set (in table
        order), so a dead replica's shard re-maps over survivors;
        `sticky` is the hash over the FULL member table — the label
        reference point, so stickiness verdicts don't shift when
        readiness flaps. Ready fallbacks rank best-first (highest
        scraped hit rate, shortest queue); routable-but-not-ready
        replicas trail as a last ditch (the scrape may be stale);
        breaker-open replicas are not tried at all.

        PHASE. When the fleet has a ready replica whose advertised
        phase exactly matches the request's classification, the hash
        shards over the MATCHING set first and the rest of the ready
        fleet trails — a mixed fleet (no specialists) routes exactly as
        before.

        DIRECTORY. When the fleet prefix directory knows a ready
        replica holding a warm prefix of this prompt: without
        kv_transfer that replica is promoted to the front (warm KV
        beats where the hash says the prefix should live); with
        kv_transfer the ORDER STANDS and the caller attaches transfer
        hints instead — the routed target pulls the blocks from
        dir_pick (serve/kvxfer.py)."""
        with self._lock:    # one consistent snapshot to rank against
            stats = {r: (r.ready, r.hit_rate, r.queue_depth,
                         dict(r.prefixes), r.breaker, r.phase,
                         r.direct_int8)
                     for r in self.replicas}
        members = list(stats.keys())
        if not members:
            return [], None, None, 0, None
        sticky = members[prefix_shard(prompt, len(members),
                                      self.prefix_len)]
        routable = [r for r in members if stats[r][4] != "open"]
        ready = [r for r in routable if stats[r][0]]
        want: Optional[str] = None
        if ready:
            pool = ready
            wanted = self._classify_phase(prompt, max_new_tokens)
            matching = [r for r in ready if stats[r][5] == wanted]
            if matching and len(matching) < len(ready):
                # phase specialists exist: shard over them first
                pool = matching
                want = wanted
            primary = pool[prefix_shard(prompt, len(pool),
                                        self.prefix_len)]
            fallbacks = sorted(
                (r for r in pool if r is not primary),
                key=lambda r: (-stats[r][1], stats[r][2]))
            order = [primary] + fallbacks
            order += sorted(
                (r for r in ready if r not in pool),
                key=lambda r: (-stats[r][1], stats[r][2]))
            in_order = set(map(id, order))
            order += [r for r in routable if id(r) not in in_order]
        else:
            # none ready: try the routable set anyway (scrapes may be
            # stale) — but NEVER a breaker-open replica; a fully open
            # fleet sheds until a half-open probe rejoins someone
            order = routable
        dir_pick, dir_len = ((self._directory_best(prompt, stats))
                             if self.enable_directory else (None, 0))
        if (dir_pick is not None and not self.kv_transfer
                and dir_pick is not order[0]):
            if dir_pick in order:
                order.remove(dir_pick)
            order.insert(0, dir_pick)
        return order, dir_pick, sticky, dir_len, want

    def plan_route(self, prompt: Sequence[int]) -> List[ReplicaState]:
        """Candidate replicas in try-order (see _plan)."""
        return self._plan(prompt)[0]

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "Router":
        if self._server is not None:
            return self
        self.scrape_now()
        self._scrape_thread = threading.Thread(
            target=self._scrape_loop, daemon=True, name="ptpu-router-scrape")
        self._scrape_thread.start()
        self._server = AsyncHTTPServer(
            self.host, self.port, self._a_dispatch,
            name="ptpu-router-http").start()
        self.port = self._server.port
        serve_event("router_listening", host=self.host, port=self.port,
                    replicas=[r.url for r in self.replicas])
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def install_signals(self) -> "Router":
        def _on_signal(signum, frame):
            serve_event("router_sigterm", signal=int(signum))
            threading.Thread(target=self.begin_drain, daemon=True).start()
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, _on_signal)
        return self

    def begin_drain(self) -> None:
        """Stop admitting; wait for in-flight proxied streams to finish
        (bounded by drain_deadline_s); record exit code 75."""
        with self._lock:
            if self._draining:
                return
            self._draining = True
        self._m_draining.set(1.0)
        deadline = time.monotonic() + self.drain_deadline_s
        while time.monotonic() < deadline:
            with self._lock:
                if self._inflight == 0:
                    break
            time.sleep(0.05)
        self.exit_code = PREEMPT_EXIT_CODE
        serve_event("router_drained", exit_code=self.exit_code,
                    inflight_at_exit=self._inflight)
        self._drained.set()

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        self._drained.wait(timeout)
        return self.exit_code

    def stop(self) -> None:
        self._stop_scrape.set()
        if self._server is not None:
            server, self._server = self._server, None
            server.stop()
        if self._scrape_thread is not None:
            self._scrape_thread.join(timeout=5)
            self._scrape_thread = None

    # -- HTTP -------------------------------------------------------------
    def readiness(self) -> Tuple[bool, str]:
        with self._lock:
            if self._draining:
                return False, "draining"
            if any(r.ready for r in self.replicas):
                return True, ""
        return False, "no ready replicas"

    def _fetch(self, r: ReplicaState, path: str,
               timeout: Optional[float] = None) -> Optional[str]:
        """GET `path` from a replica, body text on 200 else None. Runs
        on handler threads with NO router lock held (network under the
        lock is forbidden — see self._lock's comment). `timeout`
        defaults to the proxy connect timeout; aggregation routes pass
        `scrape_timeout_s` so one hung replica delays, not stalls,
        the merge."""
        try:
            conn = HTTPConnection(
                r.host, r.port,
                timeout=self.connect_timeout_s if timeout is None
                else timeout)
            try:
                conn.request("GET", path)
                resp = conn.getresponse()
                body = resp.read()
                if resp.status != 200:
                    return None
                return body.decode("utf-8", "replace")
            finally:
                conn.close()
        except OSError:
            return None

    def _fleet_route(self):
        """/metrics/fleet: scrape every replica NOW and serve the
        federated exposition. Unreachable replicas are simply absent
        from the merge (their staleness still shows on the router's
        own ptpu_router_scrape_age_seconds)."""
        expositions: Dict[str, str] = {}
        for r in self.replicas:
            text = self._fetch(r, "/metrics", timeout=self.scrape_timeout_s)
            if text is not None:
                expositions[r.url] = text
        return 200, CONTENT_TYPE, federate(expositions).encode()

    def _trace_route(self, path: str):
        """/trace/<id>: merge the router's own span fragment for the
        trace id with every replica's into one Chrome trace — each
        process gets its own pid row, timestamps are epoch-anchored
        (now_us) so no shifting is needed."""
        tid = path[len("/trace/"):].strip("/")
        fragments: List[Tuple[str, dict]] = []
        own = self.tracer.trace_fragment(tid) if tid else None
        if own is not None:
            fragments.append(("router", own))
        for r in self.replicas:
            text = (self._fetch(r, "/trace/" + tid,
                                timeout=self.scrape_timeout_s)
                    if tid else None)
            if text is None:
                continue
            try:
                frag = json.loads(text)
            except ValueError:
                continue
            fragments.append((f"replica {r.url}", frag))
        if not fragments:
            return (404, "application/json",
                    json.dumps({"error": "unknown trace",
                                "trace_id": tid}).encode() + b"\n")
        merged = stitch_fragments(fragments, trace_id=tid)
        return (200, "application/json",
                json.dumps(merged).encode() + b"\n")

    def _debug_payload(self) -> dict:
        """/debug: the replica table as routing sees it right now."""
        now = time.monotonic()
        with self._lock:
            replicas = [{
                "url": r.url,
                "ready": r.ready,
                "reason": r.reason,
                "hit_rate": r.hit_rate,
                "queue_depth": r.queue_depth,
                "scrape_age_s": (round(now - r.last_scrape, 3)
                                 if r.last_scrape else None),
                "prefixes": len(r.prefixes),
                "breaker": r.breaker,
                "fails": r.fails,
                "registered": r.registered,
                "ttft_p95_ms": r.ttft_p95_ms,
                "phase": r.phase,
                "burning": list(r.burning),
            } for r in self.replicas]
            inflight = self._inflight
            draining = self._draining
        return {"replicas": replicas, "inflight": inflight,
                "draining": draining,
                "scrape_interval_s": self.scrape_interval_s,
                "directory_enabled": self.enable_directory,
                "retry_budget_tokens": self.retry_budget.tokens(),
                "hedge_enabled": self.enable_hedge,
                "kv_transfer": self.kv_transfer,
                "fleet_admission": self.fleet_admission}

    def _get_response(self, path: str) -> Tuple[int, str, bytes]:
        """Resolve a GET path to (status, ctype, body). Runs on an
        executor thread: /metrics/fleet and /trace/<id> fan blocking
        GETs over the whole fleet and must never park the loop."""
        resp = obs_response(
            path, self.obs, readiness=self.readiness,
            routes={"/metrics/fleet": self._fleet_route,
                    "/debug": json_route(self._debug_payload)},
            prefix_routes={"/trace/": self._trace_route})
        if resp is None:
            resp = (404, "text/plain", b"not found\n")
        return resp

    async def _a_get(self, req: AioRequest, conn: AioConnection) -> None:
        resp = await asyncio.get_running_loop().run_in_executor(
            None, self._get_response, req.path)
        await conn.send(*resp)

    async def _a_shed(self, conn: AioConnection, reason: str) -> None:
        self._m_sheds.labels(reason=reason).inc()
        body = json.dumps({"error": "overloaded", "reason": reason,
                           "retry_after_s": 1.0}).encode() + b"\n"
        try:
            await conn.send(503, "application/json", body,
                            {"Retry-After": "1"})
        except (SlowClientError, ConnectionError, OSError):
            pass

    async def _a_fleet_shed(self, conn: AioConnection,
                            reason: str) -> None:
        """Fleet admission's bounce: same 503 + Retry-After contract
        as _a_shed but counted on its own series — "the fleet is
        protecting itself" is a different signal from "the router has
        nowhere to route"."""
        self._m_fleet_sheds.labels(reason=reason).inc()
        serve_event("router_fleet_shed", reason=reason)
        body = json.dumps({"error": "overloaded", "reason": reason,
                           "retry_after_s": 1.0}).encode() + b"\n"
        try:
            await conn.send(503, "application/json", body,
                            {"Retry-After": "1"})
        except (SlowClientError, ConnectionError, OSError):
            pass

    def _fleet_admission_reason(
            self, candidates: List[ReplicaState]) -> Optional[str]:
        """None admits. "primary_burn" when the planned primary's own
        SLO monitor says it is burning error budget — the request is
        shed, deliberately NOT spilled onto the healthy remainder
        (pushing a hot shard's traffic onto its neighbours is how one
        burning replica torches the fleet). "fleet_burn" when every
        candidate is burning."""
        if not self.fleet_admission or not candidates:
            return None
        with self._lock:
            burning = [bool(r.burning) for r in candidates]
        if all(burning):
            return "fleet_burn"
        if burning[0]:
            return "primary_burn"
        return None

    async def _a_dispatch(self, req: AioRequest,
                          conn: AioConnection) -> None:
        if req.method == "GET":
            await self._a_get(req, conn)
        elif req.method == "POST":
            await self._a_post(req, conn)
        else:
            await conn.send(405, "text/plain", b"method not allowed\n")

    async def _a_post(self, req: AioRequest, conn: AioConnection) -> None:
        path = req.path.split("?")[0]
        if path == "/register":
            await self._a_register(req, conn)
            return
        if path != "/v1/completions":
            await self._a_get(req, conn)    # reuse the 404 path
            return
        if self._draining:
            await self._a_shed(conn, "draining")
            return
        max_new: Optional[int] = None
        raw = req.body or b"{}"
        try:
            body = json.loads(raw or b"{}")
            prompt = body.get("prompt") or []
            if isinstance(prompt, str):
                # string prompts tokenize REPLICA-side; route on the
                # utf-8 bytes — stable across processes, and identical
                # strings still shard sticky (the directory simply
                # won't match until token-level requests warmed it)
                prompt = list(prompt.encode("utf-8"))
            mn = body.get("max_new_tokens")
            if mn is not None:
                max_new = int(mn)
        except (ValueError, TypeError, json.JSONDecodeError):
            raw, prompt = b"{}", []
        # fleet trace id: honor the client's, else mint one; the same
        # id tags the router's route/relay spans AND rides the replica
        # hop as x-ptpu-trace, so /trace/<id> can stitch both processes
        tid = req.header("x-ptpu-trace") or uuid.uuid4().hex[:16]
        rid = next(self._trace_seq)
        self.tracer.set_trace_id(rid, tid)
        self.tracer.span_begin(rid, "route")
        candidates, dir_pick, sticky, dir_len, want = self._plan(
            prompt, max_new)
        if not candidates:
            self.tracer.on_finish(rid, "shed")
            await self._a_shed(conn, "no_replica")
            return
        fleet_reason = self._fleet_admission_reason(candidates)
        if fleet_reason is not None:
            self.tracer.on_finish(rid, "shed")
            await self._a_fleet_shed(conn, fleet_reason)
            return
        if want is not None:
            self._m_phase_routed.labels(phase=want).inc()
        self._track_inflight(+1)
        try:
            await self._a_proxy(conn, raw, prompt, candidates, dir_pick,
                                sticky, dir_len=dir_len, tid=tid, rid=rid)
        finally:
            self._track_inflight(-1)

    def _track_inflight(self, delta: int) -> None:
        """Count and gauge move together under the lock: the old code
        re-read `self._inflight` outside it, so two crossing requests
        could publish stale values out of order and leave the gauge
        permanently off. The gauge's own child lock is leaf-level (it
        never takes router locks), so nesting it here cannot deadlock."""
        with self._lock:
            self._inflight += delta
            self._m_inflight.set(float(self._inflight))

    # -- proxy data path --------------------------------------------------
    async def _a_connect_stream(self, r: ReplicaState, raw: bytes,
                                headers: dict):
        """POST the completion to one replica.
        ("ok", _Upstream) | ("shed", body) | ("error",)."""
        try:
            status, rheaders, reader, writer = await aio_http_request(
                r.host, r.port, "POST", "/v1/completions", body=raw,
                headers=headers, connect_timeout_s=self.connect_timeout_s)
        except (OSError, asyncio.TimeoutError) as e:
            self._note_failure(r, f"connect failed: {e}")
            return ("error",)
        up = _Upstream(status, rheaders, reader, writer)
        if status == 503:           # replica shed: caller tries the next
            try:
                body = await aio_read_body(
                    reader, rheaders, timeout_s=self.connect_timeout_s)
            except asyncio.TimeoutError:
                body = b""
            up.close()
            return ("shed", body)
        return ("ok", up)

    def _hedge_delay_s(self, r: ReplicaState) -> float:
        """How long to give `r`'s first response byte before hedging:
        hedge_ttft_mult x its scraped TTFT p95 (fleet max when `r` has
        no samples yet), clamped to [hedge_min_s, hedge_max_s]. An
        unmeasured fleet waits the full hedge_max_s — no speculative
        traffic before there is evidence of what slow means."""
        with self._lock:
            p95 = r.ttft_p95_ms or max(
                (x.ttft_p95_ms for x in self.replicas if x.ready),
                default=0.0)
        if p95 <= 0:
            return self.hedge_max_s
        return min(max(self.hedge_ttft_mult * p95 / 1000.0,
                       self.hedge_min_s), self.hedge_max_s)

    async def _a_open_stream(self, r: ReplicaState, raw: bytes,
                             headers: dict,
                             hedge_pool: Optional[List[ReplicaState]],
                             rid: Optional[int]):
        """Open the stream on `r`; with a non-empty `hedge_pool`, race
        ONE hedge to its head after the TTFT-derived delay — first
        response wins, the loser's connection is aborted (the engine
        behind it cancels and frees KV). The hedge spends a retry-
        budget token when it fires; an empty bucket silently skips it.
        The race that used to burn two threads per hedged request is
        two coroutines on the serving loop.
        Returns ("ok", replica, _Upstream) | ("shed", body) |
        ("error",)."""
        if not hedge_pool:
            res = await self._a_connect_stream(r, raw, headers)
            return res if res[0] != "ok" else ("ok", r, res[1])
        delay = self._hedge_delay_s(r)
        decided = asyncio.Event()
        fired = False
        hedge_target = hedge_pool[0]

        async def attempt(rep: ReplicaState, tag: str, wait_s: float):
            nonlocal fired
            if wait_s > 0.0:
                try:
                    await asyncio.wait_for(decided.wait(), wait_s)
                    return (tag, rep, None)     # first answered in time
                except asyncio.TimeoutError:
                    pass
            if tag == "hedge":
                if not self.retry_budget.try_spend("router_hedge"):
                    self._m_hedges.labels(outcome="denied").inc()
                    return (tag, rep, ("error",))
                fired = True
                if rid is not None:
                    self.tracer.mark(rid, "hedge_fired", replica=rep.url)
            return (tag, rep,
                    await self._a_connect_stream(rep, raw, headers))

        loop = asyncio.get_running_loop()
        tasks = {loop.create_task(attempt(r, "first", 0.0)),
                 loop.create_task(attempt(hedge_target, "hedge", delay))}
        chosen = None
        first_failure = None
        endline = loop.time() + self.connect_timeout_s + delay + 1.0
        while tasks and chosen is None:
            timeout = endline - loop.time()
            if timeout <= 0:
                break
            done, tasks = await asyncio.wait(
                tasks, timeout=timeout,
                return_when=asyncio.FIRST_COMPLETED)
            for t in done:
                tag, rep, res = t.result()
                if res is None:
                    continue            # hedge stood down: first decided
                if res[0] == "ok":
                    if chosen is None:
                        chosen = (tag, rep, res)
                    else:               # both landed: drop the loser
                        res[1].close()
                elif tag == "first":
                    first_failure = res
                    if not fired:
                        # the primary failed before any hedge went out:
                        # stand the hedge down and fail over normally
                        decided.set()
                        await asyncio.gather(*tasks,
                                             return_exceptions=True)
                        return first_failure
                # a failed hedge: keep waiting for the primary
        decided.set()
        if chosen is None:
            for t in tasks:
                t.cancel()
            return first_failure if first_failure is not None else ("error",)
        tag, rep, res = chosen
        if tag == "hedge":
            self._m_hedges.labels(outcome="won").inc()
        elif fired:
            self._m_hedges.labels(outcome="lost").inc()
        if tasks:
            # the loser is still connecting: reap its socket when it
            # resolves so the engine behind it cancels
            async def _reap(pending):
                done, late = await asyncio.wait(
                    pending, timeout=self.connect_timeout_s + 5.0)
                for t in late:
                    t.cancel()
                for t in done:
                    _, _, lres = t.result()
                    if lres is not None and lres[0] == "ok":
                        lres[1].close()
            loop.create_task(_reap(set(tasks)))
        return ("ok", rep, res[1])

    @staticmethod
    async def _a_client_write(conn: AioConnection, data: bytes) -> bool:
        """True when the client took the bytes; False when it hung up
        or stalled past the write deadline (its transport is already
        aborted by then)."""
        try:
            await conn.write(data)
            return True
        except (SlowClientError, ConnectionError, OSError):
            return False

    async def _a_relay_sse(self, conn: AioConnection, up: _Upstream,
                           state: _RelayState) -> str:
        """Frame-level relay: forward SSE frames as they arrive,
        skipping the first `state.sent` data frames (a resumed stream
        replays from the start — greedy decode on identical weights
        makes the replay identical). Returns "done" ([DONE] relayed /
        non-stream response fully copied), "client_gone" (our write
        failed or the client stalled past the write deadline), or
        "truncated" (upstream died first — the caller fails over)."""
        ctype = up.getheader("content-type", "") or ""
        if up.status != 200 or "text/event-stream" not in ctype:
            if state.started:
                return "truncated"  # can't splice a non-stream mid-stream
            await self._a_relay(conn, up)
            return "done"
        if not state.started:
            head = ("HTTP/1.0 200 OK\r\n"
                    f"Content-Type: {ctype}\r\n"
                    "Connection: close\r\n\r\n").encode("latin-1")
            if not await self._a_client_write(conn, head):
                return "client_gone"
            state.started = True
        n = 0
        try:
            async for payload in aiter_sse(
                    up.reader, timeout_s=self.connect_timeout_s):
                if payload == DONE_SENTINEL:
                    if not await self._a_client_write(
                            conn, sse_event(payload)):
                        return "client_gone"
                    return "done"
                n += 1
                if n <= state.sent:
                    continue        # the client already has this frame
                if not await self._a_client_write(
                        conn, sse_event(payload)):
                    return "client_gone"
                state.sent = n
        except (OSError, asyncio.TimeoutError):
            pass                    # reset / stall from upstream
        return "truncated"          # EOF without [DONE]

    async def _a_proxy(self, conn: AioConnection, raw: bytes,
                       prompt: Sequence[int],
                       candidates: List[ReplicaState],
                       dir_pick: Optional[ReplicaState] = None,
                       sticky: Optional[ReplicaState] = None, *,
                       dir_len: int = 0,
                       tid: Optional[str] = None,
                       rid: Optional[int] = None) -> None:
        """Drive one request to a `[DONE]`-terminated stream across as
        many replicas as the retry budget allows: connect failures and
        replica 503s fail over BEFORE the first byte; a mid-stream
        death fails over WITH RESUME (state.sent frames are skipped on
        the replay); the first attempt may hedge. Every re-attempt
        after the first costs a budget token — an empty bucket sheds
        503 reason="retry_budget" rather than storming a degraded
        fleet. The served replica's route kind: "primary" when it is
        the full-table hash pick (the directory agreeing with the hash
        stays "primary" so stickiness verdicts survive), "directory"
        when the fleet prefix directory OVERRODE the hash, "fallback"
        otherwise."""
        headers = {"Content-Type": "application/json"}
        if tid:
            headers["x-ptpu-trace"] = tid
        state = _RelayState()
        pending = list(candidates)
        last_shed: Optional[bytes] = None
        attempt = 0
        retry_kind = "connect"
        while pending:
            r = pending.pop(0)
            attempt += 1
            if attempt > 1:
                if not self.retry_budget.try_spend("router"):
                    if rid is not None:
                        self.tracer.on_finish(rid, "budget_exhausted")
                    if not state.started:
                        await self._a_shed(conn, "retry_budget")
                    return
                self._m_retries.labels(kind=retry_kind).inc()
                if rid is not None:
                    self.tracer.mark(rid, "failover", replica=r.url,
                                     kind=retry_kind)
            hedge_pool = (pending if attempt == 1 and self.enable_hedge
                          and pending and not state.started else None)
            # kv_transfer: when the warm prefix lives on a replica we
            # are NOT about to try, tell this attempt's target where to
            # pull it from (per-attempt copy: a later attempt may BE
            # dir_pick and must not be told to pull from itself)
            hinted = (self.kv_transfer and dir_pick is not None
                      and dir_len > 0 and r is not dir_pick)
            attempt_headers = headers
            if hinted:
                attempt_headers = dict(headers)
                attempt_headers["x-ptpu-kv-source"] = dir_pick.url
                attempt_headers["x-ptpu-kv-len"] = str(dir_len)
            res = await self._a_open_stream(r, raw, attempt_headers,
                                            hedge_pool, rid)
            if res[0] == "shed":
                last_shed = res[1]
                retry_kind = "shed"
                if rid is not None:
                    self.tracer.mark(rid, "replica_shed", replica=r.url)
                continue
            if res[0] == "error":
                retry_kind = "connect"
                if rid is not None:
                    self.tracer.mark(rid, "connect_failed", replica=r.url)
                continue
            _, r_used, up = res
            if r_used is not r:
                # the hedge won: it came out of pending; the slow
                # primary goes to the back as a last-resort retry
                if r_used in pending:
                    pending.remove(r_used)
                pending.append(r)
            if r_used is sticky:
                kind = "primary"
            elif dir_pick is not None and r_used is dir_pick:
                kind = "directory"
            else:
                kind = "fallback"
            if dir_pick is not None and r_used is dir_pick:
                self._m_dir_hits.inc()
            if hinted and r_used is not dir_pick:
                # the served replica was told where to pull warm KV —
                # the directory paid off WITHOUT re-routing
                self._m_dir_hits.inc()
                self._m_kvx_hints.inc()
            self._m_routed.labels(replica=r_used.url, kind=kind).inc()
            if rid is not None:
                self.tracer.mark(rid, "routed", replica=r_used.url,
                                 kind=kind)
                self.tracer.span_begin(rid, "relay")
            outcome = await self._a_relay_sse(conn, up, state)
            up.close()
            if outcome == "done":
                if rid is not None:
                    self.tracer.on_finish(rid, "relayed")
                return
            if outcome == "client_gone":
                if rid is not None:
                    self.tracer.on_finish(rid, "client_gone")
                return
            # upstream died mid-stream: breaker takes note, the next
            # candidate resumes past the frames the client already has
            self._note_failure(r_used, "stream truncated")
            retry_kind = "stream"
            if rid is not None:
                self.tracer.mark(rid, "stream_truncated",
                                 replica=r_used.url, frames=state.sent)
        if rid is not None:
            self.tracer.on_finish(rid, "shed")
        if state.started:
            return      # partial stream, nothing left to resume from
        if last_shed is not None:       # every replica shed: relay it
            try:
                await conn.send(503, "application/json", last_shed)
            except (SlowClientError, ConnectionError, OSError):
                pass
            return
        await self._a_shed(conn, "no_replica")

    async def _a_relay(self, conn: AioConnection, up: _Upstream) -> None:
        """Copy status + content-type + body bytes to the client,
        unbuffered per read so bytes stream as they arrive. A client
        write failure aborts the replica connection (via the caller's
        up.close()), which cancels the request engine-side. The
        non-SSE path (errors, future non-stream responses); SSE goes
        through _a_relay_sse for failover-with-resume."""
        ctype = up.getheader("content-type", "application/octet-stream")
        head = (f"HTTP/1.0 {up.status} {_STATUS_TEXT.get(up.status, '')}"
                f"\r\nContent-Type: {ctype}\r\n"
                "Connection: close\r\n\r\n").encode("latin-1")
        if not await self._a_client_write(conn, head):
            return
        try:
            while True:
                chunk = await asyncio.wait_for(
                    up.reader.read(8192), self.connect_timeout_s)
                if not chunk:
                    break
                if not await self._a_client_write(conn, chunk):
                    return
        except (OSError, asyncio.TimeoutError):
            pass


def main(argv: Optional[List[str]] = None) -> int:
    """`python -m paddle_tpu_torch.serve.router --replica URL --replica URL`
    (or no --replica at all: replicas join via POST /register)"""
    import argparse

    p = argparse.ArgumentParser(description="ptpu serve router")
    p.add_argument("--replica", action="append", default=[],
                   help="replica base url (repeatable; optional — "
                        "replicas can also POST /register themselves)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--prefix-len", type=int, default=32)
    p.add_argument("--scrape-interval-s", type=float, default=0.5)
    p.add_argument("--scrape-timeout-s", type=float, default=2.0,
                   help="per-replica scrape socket timeout: a wedged "
                        "replica delays only itself, never the loop")
    p.add_argument("--drain-deadline-s", type=float, default=30.0)
    p.add_argument("--no-prefix-directory", action="store_true",
                   help="route on hash stickiness only; ignore the "
                        "scraped /kvprefixes fleet directory")
    p.add_argument("--breaker-fails", type=int, default=3,
                   help="consecutive scrape/connect failures that open "
                        "a replica's circuit breaker (evict)")
    p.add_argument("--breaker-open-s", type=float, default=2.0,
                   help="how long an open breaker waits before its "
                        "half-open probe")
    p.add_argument("--retry-budget-ratio", type=float, default=0.2,
                   help="retry tokens deposited per successful request")
    p.add_argument("--retry-budget-burst", type=float, default=16.0,
                   help="retry-budget bucket size (cold-start allowance)")
    p.add_argument("--no-hedge", action="store_true",
                   help="disable hedged requests")
    p.add_argument("--hedge-ttft-mult", type=float, default=3.0,
                   help="hedge after this multiple of the scraped "
                        "TTFT p95")
    p.add_argument("--hedge-min-s", type=float, default=0.05)
    p.add_argument("--hedge-max-s", type=float, default=2.0)
    p.add_argument("--kv-transfer", action="store_true",
                   help="attach KV transfer hints on directory hits "
                        "instead of re-routing (disaggregated serving)")
    p.add_argument("--phase-prefill-ratio", type=float, default=2.0,
                   help="prompt len >= ratio * max_new_tokens routes "
                        "to prefill-phase replicas when any exist")
    p.add_argument("--fleet-admission", action="store_true",
                   help="shed (503 + Retry-After) at the router when "
                        "the planned replica reports ptpu_slo_burning")
    a = p.parse_args(argv)
    router = Router(a.replica, host=a.host, port=a.port,
                    prefix_len=a.prefix_len,
                    scrape_interval_s=a.scrape_interval_s,
                    scrape_timeout_s=a.scrape_timeout_s,
                    drain_deadline_s=a.drain_deadline_s,
                    enable_directory=not a.no_prefix_directory,
                    breaker_fails=a.breaker_fails,
                    breaker_open_s=a.breaker_open_s,
                    retry_budget_ratio=a.retry_budget_ratio,
                    retry_budget_burst=a.retry_budget_burst,
                    enable_hedge=not a.no_hedge,
                    hedge_ttft_mult=a.hedge_ttft_mult,
                    hedge_min_s=a.hedge_min_s,
                    hedge_max_s=a.hedge_max_s,
                    kv_transfer=a.kv_transfer,
                    phase_prefill_ratio=a.phase_prefill_ratio,
                    fleet_admission=a.fleet_admission)
    router.start().install_signals()
    code = router.wait()
    router.stop()
    return code if code is not None else 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
