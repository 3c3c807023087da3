"""The port's fleet fault tolerance: a mirror of tests/test_fleet_ft.py's
cases that tests/test_torch_resilience.py and tests/test_torch_chaos.py
left out — the host-tier disk spill / warm-start, the router's dynamic
membership, circuit breaker, budget-gated failover-with-resume and
hedged requests, and the subprocess warm-restart end-to-end: drain a
port replica (`--device cpu`) with a populated host tier, restart it on
the same spill dir, and the revived KV is byte-identical.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from http.client import HTTPConnection
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from paddle_tpu_torch.engine.kvtier import HostKVTier
from paddle_tpu_torch.obs.metrics import MetricsRegistry
from paddle_tpu_torch.resilience.errors import PREEMPT_EXIT_CODE
from paddle_tpu_torch.serve.router import Router, prefix_shard
from paddle_tpu_torch.serve.sse import (collect_stream, http_get,
                                  parse_prometheus_values, sse_event)

pytestmark = pytest.mark.serve

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_no_jax(pid):
    """The replica process mapped no JAX library: it never imported
    jax (which would load jaxlib's shared objects)."""
    with open(f"/proc/{pid}/maps") as f:
        assert not [ln for ln in f if "jaxlib" in ln], \
            "the port's replica loaded jax"


def _wait_until(pred, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


def _counter_value(registry, name, **labels):
    fam = registry.get(name)
    if fam is None:
        return 0.0
    child = fam.labels(**labels) if labels else fam
    return child.value


# -- host-tier disk spill / warm-start (engine/kvtier.py) ------------------

def _layers(rng, num_layers=2, bs=4, heads=2, hd=8):
    return [(rng.standard_normal((bs, heads, hd)).astype(np.float32),
             rng.standard_normal((bs, heads, hd)).astype(np.float32))
            for _ in range(num_layers)]


class TestTierSpill:
    def _roundtrip(self, tmp_path, int8):
        rng = np.random.default_rng(7)
        src = HostKVTier(1 << 20, int8=int8, registry=MetricsRegistry())
        keys = [(1, 2), (3, 4, 5), (9,)]
        for k in keys:
            src.put(k, _layers(rng))
        assert src.spill(str(tmp_path)) == len(keys)
        dst = HostKVTier(1 << 20, int8=int8, registry=MetricsRegistry())
        assert dst.load_spill(str(tmp_path)) == len(keys)
        # byte-identical revival: the restarted tier serves EXACTLY the
        # blobs the pre-restart tier would have (int8 included — the
        # quantized payload and its scales round-trip bit-exact, so
        # dequantization is bit-identical too)
        for k in keys:
            for (k0, v0), (k1, v1) in zip(src.get(k), dst.get(k)):
                assert np.array_equal(k0, k1) and k0.dtype == k1.dtype
                assert np.array_equal(v0, v1) and v0.dtype == v1.dtype
        assert dst.advertised(64) == src.advertised(64)
        assert dst.nbytes == src.nbytes

    def test_fp_spill_roundtrip_bit_exact(self, tmp_path):
        self._roundtrip(tmp_path, int8=False)

    def test_int8_spill_roundtrip_bit_exact(self, tmp_path):
        self._roundtrip(tmp_path, int8=True)

    def test_mode_mismatch_and_corruption_load_zero(self, tmp_path):
        rng = np.random.default_rng(8)
        src = HostKVTier(1 << 20, int8=False, registry=MetricsRegistry())
        src.put((1,), _layers(rng))
        src.spill(str(tmp_path))
        # int8 tier must not load an fp spill (payload layout differs)
        quant = HostKVTier(1 << 20, int8=True, registry=MetricsRegistry())
        assert quant.load_spill(str(tmp_path)) == 0
        # a torn npz (manifest intact) fails the crc and loads nothing
        with open(os.path.join(str(tmp_path), "tier-spill.npz"),
                  "r+b") as f:
            f.seek(-16, os.SEEK_END)
            f.write(b"\x00" * 16)
        fresh = HostKVTier(1 << 20, registry=MetricsRegistry())
        assert fresh.load_spill(str(tmp_path)) == 0
        assert len(fresh) == 0
        # and an absent dir is a cold start, not an error
        assert fresh.load_spill(os.path.join(str(tmp_path), "nope")) == 0


# -- scripted replica double for router fault tests ------------------------

class ScriptedReplica:
    """A stdlib stand-in for a serve replica with scriptable faults:
    answers /readyz + /metrics + /kvprefixes like the real front-end,
    and streams `tokens` as SSE on POST /v1/completions. Knobs (all
    mutable mid-test): `truncate_after` cuts the stream after that many
    token frames WITHOUT [DONE]; `first_byte_delay_s` stalls before
    responding (a straggler for hedging); `metrics_stall_s` wedges the
    /metrics handler (the scrape-hardening regression); `shed` answers
    503."""

    def __init__(self, tokens=tuple(range(10))):
        self.tokens = list(tokens)
        self.truncate_after = None
        self.first_byte_delay_s = 0.0
        self.metrics_stall_s = 0.0
        self.shed = False
        self.requests = 0
        self.prefixes = []
        self._srv = None
        self._thread = None
        self.port = 0

    def start(self, port=0):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _body(self, status, ctype, body):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):               # noqa: N802
                try:
                    if self.path == "/readyz":
                        self._body(200, "text/plain", b"ok\n")
                    elif self.path == "/metrics":
                        if outer.metrics_stall_s:
                            time.sleep(outer.metrics_stall_s)
                        self._body(200, "text/plain",
                                   b"ptpu_kv_hit_rate 0.5\n"
                                   b"ptpu_sched_queue_depth 0\n"
                                   b"ptpu_engine_compiles 1\n")
                    elif self.path == "/kvprefixes":
                        self._body(200, "application/json", json.dumps(
                            {"prefixes": outer.prefixes}).encode())
                    else:
                        self._body(404, "text/plain", b"nope\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def do_POST(self):              # noqa: N802
                outer.requests += 1
                length = int(self.headers.get("Content-Length", "0"))
                self.rfile.read(length)
                if outer.first_byte_delay_s:
                    time.sleep(outer.first_byte_delay_s)
                try:
                    if outer.shed:
                        self._body(503, "application/json",
                                   b'{"error": "overloaded", '
                                   b'"reason": "queue_full"}\n')
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.end_headers()
                    for i, tok in enumerate(outer.tokens):
                        if (outer.truncate_after is not None
                                and i >= outer.truncate_after):
                            return          # mid-stream death: no [DONE]
                        self.wfile.write(sse_event(
                            {"token": tok, "index": 0, "pos": i}))
                        self.wfile.flush()
                    self.wfile.write(sse_event(
                        {"done": True, "reason": "length",
                         "tokens": outer.tokens}))
                    self.wfile.write(sse_event("[DONE]"))
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass

        self._srv = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self._srv.daemon_threads = True
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    @property
    def url(self):
        return f"http://127.0.0.1:{self.port}"

    def stop(self):
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
            self._srv = None


def _router(urls, **kw):
    kw.setdefault("scrape_interval_s", 0.05)
    kw.setdefault("scrape_timeout_s", 0.5)
    kw.setdefault("breaker_open_s", 0.3)
    return Router(urls, **kw)


# -- dynamic membership + circuit breaker ----------------------------------

class TestMembership:
    def test_register_admits_and_empty_fleet_sheds(self):
        router = _router([]).start()     # argv seed empty: register-only
        try:
            out = collect_stream(router.url, {"prompt": [1, 2, 3],
                                              "max_new_tokens": 4})
            assert out["status"] == 503
            assert json.loads(out["shed_body"])["reason"] == "no_replica"
            rep = ScriptedReplica().start()
            try:
                # the wire-level join: POST /register {"url": ...}
                conn = HTTPConnection("127.0.0.1", router.port, timeout=5)
                conn.request("POST", "/register",
                             body=json.dumps({"url": rep.url}).encode(),
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                ack = json.loads(resp.read())
                conn.close()
                assert resp.status == 200 and ack["ok"]
                assert ack["ready"], "inline probe should admit at once"
                out = collect_stream(router.url, {"prompt": [1, 2, 3],
                                                  "max_new_tokens": 4})
                assert out["status"] == 200 and out["done"]
                assert out["tokens"] == rep.tokens
                assert _counter_value(
                    router.obs, "ptpu_router_membership_events_total",
                    event="register") == 1.0
                # re-registering the same url is a heartbeat, not a dup
                router.register_replica(rep.url)
                assert len(router.replicas) == 1
            finally:
                rep.stop()
        finally:
            router.begin_drain()
            router.stop()

    def test_breaker_evicts_dead_replica_and_rejoins_on_register(self):
        rep = ScriptedReplica().start()
        router = _router([rep.url], breaker_fails=2).start()
        try:
            assert _wait_until(lambda: router.replicas[0].ready)
            port = rep.port
            rep.stop()                   # replica dies (connection refused)
            assert _wait_until(
                lambda: router.replicas[0].breaker == "open", timeout=15)
            assert _counter_value(
                router.obs, "ptpu_router_membership_events_total",
                event="evict") == 1.0
            # breaker open: the replica is not even a fallback candidate
            assert router.plan_route([1, 2, 3]) == []
            # warm restart on the SAME port + re-register: the forced
            # half-open probe admits it immediately
            rep.start(port=port)
            router.register_replica(rep.url)
            r = router.replicas[0]
            assert r.ready and r.breaker == "closed"
            assert _counter_value(
                router.obs, "ptpu_router_membership_events_total",
                event="rejoin") >= 1.0
            out = collect_stream(router.url, {"prompt": [1, 2, 3],
                                              "max_new_tokens": 4})
            assert out["status"] == 200 and out["done"]
        finally:
            rep.stop()
            router.begin_drain()
            router.stop()

    def test_wedged_metrics_only_stales_its_own_replica(self):
        """The scrape-hardening regression: one replica's /metrics
        handler wedges; its staleness gauge must GROW while the healthy
        replica keeps scraping fresh every interval — the per-replica
        scrape threads keep one hung handler from stalling the loop."""
        good, bad = ScriptedReplica().start(), ScriptedReplica().start()
        router = _router([good.url, bad.url], scrape_interval_s=0.1,
                         scrape_timeout_s=0.4, breaker_fails=1000).start()
        try:
            assert _wait_until(lambda: all(
                r.ready for r in router.replicas))
            bad.metrics_stall_s = 30.0
            time.sleep(1.2)              # ~12 intervals under the wedge
            with router._lock:
                good_age = time.monotonic() - router.replicas[0].last_scrape
                bad_age = time.monotonic() - router.replicas[1].last_scrape
            assert good_age < 0.5, "healthy replica went stale too"
            assert bad_age > 1.0, "wedged replica should be stale"
            # and the staleness is exported where alerts can see it
            vals = parse_prometheus_values(
                http_get(router.url + "/metrics")[1])
            key = f'ptpu_router_scrape_age_seconds{{replica="{bad.url}"}}'
            assert vals[key] > 1.0
            # the healthy replica still serves traffic throughout
            out = collect_stream(router.url, {"prompt": [5, 6],
                                              "max_new_tokens": 4})
            assert out["status"] == 200 and out["done"]
        finally:
            bad.metrics_stall_s = 0.0
            good.stop()
            bad.stop()
            router.begin_drain()
            router.stop()


# -- failover, retry budget, hedging ---------------------------------------

class TestFailover:
    def _ordered_pair(self, **first_kw):
        """Two scripted replicas plus the url list to seed the router
        with; the FIRST returned replica is the hash primary for prompt
        [1, 2, 3] over that 2-member ready set and gets `first_kw`
        applied (the fault under test)."""
        a, b = ScriptedReplica().start(), ScriptedReplica().start()
        pair = [a, b]
        shard = prefix_shard([1, 2, 3], 2)
        primary = pair[shard]
        other = pair[1 - shard]
        for k, v in first_kw.items():
            setattr(primary, k, v)
        return primary, other, [a.url, b.url]

    def test_midstream_death_fails_over_with_resume(self):
        """Primary dies after 3 token frames; the stream must continue
        on the fallback with NO duplicated and NO missing frames, and
        still end in [DONE] — the client never learns a replica died."""
        primary, other, urls = self._ordered_pair(truncate_after=3)
        router = _router(urls, enable_hedge=False).start()
        try:
            assert _wait_until(lambda: all(
                r.ready for r in router.replicas))
            out = collect_stream(router.url, {"prompt": [1, 2, 3],
                                              "max_new_tokens": 10})
            assert out["status"] == 200
            assert out["done"], "failover truncated the stream"
            assert out["tokens"] == primary.tokens   # exactly once each
            assert primary.requests == 1 and other.requests == 1
            assert _counter_value(router.obs, "ptpu_router_retries_total",
                                  kind="stream") == 1.0
        finally:
            primary.stop()
            other.stop()
            router.begin_drain()
            router.stop()

    def test_exhausted_retry_budget_sheds_503(self):
        """Every replica down + an empty budget: attempt 1 is free,
        attempt 2 needs a token it cannot get -> 503 with the dedicated
        reason (not a storm of doomed connects)."""
        dead = [f"http://127.0.0.1:{_free_port()}" for _ in range(2)]
        router = _router(dead, retry_budget_burst=0.0,
                         enable_hedge=False, breaker_fails=1000).start()
        try:
            out = collect_stream(router.url, {"prompt": [9, 9],
                                              "max_new_tokens": 4})
            assert out["status"] == 503
            assert json.loads(out["shed_body"])["reason"] == "retry_budget"
            assert _counter_value(router.obs, "ptpu_router_sheds_total",
                                  reason="retry_budget") == 1.0
            assert _counter_value(
                router.obs, "ptpu_resilience_retry_budget_denied_total",
                site="router") >= 1.0
        finally:
            router.begin_drain()
            router.stop()

    def test_hedge_beats_straggler_primary(self):
        """Primary stalls 1.5 s before its first byte; with the fleet
        TTFT unmeasured the hedge fires at hedge_max_s and the fast
        replica's response wins — the client sees fast tokens and the
        loser is cancelled, not leaked."""
        primary, other, urls = self._ordered_pair(first_byte_delay_s=1.5)
        router = _router(urls, hedge_max_s=0.2).start()
        try:
            assert _wait_until(lambda: all(
                r.ready for r in router.replicas))
            t0 = time.monotonic()
            out = collect_stream(router.url, {"prompt": [1, 2, 3],
                                              "max_new_tokens": 10})
            elapsed = time.monotonic() - t0
            assert out["status"] == 200 and out["done"]
            assert out["tokens"] == other.tokens
            assert elapsed < 1.4, "hedge should beat the straggler"
            assert _counter_value(router.obs, "ptpu_router_hedges_total",
                                  outcome="won") == 1.0
            # both replicas saw the request: primary's socket gets
            # reaped once its late response lands
            assert _wait_until(lambda: primary.requests == 1, timeout=5)
        finally:
            primary.stop()
            other.stop()
            router.begin_drain()
            router.stop()


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# -- subprocess warm restart (the tier-1 end-to-end) -----------------------

class TestWarmRestart:
    def _boot(self, spill_dir, extra=()):
        # one intra-op thread: beside the suite's other workers, torch's
        # default pool oversubscribes the cores and a tiny decode step
        # takes ~0.5 s instead of ~3 ms
        env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.serve.replica",
             "--device", "cpu",
             "--port", "0", "--drain-deadline-s", "20",
             "--num-blocks", "10", "--host-tier-bytes", str(1 << 20),
             "--tier-spill-dir", spill_dir, *extra],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            env=env, text=True, cwd=REPO_ROOT)
        port = None
        for line in proc.stdout:
            try:
                evt = json.loads(line)
            except ValueError:
                continue
            if evt.get("evt") == "serve_listening":
                port = evt["port"]
                break
        assert port, "replica never printed serve_listening"
        _assert_no_jax(proc.pid)
        return proc, f"http://127.0.0.1:{port}"

    def test_drain_spills_and_restart_revives_byte_identical(self, tmp_path):
        """Boot a replica with a tight pool + host tier + spill dir;
        generate (cold), churn so the prompt's blocks demote to the
        host tier, SIGTERM-drain (spills to disk), then boot a FRESH
        process on the same dir: it must warm-start the tier
        (spill_loaded > 0), serve the same prompt with tokens
        byte-identical to the cold run via tier revival
        (revived_blocks > 0) — all on one compiled step."""
        spill = str(tmp_path)
        system = [7, 3, 7, 3, 11, 2, 5, 9, 1, 1, 4, 8]
        prompt = system + [21, 22, 23, 24]
        proc, base = self._boot(spill)
        try:
            cold = collect_stream(base, {"prompt": prompt,
                                         "max_new_tokens": 8})
            assert cold["status"] == 200 and cold["done"]
            for i in range(2):           # churn: recycle the tight pool
                out = collect_stream(base, {"prompt": [50 + i] * 16,
                                            "max_new_tokens": 4})
                assert out["status"] == 200
            vals = parse_prometheus_values(http_get(base + "/metrics")[1])
            assert vals.get("ptpu_kv_tier_entries", 0) > 0, \
                "churn never demoted the prompt into the host tier"
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=60) == PREEMPT_EXIT_CODE
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
        assert os.path.exists(os.path.join(spill, "tier-spill.json"))

        proc, base = self._boot(spill)
        try:
            vals = parse_prometheus_values(http_get(base + "/metrics")[1])
            assert vals["ptpu_kv_tier_spill_loaded_blocks_total"] > 0, \
                "restart did not warm-start from the spill"
            warm = collect_stream(base, {"prompt": prompt,
                                         "max_new_tokens": 8})
            assert warm["status"] == 200 and warm["done"]
            # byte-identical revival: same weights (same --init-seed),
            # KV revived from the spilled fp tier -> same greedy tokens
            assert warm["tokens"] == cold["tokens"]
            vals = parse_prometheus_values(http_get(base + "/metrics")[1])
            assert vals["ptpu_kv_tier_revived_blocks_total"] > 0
            assert vals["ptpu_engine_compiles"] == 1.0
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=60) == PREEMPT_EXIT_CODE
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
