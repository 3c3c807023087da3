"""The port's async front door: a mirror of tests/test_async_frontdoor.py
over the port's engine — TLS + bearer auth, slow-client eviction, and
router fleet admission.

The front-end and router serve every connection as a coroutine on one
acceptor thread (serve/aio.py), so the invariants here are about what
the TRANSPORT does — a client that stops draining its socket is evicted
at `write_deadline_s` with its KV freed, TLS/auth wrap the same
byte-identical SSE stream, and the router sheds at the fleet's front
door off the scraped `ptpu_slo_burning` gauges before a burning replica
sees the request.
"""
import json
import os
import socket
import threading
import time

import jax
import jax.numpy as jnp
import pytest

from paddle_tpu_torch.engine.engine import ServeEngine
from paddle_tpu.models.transformer import CausalLM as JaxCausalLM
from paddle_tpu_torch.models import CausalLM, load_jax_params
from paddle_tpu_torch.obs.metrics import MetricsRegistry
from paddle_tpu_torch.obs.slo import SLOMonitor, SLOObjective
from paddle_tpu_torch.serve.frontend import ServeFrontend
from paddle_tpu_torch.serve.router import ReplicaState, Router
from paddle_tpu_torch.serve.sse import (collect_stream, http_get,
                                  parse_prometheus_values,
                                  stream_completion)

pytestmark = pytest.mark.serve

VOCAB = 61
TESTDATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "testdata")
TLS_CERT = os.path.join(TESTDATA, "tls_cert.pem")
TLS_KEY = os.path.join(TESTDATA, "tls_key.pem")


def _model(max_len=64):
    """The JAX test's fixture model: its `model.init(PRNGKey(0))` weights
    loaded into the port's CausalLM. The port's engine owns the model's
    weights, so `variables` is None."""
    jm = JaxCausalLM(vocab=VOCAB, model_dim=16, num_heads=4, num_layers=2,
                     ffn_dim=32, dropout=0.0, max_len=max_len)
    jvars = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    model = CausalLM(VOCAB, model_dim=16, num_heads=4, num_layers=2,
                     ffn_dim=32, dropout=0.0, max_len=max_len, device="cpu")
    load_jax_params(model, jax.device_get(jvars))
    return model, None


@pytest.fixture(scope="module")
def model_and_vars():
    return _model()


def _engine(model, variables, **kw):
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("block_size", 4)
    kw.setdefault("num_blocks", 64)
    kw.setdefault("registry", MetricsRegistry())
    return ServeEngine(model, device="cpu", **kw)


def _wait_until(pred, timeout=15.0, interval=0.02):
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


# -- TLS + bearer auth -----------------------------------------------------

class TestTLSAuth:
    @pytest.fixture(scope="class")
    def tls_fe(self, model_and_vars):
        model, variables = model_and_vars
        fe = ServeFrontend(_engine(model, variables),
                           drain_deadline_s=10.0,
                           tls_cert=TLS_CERT, tls_key=TLS_KEY,
                           auth_token="s3cret").start()
        yield fe
        fe.stop()

    def test_tls_stream_round_trip_with_bearer(self, tls_fe,
                                               model_and_vars):
        """The SSE stream over https+auth is byte-identical to the
        engine's own decode — TLS is a transport wrapper, nothing
        else."""
        model, variables = model_and_vars
        assert tls_fe.url.startswith("https://")
        prompt = [5, 9, 2, 7]
        reference = _engine(model, variables).generate(
            [prompt], max_new_tokens=12)[0]
        out = collect_stream(
            tls_fe.url, {"prompt": prompt, "max_new_tokens": 12},
            headers={"Authorization": "Bearer s3cret"})
        assert out["status"] == 200
        assert out["done"], "stream ended without [DONE]"
        assert out["tokens"] == reference

    def test_missing_or_wrong_token_is_401(self, tls_fe):
        out = collect_stream(tls_fe.url, {"prompt": [1, 2],
                                          "max_new_tokens": 4})
        assert out["status"] == 401
        out = collect_stream(
            tls_fe.url, {"prompt": [1, 2], "max_new_tokens": 4},
            headers={"Authorization": "Bearer wrong"})
        assert out["status"] == 401
        # the 401 body/headers tell the client what to send
        s = stream_completion(tls_fe.url, {"prompt": [1, 2],
                                           "max_new_tokens": 4})
        assert s.resp.getheader("WWW-Authenticate") == "Bearer"
        s.close()

    def test_healthz_stays_open_for_probes(self, tls_fe):
        status, _ = http_get(tls_fe.url + "/healthz")
        assert status == 200
        # every other route is behind the token — including /metrics
        status, _ = http_get(tls_fe.url + "/metrics")
        assert status == 401


# -- slow-client eviction --------------------------------------------------

class TestSlowClient:
    def test_stalled_reader_evicted_neighbors_unharmed(self):
        """A client that stops draining its socket mid-stream must be
        evicted at `write_deadline_s` — transport aborted, KV blocks
        freed, `ptpu_serve_slow_client_evictions_total` counted — while
        a concurrent well-behaved stream on the same front-end stays
        byte-identical and untruncated. Tiny kernel buffers
        (sock_sndbuf + client SO_RCVBUF) make ~250 token frames
        overrun every buffer between the loop and the stalled peer, so
        `drain()` genuinely blocks and the deadline fires."""
        model, variables = _model(max_len=256)
        eng = _engine(model, variables, num_blocks=512)
        reference = _engine(model, variables, num_blocks=512).generate(
            [[9, 8, 7]], max_new_tokens=40)[0]
        fe = ServeFrontend(eng, drain_deadline_s=10.0,
                           write_deadline_s=1.0,
                           sock_sndbuf=1,            # kernel clamps to min
                           write_buffer_limit=1024).start()
        try:
            baseline = eng.cache.occupancy()
            healthy = {}

            def well_behaved():
                healthy.update(collect_stream(
                    fe.url, {"prompt": [9, 8, 7], "max_new_tokens": 40}))

            # the stall: raw socket, minimal receive buffer, reads the
            # response head then never recv()s again
            sock = socket.socket()
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1)
            sock.connect(("127.0.0.1", fe.port))
            body = json.dumps({"prompt": [1, 2, 3, 4],
                               "max_new_tokens": 250,
                               "stream": True}).encode()
            sock.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                         b"Content-Type: application/json\r\n"
                         b"Content-Length: %d\r\n\r\n" % len(body) + body)
            assert sock.recv(256).startswith(b"HTTP/1.0 200")
            t = threading.Thread(target=well_behaved)
            t.start()
            try:
                assert _wait_until(lambda: _counter_value(
                    eng.obs, "ptpu_serve_slow_client_evictions_total")
                    == 1.0), "slow client never evicted"
            finally:
                t.join(timeout=30)
            assert not t.is_alive()
            # eviction cancelled the request: every block back
            assert _wait_until(
                lambda: eng.cache.occupancy() == baseline), \
                "evicted stream leaked KV blocks"
            eng.cache.assert_quiesced()
            # the neighbour never noticed
            assert healthy["status"] == 200 and healthy["done"]
            assert healthy["tokens"] == reference
            sock.close()
        finally:
            fe.stop()


# -- fleet admission -------------------------------------------------------

def _burning_replica(r):
    r.burning = ("ttft",)
    return r


class TestFleetAdmissionUnit:
    def _router(self, **kw):
        kw.setdefault("fleet_admission", True)
        return Router([], **kw)

    def test_reason_primary_vs_fleet_vs_none(self):
        rt = self._router()
        a, b = ReplicaState("http://a:1"), ReplicaState("http://b:2")
        assert rt._fleet_admission_reason([a, b]) is None
        assert rt._fleet_admission_reason(
            [_burning_replica(ReplicaState("http://a:1")), b]) \
            == "primary_burn"
        # healthy primary, burning fallback: ADMIT — fleet admission
        # never spills a hot shard's traffic onto the healthy primary's
        # neighbours, and a healthy primary serves its own shard
        assert rt._fleet_admission_reason(
            [a, _burning_replica(ReplicaState("http://b:2"))]) is None
        assert rt._fleet_admission_reason(
            [_burning_replica(ReplicaState("http://a:1")),
             _burning_replica(ReplicaState("http://b:2"))]) \
            == "fleet_burn"

    def test_opt_in_default_off(self):
        rt = Router([])
        assert rt.fleet_admission is False
        assert rt._fleet_admission_reason(
            [_burning_replica(ReplicaState("http://a:1"))]) is None


class TestFleetAdmissionIntegration:
    @pytest.fixture(scope="class")
    def fleet(self, model_and_vars):
        """A healthy replica + a replica whose SLO monitor burns after
        its first completion, behind a fleet-admission router."""
        model, variables = model_and_vars
        healthy = ServeFrontend(_engine(model, variables),
                                drain_deadline_s=10.0).start()
        eng = _engine(model, variables)
        slo = SLOMonitor(
            eng.obs,
            objectives=[SLOObjective("ttft", "ptpu_serve_ttft_ms",
                                     0.001, 0.5)],
            short_window_s=5.0, long_window_s=30.0, min_samples=1)
        burning = ServeFrontend(eng, slo=slo, slo_interval_s=0.05,
                                drain_deadline_s=10.0).start()
        router = Router([healthy.url, burning.url],
                        scrape_interval_s=30.0,   # manual scrape_now only
                        fleet_admission=True).start()
        # light the fuse: one completion straight at the replica, then
        # its impossible TTFT objective (1us) reports burning forever
        out = collect_stream(burning.url, {"prompt": [1, 2],
                                           "max_new_tokens": 4})
        assert out["status"] == 200
        assert _wait_until(slo.any_burning)
        router.scrape_now(wait_s=10.0)
        yield router, healthy, burning
        router.stop()
        healthy.stop()
        burning.stop()

    def _prompt_with_primary(self, router, target_url, max_tries=64):
        """Sticky routing is a prompt-prefix hash: walk prompts until
        the plan's primary lands on `target_url`."""
        for i in range(max_tries):
            prompt = [3 + i % VOCAB, 11, (7 * i) % VOCAB, 5]
            plan = router.plan_route(prompt)
            if plan and plan[0].url == target_url:
                return prompt
        raise AssertionError(f"no prompt hashed to {target_url}")

    def test_scrape_publishes_burn_verdicts(self, fleet):
        router, healthy, burning = fleet
        with router._lock:
            by_url = {r.url: r.burning for r in router.replicas}
        assert by_url[burning.url] == ("ttft",)
        assert by_url[healthy.url] == ()
        vals = parse_prometheus_values(
            http_get(f"http://127.0.0.1:{router.port}/metrics")[1])
        assert vals[
            f'ptpu_router_replica_burning{{replica="{burning.url}"}}'] == 1.0
        assert vals[
            f'ptpu_router_replica_burning{{replica="{healthy.url}"}}'] == 0.0

    def test_burning_primary_shed_at_router(self, fleet):
        """The shed happens at the ROUTER: 503 + Retry-After with a
        `primary_burn` fleet-shed count, and the burning replica's own
        request counters never move — it never saw the request."""
        router, healthy, burning = fleet
        prompt = self._prompt_with_primary(router, burning.url)
        before = _counter_value(burning.engine.obs,
                                "ptpu_serve_sheds_total",
                                reason="slo_ttft")
        out = collect_stream(f"http://127.0.0.1:{router.port}",
                             {"prompt": prompt, "max_new_tokens": 4})
        assert out["status"] == 503
        assert json.loads(out["shed_body"])["reason"] == "primary_burn"
        assert _counter_value(router.obs, "ptpu_router_fleet_sheds_total",
                              reason="primary_burn") == 1.0
        assert _counter_value(burning.engine.obs, "ptpu_serve_sheds_total",
                              reason="slo_ttft") == before

    def test_healthy_primary_still_serves(self, fleet):
        router, healthy, burning = fleet
        prompt = self._prompt_with_primary(router, healthy.url)
        out = collect_stream(f"http://127.0.0.1:{router.port}",
                             {"prompt": prompt, "max_new_tokens": 6})
        assert out["status"] == 200 and out["done"]
        assert len(out["tokens"]) == 6

    def test_whole_fleet_burning_sheds_fleet_burn(self, fleet):
        router, healthy, burning = fleet
        with router._lock:
            saved = {r.url: r.burning for r in router.replicas}
            for r in router.replicas:
                r.burning = ("ttft",)
        try:
            out = collect_stream(f"http://127.0.0.1:{router.port}",
                                 {"prompt": [2, 4, 6], "max_new_tokens": 4})
            assert out["status"] == 503
            assert json.loads(out["shed_body"])["reason"] == "fleet_burn"
            assert _counter_value(router.obs,
                                  "ptpu_router_fleet_sheds_total",
                                  reason="fleet_burn") == 1.0
        finally:
            with router._lock:
                for r in router.replicas:
                    r.burning = saved[r.url]
