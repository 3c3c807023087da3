"""The port's serving front-end (paddle_tpu_torch/serve/): a mirror of
tests/test_serve_http.py over the port's engine, on the JAX test's
model.init weights — SSE streaming identity against the engine,
mid-stream client disconnect -> KV blocks freed (shared prefix
refcounts included), admission shedding (queue depth and SLO burn),
readiness lifecycle, drain-with-no-truncation, the router's
sticky/fallback policy, the lock-discipline regressions, and the
subprocess smoke: a real port replica process (`--device cpu`) streams
a completion, gets SIGTERMed, drains every in-flight stream untruncated
and exits 75 — and never loads JAX.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu_torch.engine.engine import ServeEngine
from paddle_tpu.models.transformer import CausalLM as JaxCausalLM
from paddle_tpu_torch.models import CausalLM, load_jax_params
from paddle_tpu_torch.obs.metrics import MetricsRegistry
from paddle_tpu_torch.obs.slo import SLOMonitor, SLOObjective
from paddle_tpu_torch.resilience.errors import PREEMPT_EXIT_CODE
from paddle_tpu_torch.serve.frontend import ServeFrontend
from paddle_tpu_torch.serve.router import Router, prefix_shard
from paddle_tpu_torch.serve.sse import (collect_stream, http_get,
                                  parse_prometheus_values,
                                  stream_completion)

pytestmark = pytest.mark.serve

VOCAB = 61
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _frontend(model, variables, engine_kw=None, **kw):
    eng = _engine(model, variables, **(engine_kw or {}))
    kw.setdefault("drain_deadline_s", 10.0)
    return ServeFrontend(eng, **kw)


@pytest.fixture(scope="module")
def shared_fe(model_and_vars):
    """One started frontend shared by tests that leave it clean
    (read-only streams, or cancellations that drain back to an empty
    cache). Saves a step compile per test."""
    model, variables = model_and_vars
    fe = _frontend(model, variables).start()
    yield fe
    fe.stop()


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


# -- streaming data plane --------------------------------------------------

class TestStreaming:
    def test_stream_matches_engine_decode(self, model_and_vars, shared_fe):
        model, variables = model_and_vars
        prompt = [5, 9, 2, 7]
        reference = _engine(model, variables).generate(
            [prompt], max_new_tokens=12)[0]
        out = collect_stream(shared_fe.url, {"prompt": prompt,
                                             "max_new_tokens": 12})
        assert out["status"] == 200
        assert out["done"], "stream ended without [DONE]"
        assert out["tokens"] == reference
        assert out["final"]["reason"] == "length"
        assert out["final"]["tokens"] == reference

    def test_aggregate_response(self, shared_fe):
        import urllib.request
        req = urllib.request.Request(
            shared_fe.url + "/v1/completions",
            data=json.dumps({"prompt": [3, 1, 4], "max_new_tokens": 5,
                             "stream": False}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = json.loads(resp.read())
        assert resp.status == 200
        assert len(body["tokens"]) == 5
        assert body["reason"] == "length"

    def test_bad_request_400(self, shared_fe):
        out = collect_stream(shared_fe.url, {"prompt": [1, "two", 3]})
        assert out["status"] == 400
        out = collect_stream(shared_fe.url, {})     # missing prompt
        assert out["status"] == 400
        status, _ = http_get(shared_fe.url + "/nope")
        assert status == 404

    def test_observability_surface_on_serve_port(self, shared_fe):
        collect_stream(shared_fe.url, {"prompt": [2, 2],
                                       "max_new_tokens": 3})
        status, text = http_get(shared_fe.url + "/metrics")
        assert status == 200
        vals = parse_prometheus_values(text)
        assert vals['ptpu_serve_requests_total{reason="length"}'] >= 1
        assert vals["ptpu_engine_compiles"] == 1.0  # one-compile rule
        status, body = http_get(shared_fe.url + "/slo")
        v = json.loads(body)
        assert status == 200 and set(v["objectives"]) == {
            "ttft", "tpot", "queue_wait"}
        assert http_get(shared_fe.url + "/healthz")[0] == 200


# -- cancellation ----------------------------------------------------------

class TestCancellation:
    def test_midstream_disconnect_frees_kv(self, shared_fe):
        """A client hanging up mid-stream must free the request's KV
        blocks — occupancy back to baseline, no leaked refcounts on
        prefix blocks shared with a still-live stream — and count
        under requests{reason=\"cancelled\"}."""
        eng = shared_fe.engine
        baseline = eng.cache.occupancy()
        prefix = [7, 7, 7, 7, 1, 2, 3, 4]           # two shared blocks
        survivor = stream_completion(
            shared_fe.url, {"prompt": prefix, "max_new_tokens": 40})
        victim = stream_completion(
            shared_fe.url, {"prompt": prefix, "max_new_tokens": 40})
        assert survivor.status == 200 and victim.status == 200
        vit = victim.events()
        next(vit)                                   # stream is live
        victim.close()                              # hang up mid-stream
        assert _wait_until(lambda: _counter_value(
            eng.obs, "ptpu_serve_requests_total",
            reason="cancelled") == 1.0), "cancel never counted"
        # the survivor sharing the prefix must be unharmed: full
        # generation, clean [DONE]
        tokens = [ev["token"] for ev in survivor.events()
                  if "token" in ev]
        assert survivor.done and len(tokens) == 40
        # every block back: no refcount leaked on the shared prefix
        assert _wait_until(
            lambda: eng.cache.occupancy() == baseline)
        eng.cache.assert_quiesced()

    def test_cancel_waiting_request(self, model_and_vars):
        """A disconnect before admission (request still queued) must
        remove it from the wait queue without touching the cache."""
        model, variables = model_and_vars
        # batch of 1 so the second request waits in the queue
        fe = _frontend(model, variables,
                       engine_kw={"max_batch_size": 1}).start()
        eng = fe.engine
        try:
            runner = stream_completion(
                fe.url, {"prompt": [1, 2, 3], "max_new_tokens": 40})
            rit = runner.events()
            next(rit)                               # admitted + decoding
            waiter = stream_completion(
                fe.url, {"prompt": [4, 5, 6], "max_new_tokens": 40})
            assert _wait_until(
                lambda: eng.scheduler.queue_depth == 1)
            waiter.close()
            assert _wait_until(lambda: _counter_value(
                eng.obs, "ptpu_serve_requests_total",
                reason="cancelled") == 1.0)
            assert eng.scheduler.queue_depth == 0
            tokens = [ev["token"] for ev in rit if "token" in ev]
            assert runner.done and len(tokens) == 39    # 40 - 1 read above
        finally:
            fe.stop()


# -- admission control -----------------------------------------------------

class TestAdmission:
    def test_shed_on_queue_full(self, model_and_vars):
        model, variables = model_and_vars
        fe = _frontend(model, variables, max_queue_depth=0).start()
        try:
            out = collect_stream(fe.url, {"prompt": [1, 2],
                                          "max_new_tokens": 4})
            assert out["status"] == 503
            assert json.loads(out["shed_body"])["reason"] == "queue_full"
            vals = parse_prometheus_values(http_get(fe.url + "/metrics")[1])
            assert vals[
                'ptpu_serve_sheds_total{reason="queue_full"}'] == 1.0
        finally:
            fe.stop()

    def test_shed_on_slo_burn(self, model_and_vars):
        """An impossible TTFT objective (sub-microsecond) burns after
        the first completions; the next request must bounce 503 with a
        labeled slo_ttft shed."""
        model, variables = model_and_vars
        eng = _engine(model, variables)
        slo = SLOMonitor(
            eng.obs,
            objectives=[SLOObjective("ttft", "ptpu_serve_ttft_ms",
                                     0.001, 0.5)],
            short_window_s=5.0, long_window_s=30.0, min_samples=1)
        fe = ServeFrontend(eng, slo=slo, slo_interval_s=0.05,
                           drain_deadline_s=10.0).start()
        try:
            out = collect_stream(fe.url, {"prompt": [1, 2],
                                          "max_new_tokens": 4})
            assert out["status"] == 200             # admitted: no burn yet
            assert _wait_until(slo.any_burning)
            out = collect_stream(fe.url, {"prompt": [3, 4],
                                          "max_new_tokens": 4})
            assert out["status"] == 503
            assert json.loads(out["shed_body"])["reason"] == "slo_ttft"
            assert _counter_value(eng.obs, "ptpu_serve_sheds_total",
                                  reason="slo_ttft") == 1.0
            # the scrape agrees with the shed decision
            vals = parse_prometheus_values(http_get(fe.url + "/metrics")[1])
            assert vals['ptpu_slo_burning{objective="ttft"}'] == 1.0
            assert vals["ptpu_slo_ok"] == 0.0
        finally:
            fe.stop()


# -- readiness + drain -----------------------------------------------------

class TestLifecycle:
    def test_readiness_lifecycle(self, model_and_vars):
        model, variables = model_and_vars
        fe = _frontend(model, variables, warmup=False)
        fe._warmup = False
        fe.start()
        try:
            # cold: live but not ready
            assert http_get(fe.url + "/healthz")[0] == 200
            status, body = http_get(fe.url + "/readyz")
            assert status == 503 and "cold" in body
            fe.warmup()
            assert http_get(fe.url + "/readyz")[0] == 200
            vals = parse_prometheus_values(http_get(fe.url + "/metrics")[1])
            assert vals["ptpu_serve_ready"] == 1.0
            assert vals["ptpu_engine_compiles"] == 1.0
            fe.begin_drain()
            status, body = http_get(fe.url + "/readyz")
            assert status == 503 and "draining" in body
            assert http_get(fe.url + "/healthz")[0] == 200  # still alive
            assert fe.wait(10) == PREEMPT_EXIT_CODE
        finally:
            fe._teardown()

    def test_drain_completes_inflight_stream(self, model_and_vars):
        """begin_drain() mid-stream: the stream must run to its [DONE]
        (zero truncation), new work sheds with reason=draining, and
        the loop exits 75."""
        model, variables = model_and_vars
        fe = _frontend(model, variables).start()
        try:
            s = stream_completion(fe.url, {"prompt": [9, 8, 7],
                                           "max_new_tokens": 40})
            it = s.events()
            next(it)
            fe.begin_drain()
            out = collect_stream(fe.url, {"prompt": [1, 1],
                                          "max_new_tokens": 2})
            assert out["status"] == 503
            assert json.loads(out["shed_body"])["reason"] == "draining"
            tokens = [ev["token"] for ev in it if "token" in ev]
            assert s.done, "drain truncated an in-flight stream"
            assert len(tokens) == 39                # 40 minus the one read
            assert fe.wait(15) == PREEMPT_EXIT_CODE
            assert _counter_value(
                fe.engine.obs, "ptpu_serve_sheds_total",
                reason="draining") == 1.0
        finally:
            fe._teardown()


# -- router ----------------------------------------------------------------

class TestRouter:
    def test_prefix_shard_stable(self):
        assert prefix_shard([1, 2, 3], 4) == prefix_shard([1, 2, 3], 4)
        assert prefix_shard([1, 2, 3, 99], 4, prefix_len=3) == \
            prefix_shard([1, 2, 3, 42], 4, prefix_len=3)
        shards = {prefix_shard([i] * 8, 4) for i in range(32)}
        assert len(shards) > 1                      # actually spreads

    def test_sticky_routing_and_fallback(self, model_and_vars):
        model, variables = model_and_vars
        fes = [_frontend(model, variables).start() for _ in range(2)]
        router = Router([fe.url for fe in fes], prefix_len=4,
                        scrape_interval_s=0.1).start()
        try:
            assert http_get(router.url + "/readyz")[0] == 200
            # same 4-token prefix -> same replica, every time
            prefix = [3, 1, 4, 1]
            shard = prefix_shard(prefix, 2, prefix_len=4)
            for suffix in ([5], [9], [2, 6]):
                out = collect_stream(router.url, {
                    "prompt": prefix + suffix, "max_new_tokens": 3})
                assert out["status"] == 200 and out["done"]
            routed = router._m_routed.labels(
                replica=fes[shard].url, kind="primary").value
            assert routed == 3.0
            # drain the sticky replica: traffic falls back, streams
            # stay untruncated
            fes[shard].begin_drain()
            fes[shard].wait(10)
            assert _wait_until(
                lambda: not router.replicas[shard].ready, timeout=5)
            out = collect_stream(router.url, {
                "prompt": prefix + [7], "max_new_tokens": 3})
            assert out["status"] == 200 and out["done"]
            fallback = router._m_routed.labels(
                replica=fes[1 - shard].url, kind="fallback").value
            assert fallback == 1.0
            # router drain: sheds, then exits 75
            router.begin_drain()
            out = collect_stream(router.url, {"prompt": [1],
                                              "max_new_tokens": 2})
            assert out["status"] == 503
            assert json.loads(out["shed_body"])["reason"] == "draining"
            assert router.wait(10) == PREEMPT_EXIT_CODE
        finally:
            router.stop()
            for fe in fes:
                fe._teardown()


# -- lock-discipline regressions -------------------------------------------

class TestLockDiscipline:
    """Regressions for the races the graftlint lock pass surfaced (see
    ANALYSIS.md): the router's inflight gauge and replica-state
    snapshot, and the frontend's drain accounting."""

    def test_router_inflight_gauge_matches_count_under_contention(self):
        # Never started: _track_inflight is pure accounting, no I/O.
        router = Router(["http://127.0.0.1:9"])

        def churn():
            for _ in range(300):
                router._track_inflight(+1)
                router._track_inflight(-1)

        threads = [threading.Thread(target=churn) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # The old code re-read the count outside the lock before setting
        # the gauge, so crossing requests could leave it nonzero forever.
        assert router._inflight == 0
        assert router._m_inflight.value == 0.0

    def test_plan_route_snapshot_survives_scrape_churn(self):
        router = Router([f"http://127.0.0.1:{p}" for p in (7, 8, 9)])
        stop = threading.Event()

        def churn():     # stands in for the scrape loop's publishes
            flip = False
            while not stop.is_set():
                flip = not flip
                with router._lock:
                    for i, r in enumerate(router.replicas):
                        r.ready = flip or i == 0
                        r.hit_rate = 0.9 if flip else 0.1
                        r.queue_depth = float(i)

        t = threading.Thread(target=churn)
        t.start()
        try:
            primary = router.replicas[prefix_shard([1, 2, 3], 3)]
            for _ in range(500):
                plan = router.plan_route([1, 2, 3])
                ids = [id(r) for r in plan]
                assert id(primary) in ids       # sticky primary always tried
                assert len(ids) == len(set(ids))
                assert set(ids) <= {id(r) for r in router.replicas}
        finally:
            stop.set()
            t.join()

    def test_drain_finished_waits_for_open_streams(self, model_and_vars):
        # Not started: _drain_finished is pure accounting over the
        # engine scheduler and the handler counters.
        model, variables = model_and_vars
        fe = _frontend(model, variables)
        fe._drain_started = time.monotonic()
        with fe._lock:
            fe._open_streams = 1    # a handler mid final write
        assert not fe._drain_finished()
        with fe._lock:
            fe._open_streams = 0
        assert fe._drain_finished()
        # past the deadline an open stream no longer blocks the exit
        with fe._lock:
            fe._open_streams = 1
        fe._drain_started = time.monotonic() - fe.drain_deadline_s - 1.0
        assert fe._drain_finished()


# -- subprocess smoke (the tier-1 end-to-end) ------------------------------

class TestReplicaProcess:
    def test_replica_streams_scrapes_and_drains_on_sigterm(self):
        """Boot a real replica process on an ephemeral port, stream one
        SSE completion, scrape /metrics and /slo, then SIGTERM it with
        a stream in flight: the stream must end with [DONE] (zero
        truncated streams) and the process must exit 75."""
        # one intra-op thread: beside the suite's other workers, torch's
        # default pool oversubscribes the cores and a tiny decode step
        # takes ~0.5 s instead of ~3 ms
        env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.serve.replica",
             "--device", "cpu",
             "--port", "0", "--drain-deadline-s", "20"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            env=env, text=True, cwd=REPO_ROOT)
        try:
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
            base = f"http://127.0.0.1:{port}"
            assert http_get(base + "/readyz")[0] == 200
            out = collect_stream(base, {"prompt": [5, 9, 2],
                                        "max_new_tokens": 8})
            assert out["status"] == 200 and out["done"]
            assert len(out["tokens"]) == 8
            vals = parse_prometheus_values(http_get(base + "/metrics")[1])
            assert vals['ptpu_serve_requests_total{reason="length"}'] == 1.0
            assert vals["ptpu_engine_compiles"] == 1.0
            slo = json.loads(http_get(base + "/slo")[1])
            assert slo["ok"] is True
            # SIGTERM with a stream in flight: drain, don't truncate
            s = stream_completion(base, {"prompt": [4, 4, 4, 4],
                                         "max_new_tokens": 40})
            it = s.events()
            next(it)
            proc.send_signal(signal.SIGTERM)
            tokens = [ev["token"] for ev in it if "token" in ev]
            assert s.done, "SIGTERM truncated an in-flight stream"
            assert len(tokens) == 39
            assert proc.wait(timeout=60) == PREEMPT_EXIT_CODE
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)


# -- the replica's device guards -------------------------------------------

class TestReplicaDevice:
    def test_no_card_needs_device_cpu(self, monkeypatch):
        """Without a card the replica never serves on the CPU unasked:
        build_frontend raises naming --device cpu, and main exits
        non-zero before binding a port."""
        from paddle_tpu_torch.serve import replica

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        a = replica.build_parser().parse_args(["--port", "0"])
        assert a.device == "cuda"
        with pytest.raises(RuntimeError, match="--device cpu"):
            replica.build_frontend(a)
        assert replica.main(["--port", "0"]) != 0
        fe = replica.build_frontend(replica.build_parser().parse_args(
            ["--port", "0", "--device", "cpu"]))
        assert fe.engine.device.type == "cpu"

    def test_tp_size_above_one_is_not_ported(self, monkeypatch):
        """(Named before tensor parallelism was ported; the name is kept
        so the test keeps its history.) --tp-size 2 --device cpu builds
        a tensor-parallel engine over two gloo ranks on the CPU; on the
        card, fewer cards than --tp-size exit non-zero naming the
        count."""
        from paddle_tpu_torch.serve import replica

        a = replica.build_parser().parse_args(
            ["--device", "cpu", "--tp-size", "2"])
        fe = replica.build_frontend(a)
        try:
            assert fe.engine.tp_size == 2
            assert fe.engine.tp_devices == [torch.device("cpu")] * 2
            assert fe.engine.tp_backend == "gloo"
        finally:
            fe.engine.close()
        assert fe.engine.worker_exit_codes == [0]
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        a = replica.build_parser().parse_args(["--tp-size", "2"])
        with pytest.raises(ValueError, match="needs 2 CUDA devices, have 1"):
            replica.serving_device(a)
        assert replica.main(["--port", "0", "--tp-size", "2"]) == 2


class TestWarmupFallback:
    def test_warmup_before_the_loop_generates_directly(self, model_and_vars):
        """warmup() with no engine loop yet takes the direct-generate
        branch on the calling thread: the compile gauge is restored from
        the program cache after the stats reset, /readyz holds, and the
        loop started afterwards serves the engine it warmed."""
        model, variables = model_and_vars
        fe = _frontend(model, variables, warmup=False)
        assert fe._engine_thread is None
        fe.warmup()
        assert fe.engine.steps == 0                 # the reset ran
        assert fe.engine.obs.get("ptpu_engine_compiles").value == 1.0
        assert fe.readiness() == (True, "")
        fe.start()
        try:
            reference = _engine(model, variables).generate(
                [[5, 9, 2, 7]], max_new_tokens=6)[0]
            out = collect_stream(fe.url, {"prompt": [5, 9, 2, 7],
                                          "max_new_tokens": 6})
            assert out["status"] == 200 and out["done"]
            assert out["tokens"] == reference
        finally:
            fe.stop()
