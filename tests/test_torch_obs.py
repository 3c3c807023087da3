"""The port's telemetry (paddle_tpu_torch/obs) against the JAX package's:
the tests of tests/test_obs.py that no other port test mirrors —
histogram quantiles, buckets, labels, registry semantics, counters,
reset, the Prometheus exposition, thread safety, snapshots, the scrape
server, the request tracer's lifecycle, the flight recorder,
`obs_response` and the engine's telemetry (on the port's CPU engine).

Where both packages compute a value from the same input, the port's is
held equal to JAX's: the same observations give the same quantiles, the
same registry renders the same exposition text, the same lifecycle
gives the same trace structure, the same traffic on the same weights
gives the same counters. (The tracer's fleet ids and federation are in
test_torch_obs_fleet.py; the event taps and verbosity in
test_torch_resilience.py.)
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from paddle_tpu_torch.obs import (MetricsRegistry, MetricsServer,
                                  RequestTracer, log_buckets,
                                  merged_chrome_trace)
from paddle_tpu_torch.obs.metrics import DEFAULT_BUCKETS

pytestmark = pytest.mark.obs

# one bucket's growth factor bounds the relative quantile error
GROWTH = 10 ** 0.1


# -- histogram quantiles vs numpy ------------------------------------------

def _hist_with(values, registry=MetricsRegistry):
    reg = registry()
    h = reg.histogram("t_lat_ms", "test latencies")
    for v in values:
        h.observe(float(v))
    return h


@pytest.mark.parametrize("dist,gen", [
    ("lognormal", lambda r: r.lognormal(mean=1.5, sigma=1.2, size=5000)),
    ("uniform", lambda r: r.uniform(0.5, 50.0, size=5000)),
    ("pareto_heavy_tail", lambda r: (r.pareto(1.5, size=5000) + 1) * 2.0),
    ("exponential", lambda r: r.exponential(8.0, size=5000)),
])
@pytest.mark.parametrize("q", [0.5, 0.9, 0.99])
def test_quantile_bounded_relative_error(dist, gen, q):
    rng = np.random.default_rng(7)
    values = gen(rng)
    h = _hist_with(values)
    exact = float(np.quantile(values, q))
    est = h.quantile(q)
    # promise: within one bucket's growth factor of the exact quantile
    assert exact / GROWTH <= est <= exact * GROWTH, \
        f"{dist} p{int(q * 100)}: est {est} vs exact {exact}"
    assert est == _hist_with(values, JaxRegistry).quantile(q)


def test_quantile_point_mass_is_exact():
    h = _hist_with([3.7] * 1000)
    for q in (0.0, 0.5, 0.99, 1.0):
        assert h.quantile(q) == pytest.approx(3.7)   # min/max clamp
    assert h.mean() == pytest.approx(3.7)


def test_quantile_bimodal_point_masses():
    # 99 at 1.0 and 1 at 1000.0: the median must sit on the low mode
    # and the max quantile on the high one
    vals = [1.0] * 99 + [1000.0]
    h, jh = _hist_with(vals), _hist_with(vals, JaxRegistry)
    assert h.quantile(0.5) == pytest.approx(1.0)
    assert h.quantile(1.0) == pytest.approx(1000.0)
    assert [h.quantile(q) for q in (0.1, 0.5, 0.95, 1.0)] == \
        [jh.quantile(q) for q in (0.1, 0.5, 0.95, 1.0)]


def test_quantile_outside_bucket_span_stays_in_range():
    vals = [2e-5, 5e-5, 8e-5]
    h = _hist_with(vals)
    for q in (0.1, 0.5, 0.9):
        assert min(vals) <= h.quantile(q) <= max(vals)
    big = [5e8, 6e8]                   # above the highest bound
    h2 = _hist_with(big)
    assert min(big) <= h2.quantile(0.5) <= max(big)


def test_quantile_empty_is_nan():
    h = _hist_with([])
    assert np.isnan(h.quantile(0.5))
    assert np.isnan(h.mean())


def test_log_buckets_layout():
    from paddle_tpu.obs.metrics import DEFAULT_BUCKETS as JAX_BUCKETS
    b = log_buckets(1e-3, 1e7, per_decade=10)
    assert b == DEFAULT_BUCKETS == JAX_BUCKETS
    assert len(b) == 101                       # 10 decades x 10 + 1
    assert b[0] == pytest.approx(1e-3)
    assert b[-1] == pytest.approx(1e7)
    ratios = [b[i + 1] / b[i] for i in range(len(b) - 1)]
    assert all(r == pytest.approx(GROWTH, rel=1e-9) for r in ratios)


# -- label sets and registry semantics -------------------------------------

def test_labels_identity_is_order_insensitive():
    reg = MetricsRegistry()
    c = reg.counter("t_req_total", "reqs", labelnames=("code", "route"))
    a = c.labels(code="200", route="/x")
    b = c.labels(route="/x", code="200")        # kwargs order irrelevant
    assert a is b
    assert c.labels(code="500", route="/x") is not a
    a.inc(2)
    assert c.labels(code="200", route="/x").value == 2
    assert c.total() == 2


def test_labels_schema_enforced():
    reg = MetricsRegistry()
    c = reg.counter("t_req_total", "reqs", labelnames=("code",))
    with pytest.raises(ValueError):
        c.labels(status="200")                  # wrong label name
    with pytest.raises(ValueError):
        c.labels()                              # missing label
    with pytest.raises(ValueError):
        c.inc()                                 # labelled family: no default


def test_registry_get_or_create_and_mismatch():
    reg = MetricsRegistry()
    g1 = reg.gauge("t_depth", "depth")
    assert reg.gauge("t_depth") is g1           # same family back
    with pytest.raises(ValueError):
        reg.counter("t_depth")                  # kind mismatch
    with pytest.raises(ValueError):
        reg.gauge("t_depth", labelnames=("x",))  # label-schema mismatch
    assert reg.get("t_depth") is g1
    assert reg.get("nope") is None


def test_counter_rejects_negative():
    reg = MetricsRegistry()
    c = reg.counter("t_n_total")
    with pytest.raises(ValueError):
        c.inc(-1)


def test_reset_zeroes_in_place():
    # instrumented code caches child handles; reset must zero THOSE,
    # not swap in fresh children behind their back
    reg = MetricsRegistry()
    c = reg.counter("t_n_total")
    h = reg.histogram("t_lat_ms")
    child = reg.counter("t_l_total", labelnames=("k",)).labels(k="a")
    c.inc(5)
    h.observe(1.0)
    child.inc(3)
    reg.reset()
    assert c.value == 0 and h.count == 0 and child.value == 0
    child.inc()                                 # old handle still live
    assert reg.get("t_l_total").labels(k="a").value == 1


# -- exposition golden test -------------------------------------------------

GOLDEN = """\
# HELP t_depth Depth
# TYPE t_depth gauge
t_depth 2
# HELP t_lat Latency
# TYPE t_lat histogram
t_lat_bucket{le="1"} 1
t_lat_bucket{le="10"} 2
t_lat_bucket{le="100"} 2
t_lat_bucket{le="+Inf"} 3
t_lat_sum 505.5
t_lat_count 3
# HELP t_req_total Requests
# TYPE t_req_total counter
t_req_total{code="200"} 3
t_req_total{code="500"} 1
"""


def _golden_registry(registry):
    reg = registry()
    c = reg.counter("t_req_total", "Requests", labelnames=("code",))
    c.labels(code="200").inc(3)
    c.labels(code="500").inc()
    reg.gauge("t_depth", "Depth").set(2)
    h = reg.histogram("t_lat", "Latency", buckets=[1, 10, 100])
    for v in (0.5, 5.0, 500.0):
        h.observe(v)
    return reg


def test_render_prometheus_golden():
    text = _golden_registry(MetricsRegistry).render_prometheus()
    assert text == GOLDEN
    assert text == _golden_registry(JaxRegistry).render_prometheus()


def test_exposition_escapes_label_values():
    texts = []
    for registry in (MetricsRegistry, JaxRegistry):
        reg = registry()
        reg.counter("t_e_total", labelnames=("p",)).labels(
            p='a"b\\c\nd').inc()
        texts.append(reg.render_prometheus())
    assert 't_e_total{p="a\\"b\\\\c\\nd"} 1' in texts[0]
    assert texts[0] == texts[1]


# -- thread safety ----------------------------------------------------------

def test_concurrent_increments_lose_nothing():
    reg = MetricsRegistry()
    c = reg.counter("t_n_total")
    h = reg.histogram("t_lat_ms")
    n_threads, per = 8, 5000

    def work():
        for _ in range(per):
            c.inc()
            h.observe(1.0)

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == n_threads * per
    assert h.count == n_threads * per
    assert h.sum == pytest.approx(n_threads * per)


# -- snapshot ---------------------------------------------------------------

def test_snapshot_and_emit(capsys):
    snaps = []
    for registry in (MetricsRegistry, JaxRegistry):
        reg = registry()
        reg.counter("t_n_total").inc(4)
        reg.histogram("t_lat_ms").observe(2.0)
        snaps.append(reg.snapshot())
    snap = snaps[0]
    assert snap == snaps[1]
    assert snap["t_n_total"] == 4
    assert snap["t_lat_ms"]["count"] == 1
    assert snap["t_lat_ms"]["p50"] == pytest.approx(2.0)
    capsys.readouterr()
    reg = MetricsRegistry()
    reg.counter("t_n_total").inc(4)
    rec = reg.emit_snapshot(reason="test")
    out = capsys.readouterr().out.strip().splitlines()
    line = [ln for ln in out if ln.startswith('{"evt": "obs_snapshot"')]
    assert len(line) == 1
    parsed = json.loads(line[0])
    assert parsed["metrics"]["t_n_total"] == 4
    assert parsed["reason"] == "test"
    assert "ts" in parsed and "seq" in parsed
    assert rec["evt"] == "obs_snapshot"


# -- scrape server ----------------------------------------------------------

def test_metrics_http_server():
    reg = MetricsRegistry()
    reg.counter("t_scrape_total").inc(7)
    with MetricsServer(reg, port=0) as srv:
        assert srv.port != 0                    # ephemeral port bound
        with urllib.request.urlopen(srv.url) as resp:
            assert resp.status == 200
            assert "0.0.4" in resp.headers["Content-Type"]
            body = resp.read().decode()
        assert "t_scrape_total 7" in body
        assert body == reg.render_prometheus()
        health = urllib.request.urlopen(
            f"http://{srv.host}:{srv.port}/healthz")
        assert health.read() == b"ok\n"
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://{srv.host}:{srv.port}/nope")
        assert ei.value.code == 404


# -- request tracer ---------------------------------------------------------

def _trace_one_lifecycle(tracer, rid, preempt=False):
    tracer.on_enqueue(rid)
    tracer.on_admit(rid)
    tracer.on_chunk(rid, 0, 16)
    if preempt:
        tracer.on_preempt(rid)
        tracer.on_admit(rid)
        tracer.on_chunk(rid, 0, 16)
    tracer.on_first_token(rid)
    tracer.on_finish(rid, reason="length")


def _untimed(trace):
    """A Chrome trace without its clock readings."""
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in trace["traceEvents"]]


def test_tracer_durations_and_phases():
    tr = RequestTracer()
    _trace_one_lifecycle(tr, 1)
    d = tr.durations_ms(1)
    assert set(d) == {"queued", "prefill", "decode"}
    assert all(v >= 0 for v in d.values())


def test_tracer_preemption_reenters_queued():
    from paddle_tpu.obs import RequestTracer as JaxTracer
    tr, jtr = RequestTracer(), JaxTracer()
    _trace_one_lifecycle(tr, 2, preempt=True)
    _trace_one_lifecycle(jtr, 2, preempt=True)
    trace = tr.to_chrome_trace()
    names = [e["name"] for e in trace["traceEvents"]
             if e.get("tid") == 2]
    assert names.count("queued") == 2           # initial + re-entry
    assert names.count("prefill") == 2
    assert "preempt" in names and "first_token" in names
    assert _untimed(trace) == _untimed(jtr.to_chrome_trace())


def test_tracer_bounded_retention():
    tr = RequestTracer(keep_last=2)
    for rid in range(5):
        _trace_one_lifecycle(tr, rid)
    assert tr.durations_ms(0) == {}             # evicted
    assert tr.durations_ms(4)                   # newest retained


def test_tracer_disabled_is_noop():
    tr = RequestTracer(enabled=False)
    _trace_one_lifecycle(tr, 1)
    assert tr.durations_ms(1) == {}
    assert len(tr.to_chrome_trace()["traceEvents"]) == 1  # process meta


# -- flight recorder + obs_response -----------------------------------------

def test_flightrec_ring_is_bounded(capsys):
    from paddle_tpu_torch.obs import FlightRecorder
    from paddle_tpu_torch.utils.log import obs_event, serve_event

    fr = FlightRecorder(capacity=3, streams=("serve",))
    with fr:
        for i in range(5):
            serve_event("t_evt", i=i)
        obs_event("t_other")                        # filtered stream
    ring = fr.ring()
    assert [r["i"] for r in ring] == [2, 3, 4]      # oldest dropped
    assert all(r["stream"] == "serve" for r in ring)
    serve_event("t_evt", i=99)                      # after uninstall
    assert [r["i"] for r in fr.ring()] == [2, 3, 4]


def test_flightrec_dump_bundle(tmp_path, capsys):
    from paddle_tpu.obs import FlightRecorder as JaxRecorder
    from paddle_tpu_torch.obs import FlightRecorder

    bundles = []
    for recorder, registry, sub in ((FlightRecorder, MetricsRegistry, "p"),
                                    (JaxRecorder, JaxRegistry, "j")):
        reg = registry()
        fr = recorder(capacity=8, snapshot_fn=lambda: {"queue": [1, 2]},
                      out_dir=str(tmp_path / sub), registry=reg)
        fr.record("serve", "breadcrumb", step=7)
        bundle = fr.dump("watchdog_hang", step=7)
        bundles.append(bundle)
        assert reg.get("ptpu_flightrec_dumps_total").labels(
            trigger="watchdog_hang").value == 1
        payload = fr.debug_payload()
        assert payload["last"]["trigger"] == "watchdog_hang"
        assert payload["dumps"] == [bundle["path"]]
    bundle = bundles[0]
    assert bundle["trigger"] == "watchdog_hang"
    assert bundle["context"] == {"step": 7}
    assert bundle["state"] == {"queue": [1, 2]}
    assert [e["evt"] for e in bundle["events"]] == ["breadcrumb"]
    with open(bundle["path"]) as f:
        on_disk = json.load(f)
    assert on_disk["trigger"] == "watchdog_hang"
    # the same bundle as JAX's, but for times, paths and the process
    skip = ("ts", "wall", "path", "pid", "host", "t", "time", "seq")
    assert ({k for k in bundle if k not in skip}
            == {k for k in bundles[1] if k not in skip})
    for key in ("trigger", "context", "state"):
        assert bundle[key] == bundles[1][key]


def test_flightrec_snapshot_error_is_captured(capsys):
    from paddle_tpu_torch.obs import FlightRecorder

    def boom():
        raise RuntimeError("wedged")

    bundle = FlightRecorder(snapshot_fn=boom).dump("slo_burn")
    assert bundle["state"] == {"snapshot_error": "RuntimeError('wedged')"}


def test_obs_response_prefix_routes():
    from paddle_tpu.obs import obs_response as jax_obs_response
    from paddle_tpu_torch.obs import obs_response

    reg = MetricsRegistry()

    def trace_route(path):
        return 200, "application/json", json.dumps({"path": path}).encode()

    status, _, body = obs_response("/trace/abc?x=1", reg,
                                   prefix_routes={"/trace/": trace_route})
    assert status == 200
    assert json.loads(body) == {"path": "/trace/abc"}  # query stripped
    assert obs_response("/nope", reg) is None
    jreg = JaxRegistry()
    for path in ("/metrics", "/healthz", "/readyz", "/trace/abc?x=1"):
        got = obs_response(path, reg, prefix_routes={"/trace/": trace_route})
        want = jax_obs_response(path, jreg,
                                prefix_routes={"/trace/": trace_route})
        assert got == want, path


# -- engine integration -----------------------------------------------------

VOCAB = 61
DIMS = dict(model_dim=16, num_heads=4, num_layers=2, ffn_dim=32)
ENGINE = dict(max_batch_size=4, block_size=4, num_blocks=64,
              max_prefill_tokens=8)
PROMPTS = [[5, 9, 2], [7, 1, 1, 3, 8], [4],
           [11, 12, 13, 14, 15, 16, 17, 18, 19, 20]]


def _serve(eng):
    outs = eng.generate(PROMPTS, max_new_tokens=6)
    # second wave on the SAME engine: any new step program would show
    # in the gauge
    eng.generate(PROMPTS[:2], max_new_tokens=4)
    return outs


@pytest.mark.serve
class TestEngineTelemetry:
    @pytest.fixture(scope="class")
    def served(self):
        import jax
        import jax.numpy as jnp

        from paddle_tpu.engine import ServeEngine as JaxServeEngine
        from paddle_tpu.models.transformer import CausalLM as JaxCausalLM
        from paddle_tpu_torch.engine import ServeEngine
        from paddle_tpu_torch.models import CausalLM, load_jax_params
        from paddle_tpu_torch.testing import causal_lm_tree

        tree = causal_lm_tree(0, VOCAB, **DIMS)
        model = CausalLM(VOCAB, dropout=0.0, max_len=64, device="cpu",
                         **DIMS)
        load_jax_params(model, tree)
        eng = ServeEngine(model, device="cpu", registry=MetricsRegistry(),
                          **ENGINE)
        outs = _serve(eng)
        jeng = JaxServeEngine(
            JaxCausalLM(VOCAB, dropout=0.0, max_len=64, **DIMS),
            jax.tree_util.tree_map(jnp.asarray, tree),
            registry=JaxRegistry(), **ENGINE)
        jouts = _serve(jeng)
        return eng, jeng, outs, jouts

    def test_latency_histograms_populated(self, served):
        eng, jeng, _, _ = served
        n = len(PROMPTS) + 2                    # both waves finished
        for name in ("ptpu_serve_ttft_ms", "ptpu_serve_e2e_ms",
                     "ptpu_serve_queue_wait_ms", "ptpu_serve_tpot_ms"):
            assert eng.obs.get(name).count == n == jeng.obs.get(name).count
        assert eng.obs.get("ptpu_serve_ttft_ms").quantile(0.5) > 0

    def test_compile_gauge_stays_one(self, served):
        eng, _, _, _ = served
        # one step program with metrics ON: host-side-only
        # instrumentation
        assert eng.obs.get("ptpu_engine_compiles").value == 1.0
        assert eng.obs.get("ptpu_serve_step_ms").total_count() > 0

    def test_request_and_token_counters(self, served):
        eng, jeng, outs, jouts = served
        assert outs == jouts                    # the same traffic
        reqs = eng.obs.get("ptpu_serve_requests_total")
        assert reqs.labels(reason="length").value == len(PROMPTS) + 2
        toks = eng.obs.get("ptpu_serve_tokens_total")
        assert toks.labels(kind="generated").value == \
            sum(len(o) for o in outs) + 2 * 4
        assert toks.labels(kind="prefill").value > 0
        jtoks = jeng.obs.get("ptpu_serve_tokens_total")
        for kind in ("generated", "prefill"):
            assert toks.labels(kind=kind).value == \
                jtoks.labels(kind=kind).value

    def test_cache_and_scheduler_gauges(self, served):
        eng, jeng, _, _ = served
        for name in ("ptpu_kv_occupancy", "ptpu_kv_hit_rate",
                     "ptpu_sched_queue_depth", "ptpu_sched_running"):
            assert eng.obs.get(name) is not None
            assert eng.obs.get(name).value == jeng.obs.get(name).value
        text = eng.metrics_text()
        assert "ptpu_kv_occupancy" in text
        assert "ptpu_serve_ttft_ms_bucket" in text

    def test_tracer_recorded_lifecycles(self, served):
        eng, _, _, _ = served
        rid = sorted(eng.finished)[-1]
        d = eng.tracer.durations_ms(rid)
        assert "prefill" in d and "decode" in d
        trace = merged_chrome_trace(eng.tracer)
        assert any(e.get("args", {}).get("name") == f"req {rid}"
                   for e in trace["traceEvents"])

    def test_private_registries_do_not_cross_pollute(self, served):
        eng, _, _, _ = served
        from paddle_tpu_torch.obs.metrics import default_registry
        # traffic on THIS engine must not advance the process-wide series
        assert eng.obs is not default_registry()

        def default_ttft_count():
            fam = default_registry().get("ptpu_serve_ttft_ms")
            return fam.count if fam is not None else 0

        before = default_ttft_count()
        n = eng.obs.get("ptpu_serve_ttft_ms").count
        eng.generate([[3, 4, 5]], max_new_tokens=3)
        assert eng.obs.get("ptpu_serve_ttft_ms").count == n + 1
        assert default_ttft_count() == before
