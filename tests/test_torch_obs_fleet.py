"""The port's fleet observability helpers against the JAX package's.

Mirrors the tracer and federation tests of tests/test_obs.py
(`:335-480`): `merged_chrome_trace`, the tracer's churn ordering and
fleet trace ids, `stitch_fragments` across processes, and the
`federate` / `counter_totals` / `histogram_buckets` federation of
replica expositions — and holds the port's outputs equal to JAX's on
the same inputs: the same expositions federate to the same text, and
the same fragments stitch (or a tracer merges) to the same trace.
"""

import json

import pytest

from paddle_tpu import obs as jax_obs
from paddle_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from paddle_tpu_torch.obs import (MetricsRegistry, RequestTracer,
                                  counter_totals, federate,
                                  histogram_buckets, merged_chrome_trace,
                                  stitch_fragments)

pytestmark = pytest.mark.obs


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


def test_merged_chrome_trace_structure(tmp_path):
    tr = RequestTracer()
    _trace_one_lifecycle(tr, 3)
    out = tmp_path / "trace.json"
    trace = merged_chrome_trace(tr, path=str(out))
    evs = trace["traceEvents"]
    # distinct pids per merged profile + thread_name metadata per request
    assert len({e["pid"] for e in evs}) >= 2
    metas = [e for e in evs if e["ph"] == "M"
             and e["name"] == "thread_name"]
    assert any(e["args"]["name"] == "req 3" for e in metas)
    assert json.loads(out.read_text())["traceEvents"]


def test_tracer_churn_span_ordering():
    # preemption re-entry keeps span rows in lifecycle order: queued,
    # prefill, queued (re-entry), prefill, decode — monotone starts
    tr = RequestTracer()
    _trace_one_lifecycle(tr, 7, preempt=True)
    spans = [e for e in tr.to_chrome_trace()["traceEvents"]
             if e["ph"] == "X" and e["tid"] == 7]
    assert [s["name"] for s in spans] == \
        ["queued", "prefill", "queued", "prefill", "decode"]
    ts = [s["ts"] for s in spans]
    assert ts == sorted(ts)


def test_tracer_trace_id_round_trip():
    tr = RequestTracer()
    tr.set_trace_id(1, "abc123")
    _trace_one_lifecycle(tr, 1)
    assert tr.trace_id_of(1) == "abc123"
    assert tr.request_of_trace("abc123") == 1
    frag = tr.trace_fragment("abc123")
    assert frag["trace_id"] == "abc123" and frag["req_id"] == 1
    spans = [e for e in frag["traceEvents"] if e["ph"] == "X"]
    assert spans and all(e["args"]["trace_id"] == "abc123" for e in spans)
    assert tr.trace_fragment("nope") is None


def test_tracer_eviction_drops_trace_ids():
    # the id maps stay bounded by keep_last exactly like the done deque
    tr = RequestTracer(keep_last=2)
    for rid in range(5):
        tr.set_trace_id(rid, f"tid{rid}")
        _trace_one_lifecycle(tr, rid)
    for evicted in ("tid0", "tid1", "tid2"):
        assert tr.request_of_trace(evicted) is None
        assert tr.trace_fragment(evicted) is None
    assert tr.request_of_trace("tid3") == 3
    assert tr.request_of_trace("tid4") == 4
    assert tr.trace_fragment("tid4")["req_id"] == 4


def test_merged_trace_thread_names_survive_churn():
    # one thread_name meta per RETAINED request, none for evicted ones
    tr = RequestTracer(keep_last=4)
    for rid in range(6):
        _trace_one_lifecycle(tr, rid, preempt=(rid % 2 == 0))
    trace = merged_chrome_trace(tr, include_host_spans=False)
    names = {e["args"]["name"] for e in trace["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert names == {f"req {r}" for r in range(2, 6)}


def _router_and_replica_fragments():
    router = RequestTracer(process_name="router")
    router.set_trace_id(1, "tid9")
    router.span_begin(1, "route")
    router.mark(1, "routed", replica="http://r0")
    router.span_begin(1, "relay")
    router.on_finish(1, "relayed")
    engine = RequestTracer(process_name="replica")
    engine.set_trace_id(42, "tid9")
    _trace_one_lifecycle(engine, 42)
    return [("router", router.trace_fragment("tid9")),
            ("replica http://r0", engine.trace_fragment("tid9"))]


def test_stitch_fragments_cross_process():
    merged = stitch_fragments(_router_and_replica_fragments(),
                              trace_id="tid9")
    assert merged["trace_id"] == "tid9"
    evs = merged["traceEvents"]
    spans = [e for e in evs if e["ph"] == "X"]
    assert len({e["pid"] for e in spans}) == 2      # one pid per process
    assert {"route", "relay", "queued", "prefill", "decode"} <= \
        {e["name"] for e in spans}
    assert {e["args"].get("trace_id") for e in spans} == {"tid9"}


def test_stitched_and_merged_traces_equal_jax():
    """The same fragments stitch to the same trace in both packages, and
    the same tracer merges to the same request rows."""
    frags = _router_and_replica_fragments()
    assert stitch_fragments(frags, trace_id="tid9") == \
        jax_obs.stitch_fragments(frags, trace_id="tid9")
    tr = RequestTracer(keep_last=4)
    for rid in range(6):
        _trace_one_lifecycle(tr, rid, preempt=(rid % 2 == 0))
    assert merged_chrome_trace(tr, include_host_spans=False) == \
        jax_obs.merged_chrome_trace(tr, include_host_spans=False)


# -- fleet federation --------------------------------------------------------

def _replica_exposition(reason_counts, latencies, registry=MetricsRegistry):
    reg = registry()
    c = reg.counter("t_req_total", "Requests", labelnames=("reason",))
    for reason, n in reason_counts.items():
        c.labels(reason=reason).inc(n)
    h = reg.histogram("t_lat_ms", "Latency")
    for v in latencies:
        h.observe(v)
    reg.gauge("t_occ", "Occupancy").set(0.5)
    return reg.render_prometheus()


def test_federate_counters_sum_exactly():
    a = _replica_exposition({"length": 3, "stop": 1}, [1.0, 10.0])
    b = _replica_exposition({"length": 2}, [100.0])
    fleet = federate({"http://r0": a, "http://r1": b})
    totals = counter_totals(fleet)
    assert totals["t_req_total"] == \
        counter_totals(a)["t_req_total"] + counter_totals(b)["t_req_total"]
    # per-label-set exactness, not just the family total
    assert 't_req_total{reason="length"} 5' in fleet
    assert 't_req_total{reason="stop"} 1' in fleet


def test_federate_histogram_buckets_merge_exactly():
    a = _replica_exposition({}, [0.5, 5.0, 50.0])
    b = _replica_exposition({}, [5.0, 5000.0])
    fleet = federate({"r0": a, "r1": b})
    fa = histogram_buckets(a, "t_lat_ms")
    fb = histogram_buckets(b, "t_lat_ms")
    merged = histogram_buckets(fleet, "t_lat_ms")
    assert set(merged) == set(fa) | set(fb)
    for le, v in merged.items():
        assert v == fa.get(le, 0.0) + fb.get(le, 0.0)
    assert merged["+Inf"] == 5.0                    # pooled count


def test_federate_gauges_get_replica_label():
    a = _replica_exposition({}, [])
    b = _replica_exposition({}, [])
    fleet = federate({"r0": a, "r1": b})
    assert 't_occ{replica="r0"} 0.5' in fleet
    assert 't_occ{replica="r1"} 0.5' in fleet


def test_federation_equals_jax():
    """Replica expositions rendered by either package's registry are the
    same text, and they federate to the same fleet body with the same
    counter totals and merged buckets."""
    counts = [({"length": 3, "stop": 1}, [0.5, 5.0, 50.0]),
              ({"length": 2, "cancelled": 4}, [5.0, 5000.0, 1e9])]
    port = {f"r{i}": _replica_exposition(*c) for i, c in enumerate(counts)}
    ref = {f"r{i}": _replica_exposition(*c, registry=JaxRegistry)
           for i, c in enumerate(counts)}
    assert port == ref
    fleet = federate(port)
    assert fleet == jax_obs.federate(ref)
    assert counter_totals(fleet) == jax_obs.counter_totals(fleet)
    assert histogram_buckets(fleet, "t_lat_ms") == \
        jax_obs.histogram_buckets(fleet, "t_lat_ms")
