"""The port's SLO monitor (paddle_tpu_torch/obs/slo.py): a mirror of
tests/test_slo.py — burn-rate math on synthetic timestamps, multi-window
gating, registry-reset resilience, conservative threshold bucketing,
verdict gauges and the /slo route — plus the same observations and
ticks through JAX's SLOMonitor giving the same verdicts.

No engine: the monitor reads ordinary registry histograms, so
everything here drives it with hand-placed observations and explicit
`tick(now=...)` timestamps (anchored near time.monotonic() because the
public verdict readers evaluate at the real clock).
"""

import json
import time

import pytest

from paddle_tpu_torch.obs.http import json_route, obs_response
from paddle_tpu_torch.obs.metrics import MetricsRegistry
from paddle_tpu_torch.obs.slo import (SLOMonitor, SLOObjective,
                                     default_objectives)

pytestmark = pytest.mark.obs


def _registry_with_ttft():
    reg = MetricsRegistry()
    hist = reg.histogram("ptpu_serve_ttft_ms", "test")
    return reg, hist


def _monitor(reg, threshold_ms=100.0, target=0.9, **kw):
    kw.setdefault("short_window_s", 5.0)
    kw.setdefault("long_window_s", 60.0)
    kw.setdefault("min_samples", 4)
    return SLOMonitor(
        reg, objectives=[SLOObjective("ttft", "ptpu_serve_ttft_ms",
                                      threshold_ms, target)], **kw)


class TestObjective:
    def test_validation(self):
        with pytest.raises(ValueError):
            SLOObjective("x", "m", 100.0, target=1.0)
        with pytest.raises(ValueError):
            SLOObjective("x", "m", 100.0, target=0.0)
        with pytest.raises(ValueError):
            SLOObjective("x", "m", 0.0)
        assert SLOObjective("x", "m", 1.0, target=0.99).budget == \
            pytest.approx(0.01)

    def test_default_objectives_cover_serve_histograms(self):
        objs = {o.name: o for o in default_objectives()}
        assert objs["ttft"].metric == "ptpu_serve_ttft_ms"
        assert objs["tpot"].metric == "ptpu_serve_tpot_ms"
        assert objs["queue_wait"].metric == "ptpu_serve_queue_wait_ms"

    def test_duplicate_objective_names_rejected(self):
        reg = MetricsRegistry()
        objs = [SLOObjective("a", "m1", 1.0), SLOObjective("a", "m2", 1.0)]
        with pytest.raises(ValueError):
            SLOMonitor(reg, objectives=objs)


class TestBurnMath:
    def test_burn_rate_exact(self):
        # 100 ms is an exact log-bucket bound (10^(20/10)), so the
        # good/bad split below is unambiguous: 5 good, 5 bad of 10,
        # budget 0.1 -> burn (0.5 / 0.1) = 5.0 in both windows
        reg, hist = _registry_with_ttft()
        mon = _monitor(reg, threshold_ms=100.0, target=0.9)
        t0 = time.monotonic()
        mon.tick(now=t0 - 6.0)                  # empty baseline
        for _ in range(5):
            hist.observe(50.0)
            hist.observe(500.0)
        mon.tick(now=t0)
        v = mon.verdict()
        st = v["objectives"]["ttft"]
        assert st["burn_short"] == pytest.approx(5.0)
        assert st["burn_long"] == pytest.approx(5.0)
        assert st["burning"] and not v["ok"]
        assert mon.burning("ttft") and mon.any_burning()
        assert mon.burning_objectives() == ["ttft"]

    def test_gauges_mirror_verdict(self):
        reg, hist = _registry_with_ttft()
        mon = _monitor(reg, threshold_ms=100.0, target=0.9)
        t0 = time.monotonic()
        mon.tick(now=t0 - 6.0)
        for _ in range(8):
            hist.observe(1000.0)                # all violating
        mon.tick(now=t0)
        g = reg.get("ptpu_slo_burn_rate")
        assert g.labels(objective="ttft", window="short").value == \
            pytest.approx(10.0)                 # 1.0 / 0.1
        assert reg.get("ptpu_slo_burning").labels(
            objective="ttft").value == 1.0
        assert reg.get("ptpu_slo_ok").value == 0.0
        assert reg.get("ptpu_slo_threshold_ms").labels(
            objective="ttft").value == 100.0

    def test_healthy_traffic_not_burning(self):
        reg, hist = _registry_with_ttft()
        mon = _monitor(reg, threshold_ms=100.0, target=0.9)
        t0 = time.monotonic()
        mon.tick(now=t0 - 6.0)
        for _ in range(50):
            hist.observe(10.0)
        hist.observe(5000.0)    # one straggler: 1/51 < 10% budget
        mon.tick(now=t0)
        assert not mon.any_burning()
        assert mon.verdict()["ok"]

    def test_min_samples_gate(self):
        # 2 violating observations on an idle replica: not an outage
        reg, hist = _registry_with_ttft()
        mon = _monitor(reg, threshold_ms=100.0, target=0.9, min_samples=4)
        t0 = time.monotonic()
        mon.tick(now=t0 - 6.0)
        hist.observe(5000.0)
        hist.observe(5000.0)
        mon.tick(now=t0)
        assert not mon.burning("ttft")

    def test_short_window_recovery(self):
        # burn, then a quiet short window: verdict recovers even though
        # the long window still remembers the violations
        reg, hist = _registry_with_ttft()
        mon = _monitor(reg, threshold_ms=100.0, target=0.9)
        t0 = time.monotonic()
        mon.tick(now=t0 - 30.0)
        for _ in range(10):
            hist.observe(5000.0)
        mon.tick(now=t0 - 20.0)
        assert mon._window_burn(mon.objectives[0], 5.0, t0 - 20.0)[0] > 1.0
        mon.tick(now=t0 - 6.0)                  # no new traffic
        mon.tick(now=t0)
        assert not mon.burning("ttft")          # short window drained

    def test_long_window_gates_short_blip(self):
        # short window burns but the long window (with plenty of good
        # history) stays under threshold -> no shed
        reg, hist = _registry_with_ttft()
        mon = _monitor(reg, threshold_ms=100.0, target=0.9,
                       long_window_s=120.0)
        t0 = time.monotonic()
        mon.tick(now=t0 - 100.0)
        for _ in range(500):
            hist.observe(10.0)                  # long good history
        mon.tick(now=t0 - 6.0)
        for _ in range(5):
            hist.observe(5000.0)                # recent blip
        mon.tick(now=t0)
        st = mon.verdict()["objectives"]["ttft"]
        assert st["burn_short"] >= 1.0
        assert st["burn_long"] < 1.0
        assert not st["burning"]

    def test_threshold_rounds_down_conservative(self):
        # 150 ms is not a bucket bound; the previous bound is ~125.9,
        # so a 140 ms observation counts as violating: strict, never
        # lenient
        reg, hist = _registry_with_ttft()
        mon = _monitor(reg, threshold_ms=150.0, target=0.5, min_samples=1)
        t0 = time.monotonic()
        mon.tick(now=t0 - 6.0)
        for _ in range(4):
            hist.observe(140.0)
        mon.tick(now=t0)
        st = mon.verdict()["objectives"]["ttft"]
        assert st["burn_short"] > 0.0

    def test_registry_reset_rewinds_history(self):
        # a warmup reset_stats() rewinds the cumulative counts; the
        # monitor must drop stale samples instead of computing negative
        # deltas
        reg, hist = _registry_with_ttft()
        mon = _monitor(reg, threshold_ms=100.0, target=0.9)
        t0 = time.monotonic()
        for _ in range(20):
            hist.observe(5000.0)
        mon.tick(now=t0 - 10.0)
        reg.reset()
        hist.observe(10.0)
        mon.tick(now=t0 - 4.0)
        mon.tick(now=t0)
        st = mon.verdict()["objectives"]["ttft"]
        assert st["burn_short"] >= 0.0
        assert not st["burning"]

    def test_missing_metric_is_quiet(self):
        reg = MetricsRegistry()
        mon = SLOMonitor(reg, objectives=[
            SLOObjective("ghost", "no_such_metric", 100.0)])
        mon.tick()
        assert not mon.any_burning()
        assert mon.verdict()["ok"]


class TestMonitorLifecycle:
    def test_window_validation(self):
        reg = MetricsRegistry()
        with pytest.raises(ValueError):
            SLOMonitor(reg, short_window_s=10.0, long_window_s=5.0)

    def test_interval_thread(self):
        reg, hist = _registry_with_ttft()
        with _monitor(reg).start(0.01) as mon:
            hist.observe(50.0)
            deadline = time.monotonic() + 2.0
            while (not mon._history["ttft"]
                   and time.monotonic() < deadline):
                time.sleep(0.01)
        assert mon._history["ttft"]             # ticked at least once
        assert mon._thread is None              # stopped cleanly

    def test_history_pruned_to_long_window(self):
        reg, hist = _registry_with_ttft()
        mon = _monitor(reg, short_window_s=1.0, long_window_s=5.0)
        t0 = time.monotonic()
        for i in range(100):
            hist.observe(10.0)
            mon.tick(now=t0 + i * 0.5)
        assert len(mon._history["ttft"]) < 20   # ~13 samples cover 6 s


class TestSLORoute:
    def test_slo_route_mounts(self):
        reg, hist = _registry_with_ttft()
        mon = _monitor(reg)
        hist.observe(10.0)
        mon.tick()
        routes = {"/slo": json_route(mon.verdict)}
        status, ctype, body = obs_response("/slo", reg, routes=routes)
        assert status == 200 and ctype == "application/json"
        v = json.loads(body)
        assert v["ok"] and "ttft" in v["objectives"]
        # the default surface still answers
        assert obs_response("/metrics", reg, routes=routes)[0] == 200
        assert obs_response("/nope", reg, routes=routes) is None

    def test_readyz_reflects_callback(self):
        reg = MetricsRegistry()
        ready = {"ok": False}

        def readiness():
            return ready["ok"], "warming"

        status, _, body = obs_response("/readyz", reg, readiness=readiness)
        assert status == 503 and b"warming" in body
        ready["ok"] = True
        assert obs_response("/readyz", reg, readiness=readiness)[0] == 200
        # liveness never consults readiness
        assert obs_response("/healthz", reg, readiness=readiness)[0] == 200


# -- the same inputs through JAX's monitor ----------------------------------

@pytest.mark.parametrize("values, target", [
    ([50.0, 500.0] * 5, 0.9),            # 50% bad: burning
    ([1000.0] * 8, 0.9),                 # all bad
    ([10.0] * 20 + [900.0], 0.99),       # one slow request in 21
    ([5.0, 7.0], 0.9)])                  # under min_samples
def test_verdicts_equal_jax(values, target):
    """The same observations and ticks through the port's monitor and
    JAX's give the same verdict and the same SLO gauges."""
    from paddle_tpu.obs.metrics import MetricsRegistry as JaxRegistry
    from paddle_tpu.obs.slo import SLOMonitor as JaxSLOMonitor
    from paddle_tpu.obs.slo import SLOObjective as JaxSLOObjective

    runs = []
    for reg_cls, mon_cls, obj_cls in (
            (MetricsRegistry, SLOMonitor, SLOObjective),
            (JaxRegistry, JaxSLOMonitor, JaxSLOObjective)):
        reg = reg_cls()
        hist = reg.histogram("ptpu_serve_ttft_ms", "test")
        mon = mon_cls(reg, objectives=[obj_cls(
            "ttft", "ptpu_serve_ttft_ms", 100.0, target)],
            short_window_s=5.0, long_window_s=60.0, min_samples=4)
        runs.append((reg, hist, mon))
    t0 = time.monotonic()
    for reg, hist, mon in runs:
        mon.tick(now=t0 - 6.0)
        for v in values:
            hist.observe(v)
        mon.tick(now=t0)
    (preg, _, pmon), (jreg, _, jmon) = runs
    assert pmon.verdict() == jmon.verdict()
    assert pmon.burning_objectives() == jmon.burning_objectives()
    assert preg.render_prometheus() == jreg.render_prometheus()
