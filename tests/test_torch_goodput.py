"""Training telemetry of the port: step-phase histograms, the goodput
ledger, MFU, device-memory sampling, hang and crash postmortems, and the
metrics scrape server — a mirror of the single-device cases of
tests/test_goodput.py on paddle_tpu_torch. The straggler cases wait for
the port's multi-worker training (obs/straggler.py, ROADMAP.md item 10).

The model is two torch.nn.Linear layers (the port has no MLP yet),
trained by the port's MeshTrainer on a CPU mesh."""

import json
import time
import urllib.request

import numpy as np
import pytest
import torch
from torch import nn

from paddle_tpu_torch.core import Trainer, supervised_loss
from paddle_tpu_torch.io.checkpoint import CheckpointManager
from paddle_tpu_torch.obs import MetricsServer, json_route
from paddle_tpu_torch.obs.devicemem import DeviceMemoryMonitor
from paddle_tpu_torch.obs.flightrec import FlightRecorder
from paddle_tpu_torch.obs.goodput import (
    GoodputLedger, MFUMeter, causal_lm_step_flops, param_count,
    resolve_peak_flops)
from paddle_tpu_torch.obs.metrics import MetricsRegistry
from paddle_tpu_torch.optim import Adam
from paddle_tpu_torch.parallel import DistStrategy, MeshTrainer, make_mesh
from paddle_tpu_torch.resilience import chaos, shared_budget
from paddle_tpu_torch.resilience.supervisor import (RunSupervisor,
                                                    train_resilient)
from paddle_tpu_torch.utils.log import add_event_tap, remove_event_tap

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _clean_chaos(monkeypatch):
    monkeypatch.setenv("PTPU_RETRY_SCALE", "0")
    chaos.reset()
    shared_budget().reset()
    yield
    chaos.reset()


class _MLP(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(6, 8)
        self.fc2 = nn.Linear(8, 4)

    def forward(self, x, generator=None):
        return self.fc2(torch.relu(self.fc1(x)))


def _loss_fn():
    return supervised_loss(
        lambda lg, y: nn.functional.cross_entropy(lg, y, reduction="none"))


def _make(budget=None):
    torch.manual_seed(0)
    model = _MLP()
    return MeshTrainer(model, Adam(model.parameters(), 1e-2), _loss_fn(),
                       make_mesh(devices=["cpu"]),
                       strategy=DistStrategy(bad_step_budget=budget))


def _batch_for(step):
    rs = np.random.RandomState(1000 + step)
    x = torch.from_numpy(rs.randn(16, 6).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 4, 16).astype(np.int64))
    return x, y


# -- step-phase profiling ----------------------------------------------------

def test_phase_histograms_and_compile_plateau(tmp_path):
    reg = MetricsRegistry()
    trainer = _make()
    mgr = CheckpointManager(str(tmp_path), max_to_keep=10)
    train_resilient(trainer, _batch_for, 5, mgr, registry=reg)

    step_h = reg.get("ptpu_train_step_ms")
    assert step_h is not None and step_h.count == 5
    phase = reg.get("ptpu_train_phase_ms")
    per_phase = {key[0]: child.count
                 for key, child in phase.children().items()}
    # dispatch + wait are timed inside train_step; h2d only on put_batch
    assert per_phase["dispatch"] == 5
    assert per_phase["wait"] == 5
    # one batch signature on a fixed stream: the gauge plateaus at 1
    assert reg.get("ptpu_train_compiles").value == 1
    assert reg.get("ptpu_train_steps_total").value == 5
    assert reg.get("ptpu_train_input_wait_ms").count == 5


def test_compile_gauge_counts_batch_signatures():
    reg = MetricsRegistry()
    trainer = _make()
    trainer.enable_metrics(reg)
    x, y = _batch_for(0)
    trainer.train_step((x, y))
    trainer.train_step(_batch_for(1))
    assert reg.get("ptpu_train_compiles").value == 1
    trainer.train_step((x[:8], y[:8]))          # a new shape: a new program
    assert reg.get("ptpu_train_compiles").value == 2


def test_put_batch_times_h2d_phase():
    reg = MetricsRegistry()
    trainer = _make()
    trainer.enable_metrics(reg)
    x, y = trainer.put_batch(tuple(t.numpy() for t in _batch_for(0)))
    assert isinstance(x, torch.Tensor) and x.dtype == torch.float32
    assert y.dtype == torch.int64
    phase = reg.get("ptpu_train_phase_ms")
    h2d = phase.labels(phase="h2d")
    assert h2d.count == 1 and h2d.sum >= 0.0


# -- goodput ledger ----------------------------------------------------------

def test_clean_run_goodput_near_one(tmp_path):
    reg = MetricsRegistry()
    gl = GoodputLedger(registry=reg)
    trainer = _make()
    mgr = CheckpointManager(str(tmp_path), max_to_keep=10)
    train_resilient(trainer, _batch_for, 5, mgr, save_every=0, goodput=gl)
    assert not gl.installed  # train_resilient owns install/uninstall
    assert gl.event_counts() == {}
    assert gl.goodput() > 0.95
    assert set(gl.lost_seconds()) <= {"checkpoint"}
    assert gl.productive_seconds() > 0


def test_chaos_goodput_reconciles_with_event_stream(tmp_path, monkeypatch):
    monkeypatch.setenv("PTPU_CHAOS_NAN_STEP", "3")
    monkeypatch.setenv("PTPU_CHAOS_NAN_ATTEMPTS", "3")
    chaos.reload()

    seen = {}

    def _count(stream, rec):
        if stream == "resilience":
            evt = rec["evt"]
            seen[evt] = seen.get(evt, 0) + 1

    add_event_tap(_count)
    reg = MetricsRegistry()
    gl = GoodputLedger(registry=reg)
    trainer = _make(budget=2)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=10)
    losses = {}
    try:
        train_resilient(
            trainer, _batch_for, 6, mgr, goodput=gl,
            on_step=lambda s, f: losses.__setitem__(s, float(f["loss"])))
    finally:
        remove_event_tap(_count)

    # the ledger is fed by the same tap hook: per-cause event counters
    # must reconcile EXACTLY with the stream the run printed
    assert gl.event_counts() == {k: float(v) for k, v in seen.items()}
    assert seen == {"chaos_inject": 3, "bad_step_skip": 3, "rollback": 1}

    lost = gl.lost_seconds()
    # skipped attempts and the rollback restore both surface as lost
    # time with their own cause; periodic saves as explicit pauses
    assert {"bad_step_skip", "rollback", "checkpoint"} <= set(lost)
    assert gl.goodput() < 1.0
    # goodput is by definition productive / (productive + all lost)
    p, l = gl.productive_seconds(), sum(lost.values())
    assert gl.goodput() == pytest.approx(p / (p + l))
    # and the run still converged on the fault-free curve's steps
    assert sorted(losses) == list(range(6))


def test_pause_and_attempt_windows_direct():
    reg = MetricsRegistry()
    gl = GoodputLedger(registry=reg)
    with gl.attempt():
        time.sleep(0.01)
    with gl.pause("checkpoint"):
        time.sleep(0.01)
    assert gl.productive_seconds() >= 0.01
    assert gl.lost_seconds()["checkpoint"] >= 0.01
    assert 0.0 < gl.goodput() < 1.0


# -- MFU / FLOPs accounting --------------------------------------------------

def test_causal_lm_step_flops_hand_count():
    # dense: 6 * (B*T) * params; attention: 6 * B * T^2 * D * L
    flops = causal_lm_step_flops(batch_size=2, seq_len=8, d_model=16,
                                 n_layers=2, n_params=1000)
    assert flops == 6 * 2 * 8 * 1000 + 6 * 2 * 64 * 16 * 2
    no_attn = causal_lm_step_flops(batch_size=2, seq_len=8, d_model=16,
                                   n_layers=2, n_params=1000,
                                   include_attention=False)
    assert no_attn == 6 * 2 * 8 * 1000


def test_param_count_matches_tree_leaves():
    params = {"w": torch.zeros((4, 3)), "b": np.zeros((3,))}
    assert param_count(params) == 15
    assert param_count(_MLP()) == 6 * 8 + 8 + 8 * 4 + 4


def test_mfu_meter_math_and_ema():
    reg = MetricsRegistry()
    m = MFUMeter(1e9, peak_flops=1e12, registry=reg)
    assert m.enabled
    assert m.observe_step(0.01) == pytest.approx(0.1)  # 1e9/(0.01*1e12)
    # EMA with alpha=0.25: 0.25*0.05 + 0.75*0.1
    assert m.observe_step(0.02) == pytest.approx(0.0875)
    assert reg.get("ptpu_train_mfu").value == pytest.approx(0.0875)


def test_mfu_absent_when_peak_unknown(monkeypatch):
    monkeypatch.delenv("PTPU_PEAK_FLOPS", raising=False)
    reg = MetricsRegistry()
    m = MFUMeter(1e9, registry=reg)  # CPU host: no peak table entry
    if resolve_peak_flops() is None:
        assert not m.enabled
        assert reg.get("ptpu_train_mfu") is None  # cleanly absent
        assert m.observe_step(0.01) is None


def test_peak_flops_env_override(monkeypatch):
    monkeypatch.setenv("PTPU_PEAK_FLOPS", "2.5e12")
    assert resolve_peak_flops() == 2.5e12
    monkeypatch.setenv("PTPU_PEAK_FLOPS", "not-a-number")
    # garbage override falls through to the card's table entry
    assert resolve_peak_flops() == resolve_peak_flops(16)


def test_peak_flops_table_is_the_h100_datasheet(monkeypatch):
    """The port's own table (not the TPU 'float32 = half of bf16' rule):
    dense bf16 on the tensor cores, float32 outside them."""
    from paddle_tpu_torch.obs.goodput import PEAK_FLOPS
    assert PEAK_FLOPS["NVIDIA H100 80GB HBM3"] == {16: 989.4e12,
                                                   32: 66.9e12}
    monkeypatch.delenv("PTPU_PEAK_FLOPS", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert resolve_peak_flops(32) == 66.9e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "other")
    assert resolve_peak_flops() is None


# -- device memory -----------------------------------------------------------

def test_device_memory_monitor_on_the_cpu():
    reg = MetricsRegistry()
    mon = DeviceMemoryMonitor(registry=reg, devices=["cpu"])
    keep = torch.zeros((256, 256))  # something live to account
    view = keep[:10]                # shares keep's storage: counted once
    out = mon.sample()
    assert isinstance(out, dict) and set(out) == {"d0"}
    in_use = reg.get("ptpu_hbm_bytes_in_use")
    peak = reg.get("ptpu_hbm_peak_bytes")
    for fam in (in_use, peak):
        assert fam is not None and fam.labelnames == ("device",)
    assert in_use.labels(device="d0").value >= keep.nbytes
    assert peak.labels(device="d0").value >= in_use.labels(device="d0").value
    # second sample never lowers the tracked peak
    first_peak = peak.labels(device="d0").value
    del keep, view
    mon.sample()
    assert peak.labels(device="d0").value >= first_peak
    assert not mon.allocator_backed


def test_live_bytes_count_each_storage_once():
    from paddle_tpu_torch.obs.devicemem import _live_bytes
    before = _live_bytes(torch.device("cpu"))
    keep = torch.zeros(1 << 20, dtype=torch.uint8)
    views = [keep[i:] for i in range(8)]
    grown = _live_bytes(torch.device("cpu")) - before
    assert (1 << 20) <= grown < 2 * (1 << 20)
    del keep, views


# -- hang and crash postmortems ----------------------------------------------

class _SlowFirstStep:
    """Delegating trainer whose FIRST train_step stalls long enough for
    the watchdog to flag it — the wedged-collective stand-in."""

    def __init__(self, inner, delay_s):
        self._inner = inner
        self._delay_s = delay_s
        self._stalled = False

    def state(self):
        return self._inner.state()

    def train_step(self, batch, generator=None):
        if not self._stalled:
            self._stalled = True
            time.sleep(self._delay_s)
        return self._inner.train_step(batch, generator=generator)


def test_watchdog_hang_dumps_flightrec_bundle(tmp_path):
    reg = MetricsRegistry()
    trainer = _make()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=10)
    rec = FlightRecorder(streams=("resilience", "obs"),
                         snapshot_fn=lambda: {"metrics": reg.snapshot()},
                         out_dir=str(tmp_path / "flightrec"), registry=reg)
    slow = _SlowFirstStep(trainer, delay_s=0.8)
    with RunSupervisor(mgr, watchdog_timeout_s=0.2) as sup:
        train_resilient(slow, _batch_for, 3, mgr, supervisor=sup,
                        registry=reg, flight_recorder=rec)
        assert sup.hung_steps == [0]
    paths = rec.dump_paths()
    assert len(paths) == 1
    with open(paths[0]) as f:
        bundle = json.load(f)
    # the bundle names the stuck step and carries the hang event +
    # a metrics snapshot frozen at dump time
    assert bundle["trigger"] == "watchdog_hang"
    assert bundle["context"]["step"] == 0
    assert bundle["context"]["elapsed_s"] >= 0.2
    assert any(e.get("evt") == "hang" and e.get("step") == 0
               for e in bundle["events"])
    assert "metrics" in bundle["state"]
    assert reg.get("ptpu_flightrec_dumps_total").labels(
        trigger="watchdog_hang").value == 1


def test_train_crash_dumps_flightrec_bundle(tmp_path):
    reg = MetricsRegistry()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=10)
    rec = FlightRecorder(streams=("resilience", "obs"),
                         out_dir=str(tmp_path / "flightrec"), registry=reg)

    class _Boom:
        def train_step(self, batch, generator=None):
            raise RuntimeError("the card went away")

    with pytest.raises(RuntimeError, match="the card went away"):
        train_resilient(_Boom(), _batch_for, 3, mgr, flight_recorder=rec)
    assert not rec.installed  # uninstalled on the way out
    bundle = rec.last_bundle()
    assert bundle["trigger"] == "train_crash"
    assert bundle["context"]["step"] == 0
    assert "the card went away" in bundle["context"]["error"]


def test_plain_trainer_runs_the_resilient_loop(tmp_path):
    """train_resilient over the port's plain `Trainer` (no guard, never a
    `bad_step` fetch) gives the guarded MeshTrainer's clean curve."""
    torch.manual_seed(0)
    model = _MLP()
    plain = Trainer(model, Adam(model.parameters(), 1e-2), _loss_fn())
    curves = []
    for i, trainer in enumerate((plain, _make(budget=2))):
        losses = {}
        train_resilient(trainer, _batch_for, 4,
                        CheckpointManager(str(tmp_path / str(i))),
                        on_step=lambda s, f, _l=losses: _l.__setitem__(
                            s, float(f["loss"])))
        curves.append(losses)
    assert curves[0] == curves[1] and sorted(curves[0]) == [0, 1, 2, 3]


# -- the scrape server -------------------------------------------------------

def test_metrics_server_serves_the_training_registry(tmp_path):
    reg = MetricsRegistry()
    gl = GoodputLedger(registry=reg)
    trainer = _make()
    mgr = CheckpointManager(str(tmp_path), max_to_keep=10)
    routes = {"/goodput": json_route(lambda: {"goodput": gl.goodput()})}
    with MetricsServer(reg, port=0, routes=routes,
                       readiness=lambda: (False, "warming")) as srv:
        train_resilient(trainer, _batch_for, 3, mgr, registry=reg,
                        goodput=gl, flops_per_step=1e6,
                        memory_monitor=DeviceMemoryMonitor(
                            registry=reg, devices=["cpu"]))
        body = urllib.request.urlopen(srv.url, timeout=10).read().decode()
        base = srv.url[:-len("/metrics")]
        health = urllib.request.urlopen(base + "/healthz", timeout=10)
        good = json.loads(urllib.request.urlopen(
            base + "/goodput", timeout=10).read())
        with pytest.raises(urllib.error.HTTPError) as ready:
            urllib.request.urlopen(base + "/readyz", timeout=10)
    assert health.status == 200 and ready.value.code == 503
    assert good["goodput"] == gl.goodput()
    for series in ('ptpu_train_phase_ms_bucket{phase="dispatch"',
                   "ptpu_train_step_ms_bucket", "ptpu_train_compiles 1",
                   "ptpu_train_steps_total 3", "ptpu_train_goodput",
                   'ptpu_hbm_bytes_in_use{device="d0"}',
                   "ptpu_train_input_wait_ms_bucket"):
        assert series in body, series
    if resolve_peak_flops() is None:
        assert "ptpu_train_mfu" not in body     # absent, not broken
