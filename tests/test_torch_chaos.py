"""Fast chaos cells of the port (`chaos` marker): a mirror of
tests/test_chaos.py on paddle_tpu_torch. Each test arms PTPU_CHAOS_*
knobs and asserts the acceptance property — training completes AND the
loss curve matches the fault-free run bit-for-bit (fault schedules are
deterministic, batches are keyed by global step, the step only advances
on finite updates).

The model is two torch.nn.Linear layers (the port has no MLP yet),
trained by the port's MeshTrainer on a CPU mesh."""

import json
import threading
import time
from http.client import HTTPConnection
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch
from torch import nn

from paddle_tpu_torch.core import supervised_loss
from paddle_tpu_torch.io.checkpoint import (
    CheckpointManager, checkpoint_step, latest_checkpoint, list_checkpoints,
    verify_checkpoint)
from paddle_tpu_torch.optim import Adam
from paddle_tpu_torch.parallel import DistStrategy, MeshTrainer, make_mesh
from paddle_tpu_torch.resilience import chaos, shared_budget
from paddle_tpu_torch.resilience.chaos import NetChaosProxy
from paddle_tpu_torch.resilience.errors import PREEMPT_EXIT_CODE
from paddle_tpu_torch.resilience.supervisor import (RunSupervisor,
                                                    train_resilient)
from paddle_tpu_torch.utils.tree import flatten_with_keys

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


def _make(budget=None, seed=0):
    torch.manual_seed(seed)
    model = _MLP()
    loss_fn = supervised_loss(
        lambda lg, y: nn.functional.cross_entropy(lg, y, reduction="none"))
    return MeshTrainer(model, Adam(model.parameters(), 1e-2), loss_fn,
                       make_mesh(devices=["cpu"]),
                       strategy=DistStrategy(bad_step_budget=budget))


def _batch_for(step):
    rs = np.random.RandomState(1000 + step)
    x = torch.from_numpy(rs.randn(16, 6).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 4, 16).astype(np.int64))
    return x, y


def _run(tmp, steps=6, budget=None, save_every=1, trainer=None, **mgr_kw):
    """One train_resilient run from the newest checkpoint in `tmp` (or
    from scratch); returns (losses_by_step, trainer)."""
    if trainer is None:
        trainer = _make(budget)
    mgr = CheckpointManager(str(tmp), max_to_keep=mgr_kw.pop("keep", 10))
    restored, start = mgr.restore_latest(trainer.state())
    if restored is not None:
        trainer.load_state(restored)
    else:
        start = 0
    losses = {}
    train_resilient(
        trainer, _batch_for, steps, mgr, start_step=start,
        save_every=save_every,
        on_step=lambda s, f: losses.__setitem__(s, float(f["loss"])))
    return losses, trainer


def test_nan_burst_is_absorbed_bit_for_bit(tmp_path, monkeypatch):
    """A 2-step NaN burst. Each poisoned attempt is skipped and the same
    global step retries with the clean batch — the final curve equals
    the fault-free run exactly."""
    clean, _ = _run(tmp_path / "clean", budget=3)

    monkeypatch.setenv("PTPU_CHAOS_NAN_STEP", "2:3")   # burst at steps 2-3
    chaos.reload()
    chaotic, _ = _run(tmp_path / "chaos", budget=3)

    assert chaotic == clean                            # bit-for-bit


def test_nan_budget_blown_rolls_back_then_completes(tmp_path, monkeypatch,
                                                    capsys):
    """Three consecutive poisoned attempts against a budget of 2: the
    guard raises, train_resilient restores the newest checkpoint, the
    counter resets, the remaining attempt is absorbed as a plain skip
    and training still converges to the fault-free curve."""
    clean, t_clean = _run(tmp_path / "clean", budget=2)

    monkeypatch.setenv("PTPU_CHAOS_NAN_STEP", "3")
    monkeypatch.setenv("PTPU_CHAOS_NAN_ATTEMPTS", "3")
    chaos.reload()
    chaotic, t_chaos = _run(tmp_path / "chaos", budget=2)

    out = capsys.readouterr().out
    evts = [json.loads(l) for l in out.splitlines() if l.startswith('{"evt"')]
    rb = [e for e in evts if e["evt"] == "rollback"]
    assert len(rb) == 1 and rb[0]["from_step"] == 3 and rb[0]["to_step"] == 3
    skips = [e for e in evts if e["evt"] == "bad_step_skip"]
    assert [(e["step"], e["consecutive"]) for e in skips] == [
        (3, 1), (3, 2), (3, 1)]
    assert chaotic == clean
    got = dict(flatten_with_keys(t_chaos.state()))
    for k, want in flatten_with_keys(t_clean.state()):
        assert torch.equal(got[k], want), k


@pytest.mark.parametrize("mode", ["truncate", "manifest"])
def test_corrupted_latest_checkpoint_falls_back(tmp_path, monkeypatch, mode):
    """The newest checkpoint is torn right after it commits; a later
    restore must fall back to the newest INTACT one instead of
    aborting."""
    monkeypatch.setenv("PTPU_CHAOS_CORRUPT_STEP", "6")   # the final save
    monkeypatch.setenv("PTPU_CHAOS_CORRUPT_MODE", mode)
    chaos.reload()
    losses, _ = _run(tmp_path, steps=6, budget=None)
    assert sorted(losses) == list(range(6))              # run completed

    chaos.reset()
    monkeypatch.delenv("PTPU_CHAOS_CORRUPT_STEP")
    mgr = CheckpointManager(str(tmp_path), max_to_keep=10)
    restored, step = mgr.restore_latest(_make().state())
    assert step == 5                                     # newest intact
    assert restored is not None


def test_sigterm_preemption_in_process(tmp_path, monkeypatch):
    """SIGTERM at step 2 → emergency checkpoint at the step boundary,
    preemption exit code; a restart resumes at step 2 and the stitched
    curve equals the uninterrupted run."""
    clean, _ = _run(tmp_path / "clean", steps=6)

    monkeypatch.setenv("PTPU_CHAOS_SIGTERM_STEP", "2")
    chaos.reload()

    def _exit(code):
        raise SystemExit(code)

    trainer = _make()
    mgr = CheckpointManager(str(tmp_path / "chaos"), max_to_keep=10)
    losses = {}
    sup = RunSupervisor(mgr, _exit_fn=_exit)
    with pytest.raises(SystemExit) as e, sup:
        train_resilient(trainer, _batch_for, 6, mgr, start_step=0,
                        supervisor=sup,
                        on_step=lambda s, f: losses.__setitem__(
                            s, float(f["loss"])))
    assert e.value.code == PREEMPT_EXIT_CODE
    assert sorted(losses) == [0, 1]
    assert checkpoint_step(latest_checkpoint(str(tmp_path / "chaos"))) == 2

    # restart: no chaos; a trainer made anew resumes from the emergency
    # checkpoint
    chaos.reset()
    monkeypatch.delenv("PTPU_CHAOS_SIGTERM_STEP")
    resumed, _ = _run(tmp_path / "chaos", steps=6, trainer=_make(seed=7))
    assert sorted(resumed) == [2, 3, 4, 5]
    assert {**losses, **resumed} == clean


def test_transient_ckpt_io_faults_absorbed_by_retry(tmp_path, monkeypatch):
    """Two injected shard-write failures: the save-side retry absorbs
    them; every committed checkpoint verifies intact afterwards."""
    monkeypatch.setenv("PTPU_CHAOS_CKPT_IO", "2")
    chaos.reload()
    losses, _ = _run(tmp_path, steps=3)
    assert sorted(losses) == [0, 1, 2]
    ckpts = list_checkpoints(str(tmp_path))
    assert [s for s, _ in ckpts] == [3, 2, 1]
    for _, path in ckpts:
        verify_checkpoint(path)


def test_async_saves_under_chaos_match_sync_bit_for_bit(tmp_path,
                                                        monkeypatch):
    """The async manager's post-commit hook is the sync one: a NaN burst
    with async saves and a corrupted final checkpoint still gives the
    clean curve, and a restore falls back over the torn checkpoint."""
    clean, _ = _run(tmp_path / "clean", budget=3)
    monkeypatch.setenv("PTPU_CHAOS_NAN_STEP", "2:3")
    monkeypatch.setenv("PTPU_CHAOS_CORRUPT_STEP", "6")
    chaos.reload()
    trainer = _make(3)
    mgr = CheckpointManager(str(tmp_path / "async"), max_to_keep=10,
                            async_save=True)
    losses = {}
    train_resilient(trainer, _batch_for, 6, mgr,
                    on_step=lambda s, f: losses.__setitem__(
                        s, float(f["loss"])))
    assert losses == clean
    _, step = mgr.restore_latest(_make().state())
    assert step == 5


# -- wire-level chaos (a mirror of test_fleet_ft.py:110-200) ----------------

class _EchoHandler(BaseHTTPRequestHandler):
    BODY = b"x" * 4096

    def do_GET(self):                       # noqa: N802
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(self.BODY)))
        self.end_headers()
        self.wfile.write(self.BODY)

    def log_message(self, *args):
        pass


@pytest.fixture()
def upstream():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _EchoHandler)
    srv.daemon_threads = True
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()
    srv.server_close()


def _get_via(port, timeout=5.0):
    conn = HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", "/")
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


class TestNetChaosProxy:
    def test_refuse_then_heal_is_deterministic(self, upstream):
        with NetChaosProxy(upstream.server_address[1]) as proxy:
            proxy.arm("refuse", 2)
            for _ in range(2):
                with pytest.raises(OSError):
                    _get_via(proxy.port)
            # budget spent: connection 3 relays clean
            status, body = _get_via(proxy.port)
            assert status == 200 and body == _EchoHandler.BODY
            assert proxy.stats()["refuse"] == 2

    def test_injected_503_burst(self, upstream):
        with NetChaosProxy(upstream.server_address[1]) as proxy:
            proxy.arm("http_503", 1)
            status, body = _get_via(proxy.port)
            assert status == 503 and b"chaos" in body
            assert _get_via(proxy.port)[0] == 200

    def test_midstream_blackhole_truncates(self, upstream):
        with NetChaosProxy(upstream.server_address[1]) as proxy:
            proxy.blackhole_after = 64       # some bytes, then silence
            proxy.arm("blackhole", 1)
            conn = HTTPConnection("127.0.0.1", proxy.port, timeout=1.0)
            try:
                conn.request("GET", "/")
                with pytest.raises(OSError):
                    resp = conn.getresponse()       # headers may be cut
                    if resp.read() != _EchoHandler.BODY:
                        raise OSError("truncated")  # partial body = fault
            finally:
                conn.close()
            proxy.heal()
            assert _get_via(proxy.port)[0] == 200

    def test_slow_start_delays_first_byte(self, upstream):
        with NetChaosProxy(upstream.server_address[1]) as proxy:
            proxy.slow_ms = 300
            proxy.arm("slow", 1)
            t0 = time.monotonic()
            status, _ = _get_via(proxy.port)
            slow_elapsed = time.monotonic() - t0
            assert status == 200 and slow_elapsed >= 0.25
            t0 = time.monotonic()
            assert _get_via(proxy.port)[0] == 200
            assert time.monotonic() - t0 < slow_elapsed

    def test_budgets_load_from_the_env(self, upstream, monkeypatch):
        monkeypatch.setenv("PTPU_CHAOS_NET_5XX", "2")
        with NetChaosProxy(upstream.server_address[1]) as proxy:
            assert [_get_via(proxy.port)[0] for _ in range(3)] == [
                503, 503, 200]
            assert proxy.stats()["http_503"] == 2


# -- the other chaos knobs ---------------------------------------------------

def test_poison_batch_nanifies_floats_only(monkeypatch):
    monkeypatch.setenv("PTPU_CHAOS_NAN_STEP", "4")
    monkeypatch.setenv("PTPU_CHAOS_NAN_ATTEMPTS", "2")
    chaos.reload()
    batch = {"x": torch.ones(2, 3), "w": np.ones(3, np.float32),
             "tok": torch.arange(3), "ids": np.arange(3)}
    assert chaos.poison_batch(batch, 3) is batch          # outside the window
    for _ in range(2):
        out = chaos.poison_batch(batch, 4)
        assert torch.isnan(out["x"]).all() and np.isnan(out["w"]).all()
        assert out["tok"] is batch["tok"] and out["ids"] is batch["ids"]
    assert chaos.poison_batch(batch, 4) is batch          # budget spent


def test_maybe_corrupt_kvxfer_flips_the_first_n_blobs(monkeypatch):
    monkeypatch.setenv("PTPU_CHAOS_KVXFER_CORRUPT", "1")
    chaos.reload()
    blob = bytes(range(64))
    bad = chaos.maybe_corrupt_kvxfer(blob)
    assert len(bad) == len(blob) and bad != blob
    assert bad[:32] == blob[:32] and bad[40:] == blob[40:]
    assert chaos.maybe_corrupt_kvxfer(blob) == blob


def test_proc_index_reads_the_env_then_defaults_to_zero(monkeypatch):
    monkeypatch.setenv("PTPU_PROCESS_ID", "3")
    assert chaos._proc_index() == 3
    monkeypatch.delenv("PTPU_PROCESS_ID")
    assert chaos._proc_index() == 0       # no torch.distributed group
