"""The port's resilience layer (paddle_tpu_torch/resilience, the
resilience half of io/checkpoint.py, parallel/trainer.py's bad-step
guard): a mirror of tests/test_resilience.py — retry policy, checkpoint
integrity and corrupt-fallback, stale-marker hygiene, the bad-step
guard, supervisor signal/watchdog plumbing, structured recovery events.

`test_init_distributed_retries_rendezvous`'s counterpart is in
tests/test_torch_distributed.py, beside the rest of the port's
multi-process runtime.

The model is two torch.nn.Linear layers (the port has no MLP yet),
trained by the port's MeshTrainer on a CPU mesh."""

import json
import os
import signal
import time

import numpy as np
import pytest
import torch
from torch import nn

from paddle_tpu_torch.core import supervised_loss
from paddle_tpu_torch.io.checkpoint import (
    CheckpointIntegrityError, CheckpointManager, checkpoint_step,
    latest_checkpoint, list_checkpoints, load_checkpoint, save_checkpoint,
    verify_checkpoint)
from paddle_tpu_torch.optim import Adam
from paddle_tpu_torch.parallel import (DistStrategy, MeshConfig, MeshTrainer,
                                       ReduceStrategy, make_mesh)
from paddle_tpu_torch.resilience import chaos, shared_budget
from paddle_tpu_torch.resilience.errors import BadStepBudgetExceeded
from paddle_tpu_torch.resilience.retry import (
    RetryPolicy, backoff_delay, retry_call)
from paddle_tpu_torch.resilience.supervisor import RunSupervisor
from paddle_tpu_torch.utils.log import resilience_event
from paddle_tpu_torch.utils.tree import flatten_with_keys


@pytest.fixture(autouse=True)
def _clean_chaos(monkeypatch):
    monkeypatch.setenv("PTPU_RETRY_SCALE", "0")   # instantaneous retries
    chaos.reset()
    shared_budget().reset()
    yield
    chaos.reset()


def _events(capsys, evt=None):
    out = capsys.readouterr().out
    recs = [json.loads(l) for l in out.splitlines()
            if l.startswith('{"evt"')]
    return [r for r in recs if evt is None or r["evt"] == evt]


# -- retry ------------------------------------------------------------------

def test_retry_succeeds_after_transient_failures(capsys):
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    policy = RetryPolicy(attempts=3, retry_on=(OSError,))
    assert retry_call(flaky, policy=policy, name="t") == "ok"
    assert len(calls) == 3
    evts = _events(capsys, "retry")
    assert [e["attempt"] for e in evts] == [1, 2]
    assert all(e["site"] == "t" for e in evts)


def test_retry_budget_exhausted_reraises():
    def always():
        raise OSError("down")
    with pytest.raises(OSError, match="down"):
        retry_call(always, policy=RetryPolicy(attempts=2), name="t")


def test_retry_giveup_short_circuits():
    calls = []

    def deadline():
        calls.append(1)
        raise RuntimeError("DEADLINE_EXCEEDED: barrier timed out")

    policy = RetryPolicy(attempts=5, retry_on=(RuntimeError,),
                         giveup=lambda e: "deadline" in str(e).lower())
    with pytest.raises(RuntimeError):
        retry_call(deadline, policy=policy, name="b")
    assert len(calls) == 1


def test_retry_nonretryable_type_raises_immediately():
    calls = []

    def typed():
        calls.append(1)
        raise ValueError("not transient")
    with pytest.raises(ValueError):
        retry_call(typed, policy=RetryPolicy(attempts=5,
                                             retry_on=(OSError,)))
    assert len(calls) == 1


def test_backoff_is_deterministic_and_bounded(monkeypatch):
    monkeypatch.setenv("PTPU_RETRY_SCALE", "1")   # real delays for this one
    p = RetryPolicy(attempts=8, base_delay=0.25, max_delay=2.0)
    d = [backoff_delay(p, "site", k) for k in range(1, 8)]
    assert d[0] == 0.0                       # first try never waits
    assert d == [backoff_delay(p, "site", k) for k in range(1, 8)]
    assert all(x <= 2.0 * 1.25 for x in d)   # max_delay * (1 + jitter)
    assert backoff_delay(p, "site", 3) != backoff_delay(p, "other", 3)


# -- checkpoint integrity ---------------------------------------------------

def _tree(seed=0):
    rs = np.random.RandomState(seed)
    return {"w": rs.randn(8, 4).astype(np.float32),
            "b": rs.randn(4).astype(np.float32)}


def test_manifest_records_per_shard_checksums(tmp_path):
    path = str(tmp_path / "ck")
    save_checkpoint(path, _tree(), step=7)
    manifest = verify_checkpoint(path)
    assert manifest["step"] == 7
    files = manifest["files"]
    assert "shards-p0.npz" in files and "shard_index-p0.json" in files
    for meta in files.values():
        assert meta["bytes"] > 0 and isinstance(meta["crc32"], int)
    assert checkpoint_step(path) == 7


def test_truncated_shard_fails_verify_and_load(tmp_path):
    path = str(tmp_path / "ck")
    save_checkpoint(path, _tree(), step=1)
    chaos.corrupt_truncate_shard(path)
    with pytest.raises(CheckpointIntegrityError, match="corrupt"):
        verify_checkpoint(path)
    with pytest.raises(CheckpointIntegrityError, match="corrupt"):
        load_checkpoint(path, _tree())


def test_flipped_manifest_fails_verify(tmp_path):
    path = str(tmp_path / "ck")
    save_checkpoint(path, _tree(), step=1)
    chaos.corrupt_flip_manifest(path)
    with pytest.raises(CheckpointIntegrityError, match="manifest"):
        verify_checkpoint(path)


def test_restore_latest_falls_back_to_newest_intact(tmp_path, capsys):
    """Truncate one shard in the newest checkpoint and flip manifest
    bytes in the next; restore_latest returns the newest INTACT step and
    logs which checkpoints were rejected and why."""
    mgr = CheckpointManager(str(tmp_path), max_to_keep=5)
    trees = {s: _tree(s) for s in (1, 2, 3)}
    for s in (1, 2, 3):
        mgr.save(trees[s], step=s)
    chaos.corrupt_truncate_shard(str(tmp_path / "ckpt-3"))
    chaos.corrupt_flip_manifest(str(tmp_path / "ckpt-2"))

    restored, step = mgr.restore_latest(_tree(99))
    assert step == 1
    np.testing.assert_array_equal(restored["w"], trees[1]["w"])

    rejects = _events(capsys, "ckpt_reject")
    assert [r["ckpt"] for r in rejects] == ["ckpt-3", "ckpt-2"]
    assert "corrupt" in rejects[0]["reason"]
    assert "JSON" in rejects[1]["reason"] or "manifest" in rejects[1]["reason"]


def test_restore_latest_none_when_all_corrupt(tmp_path, capsys):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=5)
    mgr.save(_tree(), step=1)
    chaos.corrupt_truncate_shard(str(tmp_path / "ckpt-1"))
    restored, step = mgr.restore_latest(_tree())
    assert restored is None and step is None
    assert len(_events(capsys, "ckpt_reject")) == 1


def test_latest_checkpoint_skips_ptmp_and_manifestless(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=5)
    mgr.save(_tree(), step=2)
    # an uncommitted staging dir from a crashed save and a torn dir
    # whose manifest never landed: neither is offered for restore
    os.makedirs(str(tmp_path / "ckpt-9.ptmp"))
    os.makedirs(str(tmp_path / "ckpt-8"))
    assert latest_checkpoint(str(tmp_path)).endswith("ckpt-2")
    assert [s for s, _ in list_checkpoints(str(tmp_path))] == [2]


def test_manager_init_clears_stale_failure_markers(tmp_path):
    """A failure marker left by a previous crashed run must not poison
    this run's first save to the same path."""
    marker = tmp_path / "ckpt-5.err-p1"
    marker.write_text("OSError: disk full (from a previous life)")
    mgr = CheckpointManager(str(tmp_path), max_to_keep=5)
    assert not marker.exists()
    mgr.save(_tree(), step=5)
    restored, step = mgr.restore_latest(_tree())
    assert step == 5


def test_version1_checkpoint_still_loads(tmp_path):
    """Read-compat: v1 single-npz checkpoints predate checksums and
    must keep loading (and verifying on existence alone)."""
    path = tmp_path / "v1"
    path.mkdir()
    tree = _tree()
    np.savez(str(path / "arrays.npz"),
             **{f"a{i}": v for i, v in enumerate([tree["b"], tree["w"]])})
    leaves = [{"key": "b", "shape": [4], "dtype": "float32", "slot": "a0"},
              {"key": "w", "shape": [8, 4], "dtype": "float32",
               "slot": "a1"}]
    with open(str(path / "manifest.json"), "w") as f:
        json.dump({"version": 1, "step": 3, "leaves": leaves}, f)
    verify_checkpoint(str(path))
    out = load_checkpoint(str(path))
    np.testing.assert_array_equal(out["w"], tree["w"])


def test_ckpt_write_retry_under_injected_io_errors(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.setenv("PTPU_CHAOS_CKPT_IO", "2")
    chaos.reload()
    path = str(tmp_path / "ck")
    save_checkpoint(path, _tree(), step=1)      # retries absorb 2 faults
    verify_checkpoint(path)
    assert len(_events(capsys, "retry")) == 2


def test_ckpt_read_retry_under_injected_io_errors(tmp_path, monkeypatch,
                                                  capsys):
    path = str(tmp_path / "ck")
    save_checkpoint(path, _tree(), step=1)
    monkeypatch.setenv("PTPU_CHAOS_CKPT_READ", "1")
    chaos.reload()
    out = load_checkpoint(path, _tree())
    np.testing.assert_array_equal(out["w"], _tree()["w"])
    assert len(_events(capsys, "retry")) == 1


# -- bad-step guard ---------------------------------------------------------

class _MLP(nn.Module):
    """6 -> 8 -> 4, ReLU: the JAX tests' MLP(hidden=(8,), 4)."""

    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(6, 8)
        self.fc2 = nn.Linear(8, 4)

    def forward(self, x, generator=None):
        return self.fc2(torch.relu(self.fc1(x)))


def _mesh_trainer(budget):
    torch.manual_seed(0)
    model = _MLP()
    loss_fn = supervised_loss(
        lambda lg, y: nn.functional.cross_entropy(lg, y, reduction="none"))
    return MeshTrainer(model, Adam(model.parameters(), 1e-2), loss_fn,
                       make_mesh(MeshConfig(dp=1), devices=["cpu"]),
                       strategy=DistStrategy(bad_step_budget=budget))


def _batch(step, poison=False):
    rs = np.random.RandomState(100 + step)
    x = rs.randn(16, 6).astype(np.float32)
    if poison:
        x = x * np.nan
    y = rs.randint(0, 4, 16).astype(np.int64)
    return torch.from_numpy(x), torch.from_numpy(y)


def _leaves(ts):
    return {k: v.detach().clone() for k, v in flatten_with_keys(ts)}


def test_bad_step_skips_update_and_reports(capsys):
    trainer = _mesh_trainer(budget=3)
    f0 = trainer.train_step(_batch(0))
    assert f0["bad_step"] is False
    before = _leaves(trainer.state())   # params, slots, both steps
    step_before = trainer.step

    f1 = trainer.train_step(_batch(1, poison=True))
    assert f1["bad_step"] is True
    after = _leaves(trainer.state())
    assert sorted(after) == sorted(before)
    for k in before:
        assert torch.equal(after[k], before[k]), k    # true no-op
    assert trainer.step == step_before
    assert trainer.optimizer.step_count == 1
    evts = _events(capsys, "bad_step_skip")
    assert len(evts) == 1 and evts[0]["consecutive"] == 1
    assert evts[0]["step"] == 1 and evts[0]["budget"] == 3

    # a good step afterwards resets the consecutive counter
    f2 = trainer.train_step(_batch(1))
    assert f2["bad_step"] is False
    assert trainer._consecutive_bad == 0


def test_bad_step_budget_exceeded_raises_with_state():
    trainer = _mesh_trainer(budget=2)
    trainer.train_step(_batch(0))
    good = _leaves(trainer.state())
    f = trainer.train_step(_batch(1, poison=True))
    assert f["bad_step"] is True
    with pytest.raises(BadStepBudgetExceeded) as e:
        trainer.train_step(_batch(1, poison=True))
    # the carried state, and the trainer's own, is still the last good one
    for ts in (e.value.state, trainer.state()):
        carried = _leaves(ts)
        for k in good:
            assert torch.equal(carried[k], good[k]), k
    assert e.value.budget == 2 and e.value.step == 1
    trainer.reset_bad_steps()
    assert trainer._consecutive_bad == 0


def test_guard_does_not_perturb_clean_training():
    """Guard on vs off over identical clean batches: identical losses
    (the isfinite check decides nothing on finite steps)."""
    t_on = _mesh_trainer(budget=3)
    t_off = _mesh_trainer(budget=None)
    for s in range(3):
        f_on = t_on.train_step(_batch(s))
        f_off = t_off.train_step(_batch(s))
        assert "bad_step" not in f_off
        assert float(f_on["loss"]) == float(f_off["loss"])
    on, off = _leaves(t_on.state()), _leaves(t_off.state())
    for k in off:
        assert torch.equal(on[k], off[k]), k


def test_guard_passes_a_large_finite_gradient():
    """A finite gradient whose norm overflows float32 is a good step:
    finiteness is decided elementwise, not from a norm."""
    trainer = _mesh_trainer(budget=1)
    x, y = _batch(0)
    f = trainer.train_step((x * 1e30, y))
    grads_norm = torch.stack([p.grad.norm() for p in
                              trainer.module.parameters()]).norm()
    assert f["bad_step"] is False and trainer.step == 1
    assert not torch.isfinite(grads_norm)


def test_guard_restores_persistent_buffers():
    """A bad step leaves the module's persistent buffers (BatchNorm's
    running statistics here) as they were before its forward pass."""
    torch.manual_seed(0)
    model = nn.Sequential(nn.Linear(6, 8), nn.BatchNorm1d(8),
                          nn.Linear(8, 4))

    def loss_fn(module, batch, generator, training):
        x, y = batch
        return nn.functional.cross_entropy(module(x), y), {}

    trainer = MeshTrainer(model, Adam(model.parameters(), 1e-2), loss_fn,
                          make_mesh(devices=["cpu"]),
                          strategy=DistStrategy(bad_step_budget=3))
    trainer.train_step(_batch(0))
    before = _leaves(trainer.state())
    assert any(k.startswith("1/") for k in before)
    assert trainer.train_step(_batch(1, poison=True))["bad_step"] is True
    after = _leaves(trainer.state())
    for k in before:
        assert torch.equal(after[k], before[k]), k


def _trainer_with(strategy):
    torch.manual_seed(0)
    model = _MLP()
    loss_fn = supervised_loss(
        lambda lg, y: nn.functional.cross_entropy(lg, y, reduction="none"))
    return MeshTrainer(model, Adam(model.parameters(), 1e-2), loss_fn,
                       make_mesh(devices=["cpu"]), strategy=strategy)


def test_gradient_accumulation_averages_microbatches():
    """Two microbatches of 8: the loss is their mean, and the update is
    the full batch's up to float32 rounding (the mean of the halves'
    mean gradients is the whole batch's mean gradient)."""
    whole = _trainer_with(DistStrategy())
    micro = _trainer_with(DistStrategy(gradient_accumulation_steps=2))
    x, y = _batch(0)
    with torch.no_grad():
        halves = [float(nn.functional.cross_entropy(
            micro.module(x[i:i + 8]), y[i:i + 8])) for i in (0, 8)]
    f_whole = whole.train_step((x, y))
    f_micro = micro.train_step((x, y))
    assert float(f_micro["loss"]) == pytest.approx(np.mean(halves),
                                                   rel=1e-6)
    assert float(f_micro["loss"]) == pytest.approx(float(f_whole["loss"]),
                                                   rel=1e-6)
    got, want = _leaves(micro.state()), _leaves(whole.state())
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="does not split"):
        micro.train_step((x[:7], y[:7]))


def test_power_of_two_loss_scale_is_exact():
    """Scaling the loss by 2**10 and each gradient back is exact in
    float32: the same bits as an unscaled run."""
    plain = _trainer_with(DistStrategy(bad_step_budget=2))
    scaled = _trainer_with(DistStrategy(bad_step_budget=2,
                                        loss_scale=1024.0))
    for s in range(2):
        assert (float(plain.train_step(_batch(s))["loss"])
                == float(scaled.train_step(_batch(s))["loss"]))
    got = _leaves(scaled.state())
    for k, v in _leaves(plain.state()).items():
        assert torch.equal(got[k], v), k


def test_strategy_knobs_the_port_cannot_honour_raise():
    model = _MLP()
    mesh = make_mesh(devices=["cpu"])
    for st in (DistStrategy(reduce_strategy=ReduceStrategy.REDUCE),
               DistStrategy(sequence_axis="sp"), DistStrategy(remat=True)):
        with pytest.raises(NotImplementedError, match="item 10"):
            MeshTrainer(model, Adam(model.parameters(), 1e-2),
                        lambda *a: None, mesh, strategy=st)
    with pytest.raises(NotImplementedError, match="item 10"):
        make_mesh(dp=2, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="needs 1 devices"):
        make_mesh(devices=["cpu", "cpu"])


def test_card_defaults_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the defaults resolve to it")
    from paddle_tpu_torch.obs import DeviceMemoryMonitor
    model = _MLP()
    for make in (make_mesh, DeviceMemoryMonitor,
                 lambda: MeshTrainer(model, Adam(model.parameters(), 1e-2),
                                     lambda *a: None)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()


# -- supervisor -------------------------------------------------------------

def test_supervisor_defers_signal_and_emergency_checkpoints(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    exits = []
    sup = RunSupervisor(mgr, _exit_fn=exits.append)
    tree = _tree()
    with sup:
        os.kill(os.getpid(), signal.SIGINT)
        time.sleep(0.05)                     # let the handler run
        assert sup.preempted == signal.SIGINT
        sup.maybe_preempt_exit(tree, step=4)
    assert exits == [sup.exit_code]
    assert checkpoint_step(latest_checkpoint(str(tmp_path))) == 4
    restored, step = mgr.restore_latest(_tree())
    assert step == 4
    np.testing.assert_array_equal(restored["w"], tree["w"])


def test_supervisor_skips_emergency_save_when_step_committed(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    mgr.save(_tree(), step=4)
    exits = []
    sup = RunSupervisor(mgr, _exit_fn=exits.append)
    with sup:
        os.kill(os.getpid(), signal.SIGINT)
        time.sleep(0.05)
        sup.maybe_preempt_exit(_tree(1), step=4)
    assert exits == [sup.exit_code]
    # the pre-existing ckpt-4 was kept, not overwritten with _tree(1)
    restored, _ = mgr.restore_latest(_tree())
    np.testing.assert_array_equal(restored["w"], _tree()["w"])


def test_supervisor_restores_handlers_on_exit():
    before = signal.getsignal(signal.SIGTERM)
    with RunSupervisor(None):
        assert signal.getsignal(signal.SIGTERM) != before
    assert signal.getsignal(signal.SIGTERM) == before


def test_watchdog_flags_hung_step(capsys):
    sup = RunSupervisor(None, watchdog_timeout_s=0.1)
    with sup:
        with sup.watch_step(7):
            time.sleep(0.4)
    assert 7 in sup.hung_steps
    evts = _events(capsys, "hang")
    assert evts and evts[0]["step"] == 7


def test_preempt_without_signal_is_noop(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    exits = []
    sup = RunSupervisor(mgr, _exit_fn=exits.append)
    with sup:
        sup.maybe_preempt_exit(_tree(), step=1)
    assert exits == [] and latest_checkpoint(str(tmp_path)) is None


# -- event stream -----------------------------------------------------------

def test_resilience_event_is_single_line_json(capsys):
    rec = resilience_event("rollback", from_step=9, to_step=6)
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    parsed = json.loads(out[0])
    # every record carries a monotonic ts and a per-stream seq (stamped
    # after the caller's fields, so the '{"evt": ...' prefix holds)
    assert isinstance(parsed.pop("ts"), float)
    assert isinstance(parsed.pop("seq"), int)
    assert parsed == {"evt": "rollback", "from_step": 9, "to_step": 6}
    assert rec["evt"] == "rollback"
    assert out[0].startswith('{"evt": "rollback"')


def test_event_seq_is_per_stream_and_gap_free(capsys):
    from paddle_tpu_torch.utils.log import serve_event
    a = resilience_event("retry", site="x", attempt=1)
    s1 = serve_event("serve_admit", queue_depth=0)
    b = resilience_event("retry", site="x", attempt=2)
    s2 = serve_event("serve_admit", queue_depth=1)
    # each stream's counter is gap-free and independent of the other's
    assert b["seq"] == a["seq"] + 1
    assert s2["seq"] == s1["seq"] + 1
    assert b["ts"] >= a["ts"]                # monotonic within a stream
    capsys.readouterr()


def test_event_taps_see_every_stream_and_survive_a_broken_tap(capsys):
    from paddle_tpu_torch.utils.log import (add_event_tap, obs_event,
                                            remove_event_tap)
    seen = []

    def broken(stream, rec):
        raise RuntimeError("tap bug")

    def tap(stream, rec):
        seen.append((stream, rec["evt"]))

    add_event_tap(broken)
    add_event_tap(tap)
    try:
        resilience_event("retry", site="x", attempt=1)
        obs_event("obs_snapshot")
    finally:
        remove_event_tap(broken)
        remove_event_tap(tap)
    remove_event_tap(broken)                 # unknown taps are ignored
    assert seen == [("resilience", "retry"), ("obs", "obs_snapshot")]
    capsys.readouterr()


def test_verbosity_is_read_per_call(monkeypatch):
    from paddle_tpu_torch.utils.log import get_verbosity, set_verbosity
    monkeypatch.setenv("FLAGS_v", "2")
    assert get_verbosity() == 2
    prev = set_verbosity(5)
    try:
        assert get_verbosity() == 5
    finally:
        set_verbosity(prev)
    monkeypatch.setenv("FLAGS_v", "0")
    assert get_verbosity() == 0


# -- retry budget + full jitter (a mirror of test_fleet_ft.py:58-107) --------

def _counter_value(registry, name, **labels):
    fam = registry.get(name)
    if fam is None:
        return 0.0
    child = fam.labels(**labels) if labels else fam
    return child.value


class TestRetryBudget:
    def test_spend_deposit_and_denial_metric(self):
        from paddle_tpu_torch.obs.metrics import MetricsRegistry
        from paddle_tpu_torch.resilience import RetryBudget
        reg = MetricsRegistry()
        b = RetryBudget(ratio=0.5, burst=2.0, registry=reg)
        assert b.try_spend("t") and b.try_spend("t")
        assert not b.try_spend("t")          # bucket empty
        assert _counter_value(
            reg, "ptpu_resilience_retry_budget_denied_total", site="t") == 1.0
        b.note_success(3)                    # deposits ratio * n = 1.5
        assert b.tokens() == pytest.approx(1.5)
        assert b.try_spend("t")
        b.note_success(100)                  # capped at burst
        assert b.tokens() == 2.0

    def test_full_jitter_deterministic_and_bounded(self, monkeypatch):
        monkeypatch.setenv("PTPU_RETRY_SCALE", "1")  # real delays here
        spread = RetryPolicy(attempts=5, base_delay=1.0, max_delay=60.0,
                             full_jitter=True)
        plain = RetryPolicy(attempts=5, base_delay=1.0, max_delay=60.0,
                            jitter_frac=0.0)
        for attempt in (1, 2, 3, 4):
            raw = backoff_delay(plain, "x", attempt)
            d1 = backoff_delay(spread, "x", attempt)
            d2 = backoff_delay(spread, "x", attempt)
            assert d1 == d2                  # same (name, attempt) -> same u
            assert 0.0 <= d1 < raw or raw == 0.0
        # a different site decorrelates (the whole point of jitter)
        assert (backoff_delay(spread, "x", 2)
                != backoff_delay(spread, "y", 2))

    def test_retry_call_stops_when_budget_exhausted(self, capsys):
        from paddle_tpu_torch.resilience import RetryBudget
        b = RetryBudget(ratio=0.1, burst=0.0)     # never a token
        calls = []

        def boom():
            calls.append(1)
            raise OSError("flap")

        policy = RetryPolicy(attempts=5, base_delay=0.001,
                             retry_on=(OSError,))
        with pytest.raises(OSError):
            retry_call(boom, policy=policy, name="budgeted", budget=b)
        assert len(calls) == 1               # no budget -> no retry storm
        assert [e["site"] for e in
                _events(capsys, "retry_budget_exhausted")] == ["budgeted"]

    def test_retry_call_deposits_on_success(self):
        from paddle_tpu_torch.resilience import RetryBudget
        b = RetryBudget(ratio=1.0, burst=4.0)
        while b.try_spend("drain"):
            pass
        retry_call(lambda: 42, policy=RetryPolicy(attempts=2),
                   name="ok", budget=b)
        assert b.tokens() == 1.0             # the success paid a token in
