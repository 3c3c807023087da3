"""The port's executors and flags (paddle_tpu_torch/core/executor.py,
utils/flags.py): mirrors of the 6 tests of tests/test_executor.py, then
the NaN/Inf guard inside `Trainer.train_step`, `TrainState` views and
`load_state`, `NaiveExecutor`'s refusals and the flag registry's
environment override."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import (Executor, ExecutorError, NaiveExecutor,
                                   Trainer, TrainState, executor_cache_stats,
                                   host_step_of, supervised_loss)
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.optim import SGD, Adam
from paddle_tpu_torch.utils.flags import FLAGS, FlagRegistry
from paddle_tpu_torch.utils.tree import flatten_with_keys, unflatten_like


@pytest.fixture
def flags():
    saved = FLAGS.all()
    yield FLAGS
    for name in ("check_nan_inf", "executor_cache_capacity"):
        FLAGS.set(name, saved[name])


class MLP(torch.nn.Module):
    def __init__(self, dim=8, hidden=32, classes=4):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, classes)

    def forward(self, x, generator=None):
        return self.fc2(torch.relu(self.fc1(x)))


def _accuracy(logits, y):
    return (logits.argmax(-1) == y).float().mean()


def _make_trainer(seed=0, opt=Adam, lr=1e-2):
    torch.manual_seed(seed)
    model = MLP()
    loss_fn = supervised_loss(
        lambda logits, y: torch.nn.functional.cross_entropy(
            logits, y, reduction="none"), metrics={"acc": _accuracy})
    return Trainer(model, opt(model.parameters(), lr), loss_fn, seed=seed)


def _batches(n, bs=16, dim=8, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(dim, classes)
    for _ in range(n):
        x = rng.randn(bs, dim).astype(np.float32)
        y = np.argmax(x @ w + 0.1 * rng.randn(bs, classes), -1)
        yield torch.from_numpy(x), torch.from_numpy(y.astype(np.int64))


def test_executor_run_feed_fetch():
    exe = Executor("cpu")

    def program(x, y):
        return {"sum": x + y, "prod": x * y}

    out = exe.run(program, feed={"x": np.ones(4), "y": np.full(4, 2.0)},
                  fetch_list=["sum", "prod"])
    np.testing.assert_allclose(out[0], 3.0 * np.ones(4))
    np.testing.assert_allclose(out[1], 2.0 * np.ones(4))
    # the program cache: the same signature is a hit
    exe.run(program, feed={"x": np.zeros(4), "y": np.zeros(4)})
    assert exe.cache_misses == 1
    assert exe.cache_hits == 1
    with pytest.raises(ExecutorError, match="not produced"):
        exe.run(program, feed={"x": np.ones(4), "y": np.ones(4)},
                fetch_list=["diff"])
    with pytest.raises(ExecutorError, match="expected dict"):
        exe.run(lambda x: x, feed={"x": np.ones(2)}, fetch_list=["y"])


def test_executor_cache_lru_eviction(flags):
    flags.set("executor_cache_capacity", 2)
    exe = Executor("cpu")

    def program(x):
        return {"y": x + 1}

    for n in (1, 2, 3):  # three distinct signatures, capacity 2
        exe.run(program, feed={"x": np.ones(n)})
    assert exe.cache_misses == 3
    assert exe.cache_evictions == 1
    assert exe.cache_stats()["entries"] == 2
    # the evicted (oldest) signature misses again; the newest hits
    exe.run(program, feed={"x": np.ones(3)})
    assert exe.cache_hits == 1
    exe.run(program, feed={"x": np.ones(1)})
    assert exe.cache_misses == 4
    assert any(c["evictions"] >= 1 for c in executor_cache_stats())


def test_naive_executor():
    nex = NaiveExecutor(lambda x: x * 2, [np.ones((2, 2), np.float32)],
                        place="cpu")
    out = nex.run(torch.ones((2, 2)))
    np.testing.assert_allclose(out, 2.0)
    assert out.is_inference() and out.device == nex.place
    # numpy arguments are put on the place, as the examples were
    np.testing.assert_allclose(nex.run(np.ones((2, 2), np.float32)), 2.0)
    with pytest.raises(TypeError):
        nex.run(torch.ones((3, 2)))
    with pytest.raises(TypeError):
        nex.run(torch.ones((2, 2), dtype=torch.int32))


def test_trainer_learns():
    trainer = _make_trainer()
    first_loss = None
    for batch in _batches(60):
        fetches = trainer.train_step(batch)
        if first_loss is None:
            first_loss = float(fetches["loss"])
    assert trainer.step == 60 and host_step_of(trainer.state()) == 60
    assert float(fetches["loss"]) < first_loss * 0.7
    ev = trainer.eval_step(next(iter(_batches(1, seed=9))))
    assert 0.0 <= float(ev["acc"]) <= 1.0


def test_train_state_is_a_tree():
    """A TrainState flattens to JAX's keys and rebuilds as a TrainState;
    its tensors are the live ones."""
    trainer = _make_trainer()
    ts = trainer.state()
    flat = flatten_with_keys(ts)
    assert [k for k, _ in flat] == [
        "0/fc1/bias", "0/fc1/weight", "0/fc2/bias", "0/fc2/weight",
        "2/slots/m/fc1/bias", "2/slots/m/fc1/weight", "2/slots/m/fc2/bias",
        "2/slots/m/fc2/weight", "2/slots/v/fc1/bias",
        "2/slots/v/fc1/weight", "2/slots/v/fc2/bias",
        "2/slots/v/fc2/weight", "2/step", "3"]
    assert all(hasattr(leaf, "shape") for _, leaf in flat)
    ts2 = unflatten_like(ts, iter(leaf for _, leaf in flat))
    assert isinstance(ts2, TrainState)
    assert ts2.variables["params"]["fc1"]["weight"].data_ptr() == \
        trainer.module.fc1.weight.data_ptr()


def test_nan_guard(flags):
    flags.set("check_nan_inf", True)
    exe = Executor("cpu")
    with pytest.raises(FloatingPointError, match="'y'"):
        exe.run(lambda x: {"y": torch.log(x)},
                feed={"x": np.array([-1.0])}, fetch_list=["y"])
    flags.set("check_nan_inf", False)
    out = exe.run(lambda x: {"y": torch.log(x)},
                  feed={"x": np.array([-1.0])}, fetch_list=["y"])
    assert torch.isnan(out[0]).all()


def test_train_step_nan_guard_names_the_leaf(flags):
    """Under FLAGS_check_nan_inf a step whose update makes a parameter
    non-finite raises, naming it by its JAX path."""
    trainer = _make_trainer(opt=SGD, lr=1.0)
    x, y = next(iter(_batches(1)))
    trainer.train_step((x, y))          # the flag is off: no check
    flags.set("check_nan_inf", True)
    with torch.no_grad():
        trainer.module.fc2.bias[0] = float("inf")
    with pytest.raises(FloatingPointError, match="train fetches at 'loss'"):
        trainer.train_step((x, y))
    trainer = _make_trainer(opt=SGD, lr=float("inf"))
    with pytest.raises(FloatingPointError, match="params at 'fc1/bias'"):
        trainer.train_step((x, y))


def test_load_state_restores_step_and_generator():
    a = _make_trainer(seed=3)
    for batch in _batches(3):
        a.train_step(batch)
    b = _make_trainer(seed=3)
    assert b.step_generator().initial_seed() != \
        a.step_generator().initial_seed()
    b.load_state(a.state())
    assert b.step == 3 and b.optimizer.step_count == 3
    assert b.step_generator().initial_seed() == \
        a.step_generator().initial_seed()
    batch = next(iter(_batches(1, seed=4)))
    assert float(a.train_step(batch)["loss"]) == \
        float(b.train_step(batch)["loss"])


def test_flags_read_the_environment(monkeypatch):
    monkeypatch.setenv("FLAGS_check_nan_inf", "1")
    monkeypatch.setenv("FLAGS_executor_cache_capacity", "7")
    reg = FlagRegistry()
    reg.define("check_nan_inf", False)
    reg.define("executor_cache_capacity", 256, parser=int)
    assert reg.get("check_nan_inf") is True
    assert reg.get("executor_cache_capacity") == 7
    with pytest.raises(KeyError, match="undefined flag"):
        reg.set("no_such_flag", 1)


def test_executor_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Executor()


def test_naive_executor_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        NaiveExecutor(lambda x: x, [np.ones(2, np.float32)])
