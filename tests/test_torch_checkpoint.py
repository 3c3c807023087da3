"""The port's checkpoints (paddle_tpu_torch/io/checkpoint.py): mirrors of
tests/test_io.py:26-59 and :147-206 on the port's `Trainer.state()`,
then the same checkpoints across the two packages: JAX reads and
verifies the port's, the port reads JAX's `TrainState`, and a port run
resumed by JAX's `CheckpointManager` and `Trainer` takes the port's
next step.

The model is a tiny CausalLM trained with Adam under the fused
cross-entropy (tests/test_torch_train.py's recipe); on the CPU both
packages take their plain attention paths.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.executor import Trainer as JaxTrainer
from paddle_tpu.io import checkpoint as jckpt
from paddle_tpu.models.transformer import CausalLM as JaxCausalLM
from paddle_tpu.ops.fused_ce import linear_cross_entropy as jax_lce
from paddle_tpu.optim.optimizer import Adam as JaxAdam
from paddle_tpu_torch.core import Trainer, TrainState
from paddle_tpu_torch.io import (AsyncCheckpointer, CheckpointIntegrityError,
                                 CheckpointManager, checkpoint_step,
                                 latest_checkpoint, list_checkpoints,
                                 load_checkpoint, read_metadata,
                                 save_checkpoint, verify_checkpoint)
from paddle_tpu_torch.models import (CausalLM, load_jax_params,
                                     to_jax_opt_state, to_jax_params)
from paddle_tpu_torch.ops import linear_cross_entropy
from paddle_tpu_torch.optim import Adam
from paddle_tpu_torch.testing import causal_lm_tree
from paddle_tpu_torch.utils.tree import flatten_with_keys

VOCAB, MAX_LEN, CHUNK, LR = 61, 16, 32, 1e-3
DIMS = dict(model_dim=16, num_heads=4, num_layers=2, ffn_dim=32,
            num_kv_heads=2)


def loss_fn(module, batch, generator, training):
    inp, tgt = batch
    hid = module(inp, return_hidden=True, generator=generator)
    w, bias = module.head_weights()
    return linear_cross_entropy(hid, w, tgt, bias, chunk=CHUNK).mean(), {}


def jax_loss_fn(module, variables, batch, rng, training):
    inp, tgt = batch
    hid, mut = module.apply(variables, inp, training=training, rngs=rng,
                            mutable=True, return_hidden=True)
    w, bias = module.head_weights(variables)
    loss = jnp.mean(jax_lce(hid, w, tgt, bias, chunk=CHUNK))
    return (loss, {}), mut.get("state", {})


def _trainer(seed=0, **adam):
    model = CausalLM(VOCAB, dropout=0.0, max_len=MAX_LEN, device="cpu",
                     **DIMS)
    load_jax_params(model, causal_lm_tree(seed, VOCAB, **DIMS))
    return Trainer(model, Adam(model.parameters(), LR, **adam), loss_fn)


def _batch(seed, b=2, t=12):
    tok = np.random.default_rng(seed).integers(0, VOCAB, (b, t)).astype(
        np.int32)
    return tok, np.roll(tok, -1, axis=1)


def _tb(batch):
    return tuple(torch.from_numpy(x) for x in batch)


def _leaves(tree):
    return {k: np.array(v.detach().numpy() if isinstance(v, torch.Tensor)
                        else v)
            for k, v in flatten_with_keys(tree)}


def _assert_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# -- mirrors of tests/test_io.py ---------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tr = _trainer()
    tr.train_step(_tb(_batch(1)))
    ts = tr.state()
    path = save_checkpoint(str(tmp_path / "ck"), ts, step=1)
    restored = load_checkpoint(path, target=tr.state())
    assert isinstance(restored, TrainState)
    _assert_equal(restored, ts)
    assert restored.params["embed"]["weight"].dtype == torch.float32
    assert restored.step.dtype == torch.int32 and int(restored.step) == 1
    assert checkpoint_step(path) == 1
    keys = [leaf["key"] for leaf in
            json.load(open(os.path.join(path, "manifest.json")))["leaves"]]
    assert "0/embed/weight" in keys and "2/slots/m/embed/weight" in keys
    assert {"2/step", "3"} <= set(keys)


def test_checkpoint_shape_mismatch(tmp_path):
    save_checkpoint(str(tmp_path / "ck"), {"w": np.zeros((2, 2))})
    with pytest.raises(ValueError):
        load_checkpoint(str(tmp_path / "ck"), target={"w": np.zeros((3,))})


def test_checkpoint_missing_leaf(tmp_path):
    save_checkpoint(str(tmp_path / "ck"), {"w": np.zeros(2)})
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "ck"),
                        target={"w": np.zeros(2), "b": np.zeros(1)})


def test_manager_rotation_and_resume(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    tree = {"w": np.arange(3.0)}
    for step in (1, 2, 3):
        mgr.save({"w": tree["w"] * step}, step=step)
    assert sorted(os.listdir(tmp_path)) == ["ckpt-2", "ckpt-3"]
    restored, step = mgr.restore_latest(target=tree)
    assert step == 3
    np.testing.assert_allclose(restored["w"], tree["w"] * 3)
    assert latest_checkpoint(str(tmp_path)).endswith("ckpt-3")
    assert [s for s, _ in list_checkpoints(str(tmp_path))] == [3, 2]


def test_async_checkpointer_parity_and_ordering(tmp_path):
    """Same on-disk result as the sync path; a second save joins the
    one in flight first."""
    tr = _trainer()
    ts = tr.state()
    save_checkpoint(str(tmp_path / "sync"), ts, step=1)
    ac = AsyncCheckpointer()
    ac.save(str(tmp_path / "a"), ts, step=1)
    ac.save(str(tmp_path / "b"), ts, step=2)
    ac.wait()
    for name in ("a", "b"):
        _assert_equal(load_checkpoint(str(tmp_path / name),
                                      target=tr.state()), ts)
    for f in ("shards-p0.npz", "shard_index-p0.json"):
        assert (open(tmp_path / "a" / f, "rb").read()
                == open(tmp_path / "sync" / f, "rb").read())


def test_async_checkpoint_survives_in_place_updates(tmp_path):
    """The snapshot is taken before save() returns: the next train
    step's in-place updates of the parameters and slots must not reach
    the checkpoint."""
    tr = _trainer()
    tr.train_step(_tb(_batch(1)))
    want = _leaves(tr.state())
    ac = AsyncCheckpointer()
    ac.save(str(tmp_path / "ck"), tr.state(), step=1)
    tr.train_step(_tb(_batch(2)))
    ac.wait()
    got = _leaves(load_checkpoint(str(tmp_path / "ck"), target=tr.state()))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    moved = _leaves(tr.state())
    assert not np.array_equal(moved["0/embed/weight"],
                              want["0/embed/weight"])


def test_async_error_propagates(tmp_path):
    ac = AsyncCheckpointer()
    bad = tmp_path / "no" / "such" / "deep" / "dir" / "ck"
    ac.save(str(bad), {"w": np.zeros(2)}, step=0)
    with pytest.raises(RuntimeError, match="async checkpoint"):
        ac.wait()
    ac.wait()  # the error is consumed; later waits are clean


def test_manager_async_rotation_and_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2, async_save=True)
    tr = _trainer()
    for step in (1, 2, 3):
        mgr.save(tr.state(), step=step)
    restored, step = mgr.restore_latest(target=tr.state())  # waits
    assert step == 3
    _assert_equal(restored, tr.state())
    mgr.wait()
    assert sorted(n for n in os.listdir(tmp_path)
                  if n.startswith("ckpt-")) == ["ckpt-2", "ckpt-3"]


def test_restore_falls_back_over_a_corrupt_newest(tmp_path, capsys):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    for step in (1, 2):
        mgr.save({"w": np.full(4, float(step))}, step=step,
                 metadata={"note": f"s{step}"})
    shards = tmp_path / "ckpt-2" / "shards-p0.npz"
    raw = bytearray(shards.read_bytes())
    raw[-20] ^= 0xFF
    shards.write_bytes(bytes(raw))
    with pytest.raises(CheckpointIntegrityError, match="corrupt"):
        verify_checkpoint(str(tmp_path / "ckpt-2"))
    assert verify_checkpoint(str(tmp_path / "ckpt-1"))["step"] == 1
    restored, step = mgr.restore_latest(target={"w": np.zeros(4)})
    assert step == 1
    np.testing.assert_array_equal(restored["w"], np.ones(4))
    assert '"ckpt_reject"' in capsys.readouterr().out
    assert read_metadata(str(tmp_path / "ckpt-1")) == {"note": "s1"}


def test_trainer_resumes_bit_for_bit(tmp_path):
    """2 steps, save, a new model, optimizer and Trainer restored from
    the checkpoint, 2 more steps: the same parameters, slots, step and
    losses as 4 uninterrupted steps."""
    batches = [_tb(_batch(10 + i)) for i in range(4)]
    straight = _trainer()
    losses = [float(straight.train_step(b)["loss"]) for b in batches]
    first = _trainer()
    for b in batches[:2]:
        first.train_step(b)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(first.state(), step=first.step)
    resumed = _trainer(seed=99)
    ts, step = mgr.restore_latest(target=resumed.state())
    resumed.load_state(ts)
    assert resumed.step == step == 2 and resumed.optimizer.step_count == 2
    got = [float(resumed.train_step(b)["loss"]) for b in batches[2:]]
    assert got == losses[2:]
    _assert_equal(resumed.state(), straight.state())


# -- across the two packages ---------------------------------------------

def _jax_trainer(seed=0, **adam):
    jm = JaxCausalLM(VOCAB, dropout=0.0, max_len=MAX_LEN, **DIMS)
    jtr = JaxTrainer(jm, JaxAdam(LR, **adam), jax_loss_fn)
    ts = jtr.init_state(jnp.zeros((2, 12), jnp.int32))
    params = jax.tree_util.tree_map(
        jnp.asarray, causal_lm_tree(seed, VOCAB, **DIMS)["params"])
    return jtr, ts.__class__(params, ts.state, jtr.optimizer.init(params),
                             ts.step)


def test_jax_reads_and_verifies_a_port_checkpoint(tmp_path):
    tr = _trainer()
    tr.train_step(_tb(_batch(3)))
    path = save_checkpoint(str(tmp_path / "ck"), tr.state(), step=1)
    assert jckpt.verify_checkpoint(path)["step"] == 1
    _, jts = _jax_trainer()
    restored = jckpt.load_checkpoint(path, target=jts)
    want = _leaves(tr.state())
    got = {k: np.asarray(v) for k, v in jckpt._flatten(restored)}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert restored.step.dtype == jnp.int32


def test_port_reads_a_jax_train_state_checkpoint(tmp_path):
    jtr, jts = _jax_trainer()
    jts, _ = jtr.train_step(jts, tuple(jnp.asarray(x) for x in _batch(4)))
    path = jckpt.save_checkpoint(str(tmp_path / "ck"), jts, step=1)
    assert verify_checkpoint(path)["step"] == 1
    tr = _trainer(seed=5)
    tr.load_state(load_checkpoint(path, target=tr.state()))
    assert tr.step == 1
    want = {k: np.asarray(v) for k, v in jckpt._flatten(jts)}
    _assert_equal({k: v for k, v in _leaves(tr.state()).items()}, want)
    np.testing.assert_array_equal(
        to_jax_params(tr.module)["params"]["blocks_1"]["ffn"]["fc2"][
            "weight"],
        np.asarray(jts.params["blocks_1"]["ffn"]["fc2"]["weight"]))
    assert int(to_jax_opt_state(tr.module, tr.optimizer)["step"]) == 1


def test_port_run_resumed_by_jax_takes_the_same_next_step(tmp_path):
    """Two port steps, saved by the port's CheckpointManager, restored by
    JAX's and stepped once by JAX's Trainer: within 1e-5 of the port's
    own third step (loss, parameters, slots). Adam's epsilon is 1e-4
    here: a gradient that is 0 in exact arithmetic (the key biases')
    is float32 noise on both sides, and at epsilon 1e-8 Adam scales
    that noise to a step of +-lr, different on each side."""
    batches = [_batch(20 + i) for i in range(3)]
    tr = _trainer(epsilon=1e-4)
    for b in batches[:2]:
        tr.train_step(_tb(b))
    CheckpointManager(str(tmp_path)).save(tr.state(), step=tr.step)
    want_loss = float(tr.train_step(_tb(batches[2]))["loss"])
    jtr, jts = _jax_trainer(seed=7, epsilon=1e-4)
    restored, step = jckpt.CheckpointManager(str(tmp_path)).restore_latest(
        target=jts)
    assert step == 2 and int(restored.step) == 2
    jts, out = jtr.train_step(restored,
                              tuple(jnp.asarray(x) for x in batches[2]))
    assert abs(float(out["loss"]) - want_loss) <= 1e-5 * abs(want_loss)
    got = _leaves(tr.state())
    for k, v in jckpt._flatten(jts):
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
