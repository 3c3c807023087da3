"""The resilient training loop across the two packages: JAX's guarded
`MeshTrainer` (on the conftest's 8-device CPU mesh) against the port's
single-device one, on a tiny CausalLM whose parameters the port takes
from the same numpy tree (`causal_lm_tree` through models/convert.py).

- The guarded runs match: clean and under a NaN burst, each package's
  chaotic curve equals its own clean curve bit for bit, and the two
  packages' curves agree within LOSS_RTOL.
- A preempted run resumes across packages: an emergency checkpoint one
  package leaves at the signalled step, the other restores and
  finishes, within the bar of the first package's straight run.
- The event streams match: the same chaos env gives the same sequence
  of resilience events, field for field (minus `ts` and `seq`).

Adam's epsilon is 1e-4, as in tests/test_torch_checkpoint.py: a
gradient that is 0 in exact arithmetic (the key biases') is float32
noise in both packages, and at epsilon 1e-8 Adam scales that noise to a
step of +-lr, different on each side. The batch carries float32
per-token weights (the loss is their weighted mean), so that an
injected NaN reaches the loss of a batch of integer tokens.

Each package has its own chaos module with its own budgets, and one
env var arms both: every run resets both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.executor import TrainState as JaxTrainState
from paddle_tpu.core.executor import _stamp_step
from paddle_tpu.io import checkpoint as jckpt
from paddle_tpu.models.transformer import CausalLM as JaxCausalLM
from paddle_tpu.ops.fused_ce import linear_cross_entropy as jax_lce
from paddle_tpu.optim.optimizer import Adam as JaxAdam
from paddle_tpu.parallel import DistStrategy as JaxDistStrategy
from paddle_tpu.parallel import MeshConfig as JaxMeshConfig
from paddle_tpu.parallel import MeshTrainer as JaxMeshTrainer
from paddle_tpu.parallel import make_mesh as jax_make_mesh
from paddle_tpu.resilience import chaos as jchaos
from paddle_tpu.resilience import retry as jretry
from paddle_tpu.resilience import supervisor as jsup
from paddle_tpu.utils import log as jlog
from paddle_tpu_torch.io import CheckpointManager
from paddle_tpu_torch.models import CausalLM, load_jax_params
from paddle_tpu_torch.ops import linear_cross_entropy
from paddle_tpu_torch.optim import Adam
from paddle_tpu_torch.parallel import DistStrategy, MeshTrainer, make_mesh
from paddle_tpu_torch.resilience import chaos, shared_budget
from paddle_tpu_torch.resilience.errors import PREEMPT_EXIT_CODE
from paddle_tpu_torch.resilience.supervisor import (RunSupervisor,
                                                    train_resilient)
from paddle_tpu_torch.testing import causal_lm_tree
from paddle_tpu_torch.utils import log as tlog
from paddle_tpu_torch.utils.tree import flatten_with_keys

VOCAB, MAX_LEN, CHUNK, LR, B, T = 61, 16, 32, 1e-2, 8, 12
DIMS = dict(model_dim=16, num_heads=4, num_layers=2, ffn_dim=32,
            num_kv_heads=2)
STEPS, BUDGET = 6, 2
# float32 bar between the packages (they sum attention and the vocab
# chunks in other orders): each step's loss within LOSS_RTOL relative;
# each state leaf after STEPS Adam steps within STATE_RTOL of the leaf's
# largest magnitude plus STATE_ATOL. The absolute floor is for the key
# biases and their slots, which are float32 noise in both packages
# (their exact gradient is 0): ~1e-7 in the parameters. Measured on the
# clean run: the losses within 3e-7 relative, every other leaf within
# 2e-6 of its scale.
LOSS_RTOL = 1e-5
STATE_RTOL = 1e-5
STATE_ATOL = 1e-6

CHAOS_VARS = ("PTPU_CHAOS_NAN_STEP", "PTPU_CHAOS_NAN_ATTEMPTS",
              "PTPU_CHAOS_CKPT_IO", "PTPU_CHAOS_SIGTERM_STEP")


def _reset_chaos():
    chaos.reset()
    jchaos.reset()
    shared_budget().reset()
    jretry.shared_budget().reset()


@pytest.fixture(autouse=True)
def _clean_chaos(monkeypatch):
    monkeypatch.setenv("PTPU_RETRY_SCALE", "0")
    for var in CHAOS_VARS:
        monkeypatch.delenv(var, raising=False)
    _reset_chaos()
    yield
    _reset_chaos()


def _tokens(step):
    rng = np.random.default_rng(500 + step)
    tok = rng.integers(0, VOCAB, (B, T + 1)).astype(np.int32)
    return tok[:, :-1], tok[:, 1:], np.ones((B, T), np.float32)


def port_batch(step):
    return tuple(torch.from_numpy(x) for x in _tokens(step))


def jax_batch(step):
    return tuple(jnp.asarray(x) for x in _tokens(step))


def port_loss(module, batch, generator, training):
    inp, tgt, w = batch
    hid = module(inp, return_hidden=True, generator=generator)
    wt, bias = module.head_weights()
    per = linear_cross_entropy(hid, wt, tgt, bias, chunk=CHUNK)
    return (per * w).sum() / w.sum(), {}


def jax_loss(module, variables, batch, rng, training):
    inp, tgt, w = batch
    hid, mut = module.apply(variables, inp, training=training, rngs=rng,
                            mutable=True, return_hidden=True)
    wt, bias = module.head_weights(variables)
    per = jax_lce(hid, wt, tgt, bias, chunk=CHUNK)
    return (jnp.sum(per * w) / jnp.sum(w), {}), mut.get("state", {})


def port_trainer(seed=0):
    model = CausalLM(VOCAB, dropout=0.0, max_len=MAX_LEN, device="cpu",
                     **DIMS)
    load_jax_params(model, causal_lm_tree(seed, VOCAB, **DIMS))
    return MeshTrainer(model, Adam(model.parameters(), LR, epsilon=1e-4),
                       port_loss, make_mesh(devices=["cpu"]),
                       strategy=DistStrategy(bad_step_budget=BUDGET))


@pytest.fixture(scope="module")
def jax_trainer():
    """One JAX MeshTrainer for the module: its compiled step is reused
    by every run (each run starts from a fresh state)."""
    model = JaxCausalLM(VOCAB, dropout=0.0, max_len=MAX_LEN, **DIMS)
    mesh = jax_make_mesh(JaxMeshConfig(dp=jax.device_count()))
    trainer = JaxMeshTrainer(model, JaxAdam(LR, epsilon=1e-4), jax_loss,
                             mesh,
                             strategy=JaxDistStrategy(bad_step_budget=BUDGET))
    trainer.init_state(jnp.zeros((B, T), jnp.int32))
    return trainer


def jax_state(trainer, seed=0):
    """A fresh JAX TrainState of causal_lm_tree(seed) weights, on the
    trainer's state shardings, stamped at step 0."""
    trainer.reset_bad_steps()
    params = jax.tree_util.tree_map(
        jnp.asarray, causal_lm_tree(seed, VOCAB, **DIMS)["params"])
    ts = JaxTrainState(params, {}, trainer.optimizer.init(params),
                       jnp.zeros((), jnp.int32))
    return _stamp_step(jax.device_put(ts, trainer._state_shardings), 0)


def run_port(tmp, trainer=None, start=0, supervisor=None):
    trainer = trainer or port_trainer()
    losses = {}
    train_resilient(trainer, port_batch, STEPS, CheckpointManager(str(tmp)),
                    start_step=start, save_every=1, supervisor=supervisor,
                    on_step=lambda s, f: losses.__setitem__(
                        s, float(f["loss"])))
    return losses, trainer


def run_jax(tmp, trainer, ts=None, start=0, supervisor=None):
    ts = jax_state(trainer) if ts is None else ts
    losses = {}
    ts = jsup.train_resilient(
        trainer, ts, jax_batch, STEPS, jckpt.CheckpointManager(str(tmp)),
        start_step=start, save_every=1, supervisor=supervisor,
        on_step=lambda s, f: losses.__setitem__(s, float(f["loss"])))
    return losses, ts


def port_leaves(trainer):
    return {k: v.detach().numpy() for k, v in
            flatten_with_keys(trainer.state())}


def jax_leaves(ts):
    return {k: np.asarray(v) for k, v in jckpt._flatten(ts)}


def assert_curves_close(got, want):
    assert sorted(got) == sorted(want) == list(range(STEPS))
    for s in want:
        assert abs(got[s] - want[s]) <= LOSS_RTOL * abs(want[s]), (
            s, got[s], want[s])


def assert_states_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        scale = float(np.abs(want[k]).max())
        err = float(np.abs(got[k].astype(np.float64) - want[k]).max())
        assert err <= STATE_RTOL * scale + STATE_ATOL, (k, err, scale)


def test_guarded_runs_match_across_packages(tmp_path, monkeypatch,
                                            jax_trainer):
    port_clean, t_clean = run_port(tmp_path / "pc")
    jax_clean, jts_clean = run_jax(tmp_path / "jc", jax_trainer)
    monkeypatch.setenv("PTPU_CHAOS_NAN_STEP", "2:3")
    _reset_chaos()
    port_chaos, t_chaos = run_port(tmp_path / "pn")
    _reset_chaos()
    jax_chaos, jts_chaos = run_jax(tmp_path / "jn", jax_trainer)

    # within each package: bit for bit
    assert port_chaos == port_clean
    assert jax_chaos == jax_clean
    for k, v in port_leaves(t_clean).items():
        np.testing.assert_array_equal(port_leaves(t_chaos)[k], v, err_msg=k)
    for k, v in jax_leaves(jts_clean).items():
        np.testing.assert_array_equal(jax_leaves(jts_chaos)[k], v, err_msg=k)
    # across the packages: within the float32 bar
    assert_curves_close(port_clean, jax_clean)
    assert_states_close(port_leaves(t_clean), jax_leaves(jts_clean))


class _Preempted(Exception):
    pass


def _exit(code):
    raise _Preempted(code)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_preempted_run_resumes_across_packages(tmp_path, monkeypatch,
                                               jax_trainer, first):
    """`first` is preempted by PTPU_CHAOS_SIGTERM_STEP=3 and leaves an
    emergency checkpoint at step 3; the other package's CheckpointManager
    restores it into a trainer of other weights and finishes the run,
    within the bar of `first`'s straight run."""
    if first == "jax":
        straight, want = run_jax(tmp_path / "straight", jax_trainer)
        want = jax_leaves(want)
    else:
        straight, want = run_port(tmp_path / "straight")
        want = port_leaves(want)
    monkeypatch.setenv("PTPU_CHAOS_SIGTERM_STEP", "3")
    _reset_chaos()
    ckdir = tmp_path / "preempted"
    if first == "jax":
        mgr = jckpt.CheckpointManager(str(ckdir))
        sup = jsup.RunSupervisor(mgr, _exit_fn=_exit)
    else:
        mgr = CheckpointManager(str(ckdir))
        sup = RunSupervisor(mgr, _exit_fn=_exit)
    with pytest.raises(_Preempted) as e, sup:
        (run_jax(ckdir, jax_trainer, supervisor=sup) if first == "jax"
         else run_port(ckdir, supervisor=sup))
    assert e.value.args == (PREEMPT_EXIT_CODE,)
    assert jckpt.checkpoint_step(jckpt.latest_checkpoint(str(ckdir))) == 3

    monkeypatch.delenv("PTPU_CHAOS_SIGTERM_STEP")
    _reset_chaos()
    if first == "jax":
        trainer = port_trainer(seed=9)
        restored, step = CheckpointManager(str(ckdir)).restore_latest(
            trainer.state())
        trainer.load_state(restored)
        assert step == 3 and trainer.step == 3
        resumed, trainer = run_port(ckdir, trainer, start=step)
        got = port_leaves(trainer)
    else:
        restored, step = jckpt.CheckpointManager(str(ckdir)).restore_latest(
            jax_state(jax_trainer, seed=9))
        assert step == 3 and int(restored.step) == 3
        resumed, ts = run_jax(ckdir, jax_trainer, ts=restored, start=step)
        got = jax_leaves(ts)
    assert sorted(resumed) == [3, 4, 5]
    for s in resumed:
        assert abs(resumed[s] - straight[s]) <= LOSS_RTOL * abs(straight[s])
    assert_states_close(got, want)


def _stream(tap_owner, run):
    """The resilience records `run()` emits through one package's log
    module, without `ts` and `seq`."""
    recs = []

    def tap(stream, rec):
        if stream == "resilience":
            recs.append({k: v for k, v in rec.items()
                         if k not in ("ts", "seq")})

    tap_owner.add_event_tap(tap)
    try:
        run()
    finally:
        tap_owner.remove_event_tap(tap)
    return recs


@pytest.mark.parametrize("env", [
    {"PTPU_CHAOS_NAN_STEP": "2:3", "PTPU_CHAOS_CKPT_IO": "2"},
    {"PTPU_CHAOS_NAN_STEP": "3", "PTPU_CHAOS_NAN_ATTEMPTS": "3"},
], ids=["burst_and_io", "rollback"])
def test_event_streams_match(tmp_path, monkeypatch, jax_trainer, env):
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    _reset_chaos()
    port = _stream(tlog, lambda: run_port(tmp_path / "p"))
    _reset_chaos()
    jx = _stream(jlog, lambda: run_jax(tmp_path / "j", jax_trainer))
    assert [r["evt"] for r in port] == [r["evt"] for r in jx]
    if "PTPU_CHAOS_NAN_ATTEMPTS" in env:
        # JAX's restored TrainState carries no host step hint, so its
        # guard reports step -1 after the rollback; the port's trainer
        # holds its step and reports 3. Every other field is equal.
        after = [i for i, r in enumerate(jx) if r["evt"] == "rollback"][0]
        fixed = [i for i, r in enumerate(jx)
                 if i > after and r["evt"] == "bad_step_skip"]
        assert fixed and all(jx[i]["step"] == -1 for i in fixed)
        assert all(port[i]["step"] == 3 for i in fixed)
        for i in fixed:
            jx[i]["step"] = port[i]["step"]
    assert port == jx
    assert {r["evt"] for r in port} >= {"chaos_inject", "bad_step_skip"}
