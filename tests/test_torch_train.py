"""The slice: training a CausalLM through the port's `Trainer` against
the JAX package's `Trainer`, on the same weights and batches.

The JAX weights come from `model.init` and go to the port through
`load_jax_params`; both sides train with Adam under the fused
cross-entropy over `return_hidden` (the recipe of
tests/test_causal_lm.py::test_trains_with_fused_ce). On the CPU both
attentions take their plain paths. Bars:
- the loss within 2e-4;
- the gradients within 1e-4 of each tensor's largest magnitude, against
  `jax.grad` of the same loss (float32 sums in other orders), plus a
  floor of 1e-6 of the model's largest gradient: a gradient that is 0
  in exact arithmetic (the key bias's, as softmax ignores a per-row
  shift) is float32 noise on both sides;
- parameters within 2e-3 (absolute) after one and after three steps at
  lr 1e-3: Adam's first step is about lr * sign(g), so a gradient
  within rounding of 0 may flip its update by 2 * lr with no fault
  (the bar and reason of __graft_entry__.py:125-130); Adam's slots
  within 2e-3 of each tensor's largest magnitude, with the gradients'
  floor (the slots are gradient moments).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.executor import Trainer as JaxTrainer
from paddle_tpu.models.transformer import CausalLM as JaxCausalLM
from paddle_tpu.ops.fused_ce import linear_cross_entropy as jax_lce
from paddle_tpu.optim.optimizer import Adam as JaxAdam
from paddle_tpu_torch.core import Trainer
from paddle_tpu_torch.models import (CausalLM, load_jax_params,
                                     to_jax_opt_state, to_jax_params)
from paddle_tpu_torch.ops import linear_cross_entropy
from paddle_tpu_torch.optim import Adam

VOCAB, MAX_LEN, CHUNK = 61, 16, 32
DIMS = dict(model_dim=16, num_heads=4, num_layers=2, ffn_dim=32)
VARIANTS = {
    "mha": dict(),
    "gqa": dict(num_kv_heads=2),
    "fused_qkv": dict(fused_qkv=True),
    "untied_head": dict(tie_embeddings=False),
}
LR = 1e-3


def jax_loss_fn(module, variables, batch, rng, training):
    inp, tgt = batch
    hid, mut = module.apply(variables, inp, training=training, rngs=rng,
                            mutable=True, return_hidden=True)
    w, bias = module.head_weights(variables)
    loss = jnp.mean(jax_lce(hid, w, tgt, bias, chunk=CHUNK))
    return (loss, {}), mut.get("state", {})


def loss_fn(module, batch, generator, training):
    inp, tgt = batch
    hid = module(inp, return_hidden=True, generator=generator)
    w, bias = module.head_weights()
    return linear_cross_entropy(hid, w, tgt, bias, chunk=CHUNK).mean(), {}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, p) if isinstance(v, dict) else
                   {p: np.asarray(v)})
    return out


def _close(got, want, rel, floor=0.0):
    """Within `rel` of each tensor's largest magnitude (and of itself),
    plus `floor` times the largest magnitude of the whole tree."""
    top = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for path in want:
        w = np.asarray(want[path], np.float32)
        np.testing.assert_allclose(
            np.asarray(got[path]), w, rtol=rel,
            atol=rel * float(np.abs(w).max()) + floor * top, err_msg=path)


def _params_close(tm, ts):
    want = _flat(jax.device_get(ts.params))
    got = _flat(to_jax_params(tm)["params"])
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, atol=2e-3, rtol=2e-3,
                                   err_msg=path)


def _slots_close(tm, ttr, ts):
    state = to_jax_opt_state(tm, ttr.optimizer)
    assert int(state["step"]) == int(ts.opt_state["step"])
    for slot in ("m", "v"):
        _close(_flat(state["slots"][slot]),
               _flat(jax.device_get(ts.opt_state["slots"][slot])), 2e-3,
               floor=1e-6)


def _batch(seed, b=4, t=12):
    rs = np.random.RandomState(seed)
    tok = rs.randint(0, VOCAB, (b, t)).astype(np.int32)
    return tok, np.roll(tok, -1, axis=1)


def _setup(variant, seed=5):
    kw = VARIANTS[variant]
    jm = JaxCausalLM(VOCAB, dropout=0.0, max_len=MAX_LEN, **DIMS, **kw)
    tok, tgt = _batch(seed)
    jtr = JaxTrainer(jm, JaxAdam(LR), jax_loss_fn)
    ts = jtr.init_state(jnp.asarray(tok))
    tm = CausalLM(VOCAB, dropout=0.0, max_len=MAX_LEN, device="cpu", **DIMS,
                  **kw)
    load_jax_params(tm, {"params": jax.device_get(ts.params)})
    ttr = Trainer(tm, Adam(tm.parameters(), LR), loss_fn)
    return jm, jtr, ts, tm, ttr, (tok, tgt)


def _tbatch(batch):
    return tuple(torch.from_numpy(x) for x in batch)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_one_then_three_steps_match_jax(variant):
    """Step 1: loss, every gradient, parameters and slots; then steps 2
    and 3 on new batches: losses, parameters and slots; then eval."""
    jm, jtr, ts, tm, ttr, batch = _setup(variant)
    jbatch = tuple(jnp.asarray(x) for x in batch)
    jgrads = jax.jit(jax.grad(lambda p: jax_loss_fn(
        jm, {"params": p}, jbatch, None, True)[0][0]))(ts.params)
    ts, jout = jtr.train_step(ts, jbatch)
    out = ttr.train_step(_tbatch(batch))
    np.testing.assert_allclose(float(out["loss"]), float(jout["loss"]),
                               atol=2e-4, rtol=2e-4)
    grads = {f"params/{k}": v for k, v in _flat(jax.device_get(jgrads)
                                                ).items()}
    port_grads = {path: p.grad.numpy() for path, p in zip(
        _flat(to_jax_params(tm)), tm.parameters())}
    assert set(port_grads) == set(grads)
    _close(port_grads, grads, 1e-4, floor=1e-6)
    assert ttr.optimizer.step_count == 1
    _params_close(tm, ts)
    _slots_close(tm, ttr, ts)
    for i in range(2):
        batch = _batch(10 + i)
        ts, jout = jtr.train_step(ts, tuple(jnp.asarray(x) for x in batch))
        out = ttr.train_step(_tbatch(batch))
        np.testing.assert_allclose(float(out["loss"]), float(jout["loss"]),
                                   atol=2e-4, rtol=2e-4)
    assert ttr.step == 3 and ttr.optimizer.step_count == 3
    _params_close(tm, ts)
    _slots_close(tm, ttr, ts)
    jeval = jtr.eval_step(ts, tuple(jnp.asarray(x) for x in _batch(20)))
    teval = ttr.eval_step(_tbatch(_batch(20)))
    np.testing.assert_allclose(float(teval["loss"]), float(jeval["loss"]),
                               atol=2e-4, rtol=2e-4)


def test_trains_with_fused_ce():
    """Loss falls below 0.6 x its first value in 25 Adam steps at lr 1e-2
    (test_causal_lm.py:105)."""
    torch.manual_seed(0)
    tm = CausalLM(VOCAB, dropout=0.0, max_len=MAX_LEN, device="cpu",
                  num_heads=2, model_dim=16, num_layers=2, ffn_dim=32)
    tr = Trainer(tm, Adam(tm.parameters(), 1e-2), loss_fn)
    batch = _tbatch(_batch(5))
    losses = [float(tr.train_step(batch)["loss"]) for _ in range(25)]
    assert losses[-1] < losses[0] * 0.6, losses


def test_fit_runs_epochs_and_calls_back():
    _, _, _, tm, ttr, batch = _setup("mha")
    seen = []
    ttr.fit([_tbatch(batch)] * 2, epochs=2,
            callback=lambda s, f: seen.append((s, float(f["loss"]))))
    assert [s for s, _ in seen] == [1, 2, 3, 4]


def test_packed_segments_match_separate_docs():
    """Two documents packed into one row with segment_ids and per-document
    positions give each document's own logits (test_causal_lm.py:146),
    and JAX's packed logits."""
    jm, _, ts, tm, _, _ = _setup("gqa")
    n1, n2 = 4, 6
    rs = np.random.RandomState(9)
    doc1, doc2 = (rs.randint(0, VOCAB, (1, n)).astype(np.int32)
                  for n in (n1, n2))
    packed = np.concatenate([doc1, doc2], axis=1)
    segs = np.asarray([[0] * n1 + [1] * n2], np.int32)
    pos = np.asarray([list(range(n1)) + list(range(n2))], np.int32)
    with torch.no_grad():
        out = tm(torch.from_numpy(packed), segment_ids=torch.from_numpy(segs),
                 positions=torch.from_numpy(pos)).numpy()
        out1 = tm(torch.from_numpy(doc1)).numpy()
        out2 = tm(torch.from_numpy(doc2)).numpy()
    np.testing.assert_allclose(out[:, :n1], out1, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out[:, n1:], out2, rtol=1e-4, atol=1e-5)
    want = jm.apply({"params": ts.params}, jnp.asarray(packed),
                    segment_ids=jnp.asarray(segs), positions=jnp.asarray(pos))
    np.testing.assert_allclose(out, np.asarray(want), rtol=1e-4, atol=1e-4)


def test_positions_out_of_range_are_clipped_like_jax():
    jm, _, ts, tm, _, _ = _setup("mha")
    tok = np.asarray([[3, 4, 5]], np.int32)
    pos = np.asarray([[0, MAX_LEN + 7, -3]], np.int32)
    with torch.no_grad():
        got = tm(torch.from_numpy(tok), positions=torch.from_numpy(pos))
    want = jm.apply({"params": ts.params}, jnp.asarray(tok),
                    positions=jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("tied", [True, False])
def test_fused_ce_head_parity(tied):
    """return_hidden + head_weights + linear_cross_entropy == the CE of
    the full logits."""
    _, _, _, tm, _, (tok, tgt) = _setup(
        "mha" if tied else "untied_head")
    with torch.no_grad():
        logits = tm(torch.from_numpy(tok))
        want = torch.nn.functional.cross_entropy(
            logits.reshape(-1, VOCAB), torch.from_numpy(tgt).long().reshape(
                -1), reduction="none").reshape(tgt.shape)
        hid = tm(torch.from_numpy(tok), return_hidden=True)
        w, bias = tm.head_weights()
        got = linear_cross_entropy(hid, w, torch.from_numpy(tgt), bias,
                                   chunk=CHUNK)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_dropout_draws_only_from_the_generator():
    """With dropout on, two runs with the same generator seed give the
    same bits, another seed other bits, and PyTorch's global RNG is
    never touched (embedding, block, FFN and attention dropout)."""
    tm = CausalLM(VOCAB, dropout=0.3, max_len=MAX_LEN, device="cpu",
                  **DIMS)
    tm.train()
    tok = torch.from_numpy(_batch(3)[0])
    state = torch.random.get_rng_state()

    def run(seed):
        return tm(tok, generator=torch.Generator().manual_seed(seed))
    a, b, c = run(7), run(7), run(8)
    assert torch.equal(torch.random.get_rng_state(), state)
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)
    tm.eval()
    torch.testing.assert_close(tm(tok), tm(tok), rtol=0, atol=0)


def test_training_dropout_needs_a_generator():
    tm = CausalLM(VOCAB, dropout=0.3, max_len=MAX_LEN, device="cpu",
                  **DIMS)
    tm.train()
    with pytest.raises(ValueError, match="Generator"):
        tm(torch.from_numpy(_batch(3)[0]))


def test_default_generator_follows_seed_and_step():
    """Without a generator, train_step seeds one from (seed ^ 0x5EED,
    step): the same seed replays the same dropout."""
    def losses(seed):
        torch.manual_seed(0)
        tm = CausalLM(VOCAB, dropout=0.2, max_len=MAX_LEN, device="cpu",
                      **DIMS)
        tr = Trainer(tm, Adam(tm.parameters(), 1e-3), loss_fn, seed=seed)
        batch = _tbatch(_batch(4))
        return [float(tr.train_step(batch)["loss"]) for _ in range(2)]
    assert losses(1) == losses(1)
    assert losses(1) != losses(2)


def test_to_jax_params_round_trips():
    _, _, ts, tm, _, _ = _setup("fused_qkv")
    tree = to_jax_params(tm)
    _close(_flat(tree), {f"params/{k}": v for k, v in
                         _flat(jax.device_get(ts.params)).items()}, 0.0)
