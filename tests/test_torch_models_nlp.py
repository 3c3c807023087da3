"""The port's NLP and recommendation zoo (`models/nlp.py`) against
tests/test_models_nlp.py's five tests other than
`test_bert_encoder_mlm` (which test_torch_transformer.py holds), and
against the JAX models on the same weights: forward and gradients of
`Word2Vec`, `TextClassifier` (with lengths, max and mean pools),
`Seq2Seq` (with source lengths), `DeepFM` (`padding_idx` unset) and
`Recommender`.

The weights are a tree in JAX's layout (the port's seeded init, its
paths and shapes held to JAX's `init` by `jax.eval_shape`), loaded by
path with `load_jax_params` and applied by both packages. Bars: outputs
and gradients within 1e-4 of each tensor's largest element (whole
models: float32 error compounds through the layers and time steps).
JAX runs each model function jitted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import data as JD
from paddle_tpu.data.datasets import ctr_synthetic
from paddle_tpu.models import nlp as JN
from paddle_tpu_torch.core import Trainer
from paddle_tpu_torch.models import (DeepFM, Recommender, Seq2Seq,
                                     TextClassifier, Word2Vec,
                                     load_jax_params, to_jax_params)
from paddle_tpu_torch.models.convert import param_path
from paddle_tpu_torch.ops import functional as F
from paddle_tpu_torch.optim import Adam
from paddle_tpu_torch.testing import one_torch_thread
from paddle_tpu_torch.utils.tree import flatten_with_keys, nest


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


CPU = dict(device="cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------- tests/test_models_nlp.py mirrors

def _ce(module, batch, generator, training):
    ctx, nxt = batch
    return F.softmax_with_cross_entropy(module(ctx), nxt).mean(), {}


def test_word2vec_learns_ngram(rng):
    vocab = 50
    torch.manual_seed(0)
    model = Word2Vec(vocab, embed_dim=16, hidden=64, **CPU)

    def batch(n):
        ctx = rng.randint(0, vocab, (n, 4))
        return _t(ctx), _t((ctx[:, -1] + 1) % vocab)

    trainer = Trainer(model, Adam(model.parameters(), 5e-3), _ce)
    losses = [float(trainer.train_step(batch(64))["loss"])
              for _ in range(150)]
    assert losses[-1] < losses[0] * 0.9


def test_text_classifier_shapes(rng):
    model = TextClassifier(vocab=100, embed_dim=16, hidden=32, layers=2,
                           num_classes=2, **CPU)
    toks = rng.randint(0, 100, (4, 12))
    lens = _t([12, 5, 8, 1])
    with torch.no_grad():
        out = model(_t(toks), lens)
        assert out.shape == (4, 2)
        t2 = toks.copy()
        t2[1, 5:] = 9                       # padding invariance
        out2 = model(_t(t2), lens)
    np.testing.assert_allclose(out[1].numpy(), out2[1].numpy(), rtol=1e-4,
                               atol=1e-5)


def test_seq2seq_forward_and_grad(rng):
    model = Seq2Seq(src_vocab=40, trg_vocab=45, embed_dim=16, hidden=24,
                    **CPU)
    src = _t(rng.randint(0, 40, (3, 6)))
    trg = _t(rng.randint(0, 45, (3, 5)))
    logits = model(src, trg, _t([6, 3, 4]))
    assert logits.shape == (3, 5, 45)
    F.softmax_with_cross_entropy(logits.reshape(-1, 45),
                                 trg.reshape(-1)).mean().backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


def test_deepfm_learns_ctr():
    torch.manual_seed(0)
    model = DeepFM(num_fields=26, vocab_per_field=100, dense_dim=13,
                   embed_dim=8, mlp_dims=(32, 32), **CPU)

    def loss_fn(module, batch, generator, training):
        dense, ids, label = batch
        logit = module(dense, ids)
        return F.sigmoid_cross_entropy_with_logits(
            logit, label.float()).mean(), {}

    trainer = Trainer(model, Adam(model.parameters(), 1e-3), loss_fn)
    reader = JD.batch(ctr_synthetic(vocab_per_field=100, synthetic_n=2048),
                      64)
    losses = [float(trainer.train_step(tuple(_t(a) for a in b))["loss"])
              for b in reader()]
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_recommender_shapes(rng):
    model = Recommender(num_users=30, num_items=40, **CPU)
    score = model(_t(rng.randint(0, 30, (8,))), _t(rng.randint(0, 40, (8,))))
    assert score.shape == (8,)
    assert float(score.detach().abs().max()) <= 5.0 + 1e-5


# ---------------------------------------------------- parity with JAX

def _tree(jax_model, model, inputs, seed=0):
    """The port's weights, seeded, in JAX's layout; paths and shapes
    held to JAX's `init` (`jax.eval_shape`), loaded back by path."""
    want = jax.eval_shape(lambda *a: jax_model.init(0, *a),
                          *map(jnp.asarray, inputs))
    rs = np.random.RandomState(seed)
    flat = {k: (rs.randn(*a.shape) * (0.3 if a.ndim < 2 else
                                       (1.0 / a.shape[0]) ** 0.5)
                ).astype(np.float32)
            for k, a in flatten_with_keys(to_jax_params(model))}
    assert {k: a.shape for k, a in flat.items()} == {
        k: tuple(a.shape) for k, a in flatten_with_keys(want)}
    v = nest(flat)
    load_jax_params(model, v)
    return v


def _close(got, want, what=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 * float(np.abs(want).max()), (what, err)


def _parity(jax_model, model, inputs, jax_inputs=None):
    """Forward and d(sum(out * r)) by every parameter, in both."""
    jax_inputs = inputs if jax_inputs is None else jax_inputs
    v = _tree(jax_model, model, jax_inputs)
    jin = [jnp.asarray(a) for a in jax_inputs]
    out = jax.jit(jax_model.apply)(v, *jin)
    r = np.random.RandomState(1).randn(*np.shape(out)).astype(np.float32)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(
        jax_model.apply({"params": p}, *jin) * r)))(v["params"])
    got = model(*[_t(a) for a in inputs])
    _close(got, out, "out")
    (got * _t(r)).sum().backward()
    pg = {"params/" + param_path(n): p.grad
          for n, p in model.named_parameters()}
    jg = dict(flatten_with_keys({"params": jax.device_get(jg)}))
    assert set(pg) == set(jg)
    for k in jg:
        _close(pg[k] if pg[k] is not None else torch.zeros(jg[k].shape),
               jg[k], k)


def test_word2vec_matches_jax():
    ctx = np.random.RandomState(2).randint(0, 30, (5, 4))
    _parity(JN.Word2Vec(30, embed_dim=8, hidden=16),
            Word2Vec(30, embed_dim=8, hidden=16, **CPU), [ctx])


@pytest.mark.parametrize("pool", ["max", "average", None])
def test_text_classifier_matches_jax(pool):
    rs = np.random.RandomState(3)
    toks = rs.randint(0, 40, (3, 7))
    lens = np.array([7, 3, 5])
    kw = dict(vocab=40, embed_dim=8, hidden=12, layers=2, num_classes=3,
              pool=pool or "max")
    inputs = [toks] if pool is None else [toks, lens]
    _parity(JN.TextClassifier(**kw), TextClassifier(**kw, **CPU), inputs)


@pytest.mark.parametrize("lengths", [True, False])
def test_seq2seq_matches_jax(lengths):
    rs = np.random.RandomState(4)
    src = rs.randint(0, 20, (3, 6))
    trg = rs.randint(0, 25, (3, 5))
    kw = dict(src_vocab=20, trg_vocab=25, embed_dim=8, hidden=12)
    inputs = [src, trg] + ([np.array([6, 2, 4])] if lengths else [])
    _parity(JN.Seq2Seq(**kw), Seq2Seq(**kw, **CPU), inputs)


def test_deepfm_matches_jax():
    rs = np.random.RandomState(5)
    dense = rs.randn(6, 5).astype(np.float32)
    ids = rs.randint(0, 7, (6, 4))
    kw = dict(num_fields=4, vocab_per_field=7, dense_dim=5, embed_dim=3,
              mlp_dims=(10, 6))
    _parity(JN.DeepFM(**kw), DeepFM(**kw, **CPU), [dense, ids])


def test_recommender_matches_jax():
    rs = np.random.RandomState(6)
    u, i = rs.randint(0, 9, (7,)), rs.randint(0, 11, (7,))
    kw = dict(num_users=9, num_items=11, embed_dim=6, hidden=5)
    _parity(JN.Recommender(**kw), Recommender(**kw, **CPU), [u, i])
