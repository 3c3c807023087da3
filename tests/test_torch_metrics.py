"""The port's metrics (`paddle_tpu_torch.metrics`) against
tests/test_metrics.py, case for case, each on the same inputs as the
JAX package's metric."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from paddle_tpu import metrics as JM
from paddle_tpu_torch import metrics as M

LOGITS = np.array([[0.1, 0.9, 0.0], [0.8, 0.1, 0.1], [0.2, 0.3, 0.5],
                   [0.9, 0.05, 0.05]], np.float32)


def test_accuracy_top1_topk():
    logits, labels = torch.tensor(LOGITS), torch.tensor([1, 0, 0, 0])
    assert float(M.accuracy(logits, labels)) == 0.75
    assert float(M.accuracy(logits, labels, k=2)) == 0.75
    assert float(M.accuracy(logits, labels, k=3)) == 1.0
    want = jax.jit(lambda x, y: [JM.accuracy(x, y, k) for k in (1, 2, 3)])(
        jnp.asarray(LOGITS), jnp.asarray([1, 0, 0, 0]))
    for k, w in zip((1, 2, 3), want):
        assert float(M.accuracy(logits, labels, k)) == float(w)


def test_auc_in_graph_perfect_separation():
    probs = np.array([[0.9, 0.1], [0.8, 0.2], [0.2, 0.8], [0.1, 0.9]],
                     np.float32)
    labels = np.array([0, 0, 1, 1])
    got = float(M.auc(torch.tensor(probs), torch.tensor(labels)))
    assert got > 0.95
    assert got == float(jax.jit(JM.auc)(jnp.asarray(probs),
                                        jnp.asarray(labels)))


def test_streaming_accuracy():
    acc = M.Accuracy()
    acc.update(0.5, weight=10)
    acc.update(torch.tensor(1.0), weight=10)
    assert abs(acc.eval() - 0.75) < 1e-9


def test_precision_recall():
    p, r = M.Precision(), M.Recall()
    preds = torch.tensor([1, 1, 0, 1, 0])
    labels = np.array([1, 0, 0, 1, 1])
    p.update(preds, labels)
    r.update(preds, labels)
    assert abs(p.eval() - 2 / 3) < 1e-9
    assert abs(r.eval() - 2 / 3) < 1e-9


def test_streaming_auc():
    auc, jauc = M.Auc(num_thresholds=1023), JM.Auc(num_thresholds=1023)
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 2, 1000)
    scores = np.clip(np.where(labels, 0.7, 0.3) + rng.randn(1000) * 0.1, 0, 1)
    auc.update(torch.tensor(scores, dtype=torch.float32), torch.tensor(labels))
    jauc.update(jnp.asarray(scores, jnp.float32), jnp.asarray(labels))
    assert auc.eval() > 0.9
    assert auc.eval() == jauc.eval()


def test_edit_distance():
    ed = M.EditDistance()
    ed.update([[1, 2, 3]], [[1, 2, 3]])
    ed.update([torch.tensor([1, 2])], [torch.tensor([1, 2, 3, 4])])
    avg, exact = ed.eval()
    assert abs(avg - 0.25) < 1e-9
    assert abs(exact - 0.5) < 1e-9


def test_chunk_evaluator():
    ch = M.ChunkEvaluator()
    ch.update(10, 8, torch.tensor(6))
    p, r, f1 = ch.eval()
    assert abs(p - 0.6) < 1e-9 and abs(r - 0.75) < 1e-9
    assert abs(f1 - 2 * 0.6 * 0.75 / 1.35) < 1e-9
