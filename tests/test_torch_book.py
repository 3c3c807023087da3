"""The book chapters end to end on the port: tests/test_book_mnist.py's
`test_mnist_lenet_end_to_end`, tests/test_book_models.py's seven
chapters and tests/test_detection_model.py's
`test_ssd_trains_to_above_chance_map`, each with JAX's thresholds, on
the same seeded synthetic data (`data.datasets` yields JAX's samples bit
for bit, `tests/test_torch_data.py`), trained by the port's `Trainer`
on the CPU. JAX's `test_graft_entry_contract` tests `__graft_entry__`,
which the port does not port.
"""

import numpy as np
import pytest
import torch
from torch import nn

from paddle_tpu_torch import data
from paddle_tpu_torch.core import Trainer, supervised_loss
from paddle_tpu_torch.data import datasets, readers
from paddle_tpu_torch.io import (CheckpointManager, InferencePredictor,
                                 save_inference_model)
from paddle_tpu_torch.metrics import Accuracy, DetectionMAP, accuracy
from paddle_tpu_torch.models import LeNet
from paddle_tpu_torch.models.detection import SSDLite, ssd_detect, ssd_loss
from paddle_tpu_torch.models.nlp import (Recommender, Seq2Seq,
                                         TextClassifier, Word2Vec)
from paddle_tpu_torch.nn.layers import (Conv2D, Embedding, Linear,
                                        max_pool2d)
from paddle_tpu_torch.ops import functional as F
from paddle_tpu_torch.ops.lattice import crf_decoding, linear_chain_crf
from paddle_tpu_torch.optim import Adam
from paddle_tpu_torch.testing import one_torch_thread

CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _tensors(batch):
    return tuple(torch.from_numpy(np.asarray(b)) for b in batch)


def _first_last(trainer, batches, epochs=1):
    first = None
    for _ in range(epochs):
        for b in batches:
            fetches = trainer.train_step(b)
            if first is None:
                first = float(fetches["loss"])
    return first, float(fetches["loss"])


def _ce(logits, y):
    return F.softmax_with_cross_entropy(logits, y)


def test_mnist_lenet_end_to_end(tmp_path):
    """recognize_digits: LeNet to a falling loss and > 0.7 test accuracy,
    a checkpoint round trip, and the export's predictor classifying like
    the in-process model."""
    torch.manual_seed(0)
    train_reader = data.batch(
        data.shuffle(datasets.mnist_train(2048), buf_size=512, seed=0), 64)
    test_reader = data.batch(datasets.mnist_test(512), 64)
    loss_fn = supervised_loss(_ce, metrics={"acc": accuracy})

    def build():
        model = LeNet(num_classes=10, **CPU)
        return Trainer(model, Adam(model.parameters(), 1e-3), loss_fn,
                       seed=0)
    trainer = build()
    mgr = CheckpointManager(str(tmp_path / "ckpts"), max_to_keep=2)
    losses = []
    for _ in range(3):
        for batch in data.device_prefetch(train_reader(), size=2, **CPU):
            losses.append(float(trainer.train_step(batch)["loss"]))
        mgr.save(trainer.state(), step=trainer.step)
    assert np.mean(losses[:10]) > np.mean(losses[-10:]) * 1.5, \
        (np.mean(losses[:10]), np.mean(losses[-10:]))

    metric = Accuracy()
    for batch in test_reader():
        out = trainer.eval_step(_tensors(batch))
        metric.update(float(out["acc"]), weight=len(batch[1]))
    assert metric.eval() > 0.7, metric.eval()

    restored = build()
    ts, step = mgr.restore_latest(target=restored.state())
    restored.load_state(ts)
    assert step == trainer.step
    b = _tensors(next(iter(test_reader())))
    np.testing.assert_allclose(float(restored.eval_step(b)["loss"]),
                               float(trainer.eval_step(b)["loss"]),
                               rtol=1e-5)

    model_dir = str(tmp_path / "infer")
    x = b[0][:8].numpy()
    save_inference_model(model_dir, trainer.module, None, [x],
                         input_names=["image"])
    logits = InferencePredictor(model_dir, **CPU).run({"image": x})[0]
    with torch.no_grad():
        expected = trainer.module(b[0][:8]).numpy()
    np.testing.assert_allclose(logits, expected, rtol=1e-4, atol=1e-4)


# ------------------------------------ tests/test_book_models.py's seven

class Regression(nn.Module):
    """JAX's bare `Linear(1)`, as a model: `supervised_loss` passes every
    model a generator."""

    def __init__(self):
        super().__init__()
        self.fc = Linear(13, 1, **CPU)

    def forward(self, x, generator=None):
        return self.fc(x)


def test_fit_a_line(tmp_path):
    """Linear regression on uci_housing, and the export round trip."""
    torch.manual_seed(0)
    model = Regression()
    loss_fn = supervised_loss(
        lambda pred, y: F.square_error_cost(pred, y.reshape(pred.shape)))
    trainer = Trainer(model, Adam(model.parameters(), 1e-1), loss_fn)
    raw = list(readers.batch(datasets.uci_housing_train(), 64)())
    allx = np.concatenate([b[0] for b in raw])
    mu, sd = allx.mean(0), allx.std(0) + 1e-6
    batches = [_tensors(((b[0] - mu) / sd, b[1])) for b in raw]
    first, last = _first_last(trainer, batches, epochs=60)
    assert last < first * 0.5, (first, last)

    path = str(tmp_path / "fit_a_line")
    save_inference_model(path, model, None, [np.zeros((64, 13), np.float32)],
                         input_names=["x"])
    x = batches[0][0]
    out = InferencePredictor(path, **CPU).run({"x": x.numpy()})[0]
    with torch.no_grad():
        want = model(x).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)


class SmallConv(nn.Module):
    def __init__(self):
        super().__init__()
        self.c1 = Conv2D(3, 32, 3, padding="SAME", **CPU)
        self.c2 = Conv2D(32, 64, 3, padding="SAME", **CPU)
        self.fc = Linear(8 * 8 * 64, 10, **CPU)

    def forward(self, x, generator=None):
        x = max_pool2d(F.relu(self.c1(x)), 2, 2)
        x = max_pool2d(F.relu(self.c2(x)), 2, 2)
        return self.fc(x.reshape(x.shape[0], -1))


def test_image_classification_cifar():
    torch.manual_seed(0)
    model = SmallConv()
    trainer = Trainer(model, Adam(model.parameters(), 1e-3),
                      supervised_loss(_ce, metrics={"acc": accuracy}))
    batches = [_tensors(b) for b in readers.batch(
        datasets.cifar10_train(synthetic_n=256), 64)()]
    first, last = _first_last(trainer, batches, epochs=4)
    assert last < first, (first, last)


def test_word2vec():
    torch.manual_seed(0)
    vocab = 256
    model = Word2Vec(vocab=vocab, embed_dim=16, hidden=64, context=4, **CPU)
    trainer = Trainer(model, Adam(model.parameters(), 5e-3),
                      supervised_loss(_ce))
    batches = [_tensors(b) for b in readers.batch(
        datasets.imikolov_ngram_train(vocab=vocab, synthetic_n=512), 64)()]
    first, last = _first_last(trainer, batches, epochs=6)
    assert last < first * 0.9, (first, last)


def _rows_to_batches(rows, size, fields):
    return [tuple(torch.from_numpy(np.stack([r[j] for r in rows[i:i + size]]))
                  for j in fields)
            for i in range(0, len(rows) - size + 1, size)]


def test_recommender_system():
    torch.manual_seed(0)
    model = Recommender(num_users=128, num_items=64, embed_dim=16, **CPU)

    def loss_fn(module, batch, generator, training):
        u, m, r = batch
        return torch.mean(F.square_error_cost(module(u, m), r)), {}
    trainer = Trainer(model, Adam(model.parameters(), 5e-3), loss_fn)
    rows = list(datasets.movielens_train(num_users=128, num_movies=64,
                                         synthetic_n=512)())
    batches = _rows_to_batches(rows, 64, (0, 4, 6))
    first, last = _first_last(trainer, batches, epochs=8)
    assert last < first * 0.8, (first, last)


def test_label_semantic_roles_crf():
    """An embeddings + projection + linear-chain CRF tagger on conll05,
    decoded with Viterbi."""
    torch.manual_seed(0)
    vocab, nlab, seqlen = 200, 9, 16

    class SRL(nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = Embedding(vocab, 32, **CPU)
            self.mark_embed = Embedding(2, 8, **CPU)
            self.fc = Linear(40, 64, **CPU)
            self.emit = Linear(64, nlab, **CPU)
            # the CRF transitions, a trainable leaf beside the layers
            self.crf_transitions = nn.Parameter(torch.zeros(nlab + 2, nlab))

        def forward(self, words, mark):
            h = torch.cat([self.embed(words), self.mark_embed(mark)], -1)
            return self.emit(F.relu(self.fc(h)))
    model = SRL()

    def loss_fn(module, batch, generator, training):
        words, mark, lengths, labels = batch
        nll = linear_chain_crf(module(words, mark), labels,
                               module.crf_transitions, lengths)
        return torch.mean(nll), {}
    trainer = Trainer(model, Adam(model.parameters(), 5e-3), loss_fn)
    rows = list(datasets.conll05_train(vocab=vocab, num_labels=nlab,
                                       seq_len=seqlen, synthetic_n=256)())
    batches = _rows_to_batches(rows, 32, range(4))
    first, last = _first_last(trainer, batches, epochs=6)
    assert last < first * 0.9, (first, last)

    words, mark, lengths, _ = batches[0]
    with torch.no_grad():
        path, _ = crf_decoding(model(words, mark), model.crf_transitions,
                               lengths)
    assert path.shape == words.shape
    assert torch.all(path[torch.arange(seqlen)[None] >= lengths[:, None]]
                     == 0)


def test_rnn_encoder_decoder_machine_translation():
    """GRU attention seq2seq on synthetic WMT."""
    torch.manual_seed(0)
    sv = tv = 64
    model = Seq2Seq(src_vocab=sv, trg_vocab=tv, embed_dim=16, hidden=32,
                    **CPU)

    def loss_fn(module, batch, generator, training):
        src, trg_in, trg_out = batch
        return torch.mean(_ce(module(src, trg_in), trg_out)), {}
    trainer = Trainer(model, Adam(model.parameters(), 5e-3), loss_fn)
    rows = list(datasets.wmt_synthetic(src_vocab=sv, trg_vocab=tv,
                                       seq_len=10, synthetic_n=256)())
    batches = [(src, trg[:, :-1], trg[:, 1:])
               for src, trg in _rows_to_batches(rows, 32, (0, 2))]
    first, last = _first_last(trainer, batches, epochs=6)
    assert last < first * 0.9, (first, last)


def test_understand_sentiment():
    """Stacked-LSTM sentiment on the sentiment reader."""
    torch.manual_seed(0)
    vocab = 200
    model = TextClassifier(vocab=vocab, embed_dim=16, hidden=32, layers=1,
                           **CPU)
    trainer = Trainer(model, Adam(model.parameters(), 5e-3),
                      supervised_loss(_ce, metrics={"acc": accuracy}))
    rows = list(datasets.sentiment_train(vocab=vocab, seq_len=24,
                                         synthetic_n=256)())
    batches = _rows_to_batches(rows, 32, (0, 2))
    first, last = _first_last(trainer, batches, epochs=4)
    assert last < first * 0.95, (first, last)


# ------------------- tests/test_detection_model.py's training chapter

def test_ssd_trains_to_above_chance_map():
    """SSD-lite on the voc2012 reader: the loss falls below 0.7 of its
    first value, and the mAP on the training set is above chance."""
    torch.manual_seed(0)
    img, ncls = 96, 4
    model = SSDLite(num_classes=ncls, image_size=img, **CPU)
    priors, prior_var = model.priors()

    def loss_fn(module, batch, generator, training):
        image, boxes, labels, nb = batch
        cls, loc = module(image)
        return ssd_loss(cls, loc, priors, boxes, labels, nb), {}
    trainer = Trainer(model, Adam(model.parameters(), 3e-3), loss_fn)
    rows = list(datasets.voc2012_train(image_size=img, num_classes=ncls,
                                       max_boxes=4, synthetic_n=64)())
    batches = _rows_to_batches(rows, 8, range(4))
    first, last = _first_last(trainer, batches, epochs=6)
    assert last < first * 0.7, (first, last)

    metric = DetectionMAP(overlap_threshold=0.4)
    model.eval()
    for image, boxes, labels, nb in batches:
        with torch.no_grad():
            cls, loc = model(image)
        dets, counts = ssd_detect(cls, loc, priors, prior_var,
                                  score_threshold=0.25)
        for i in range(image.shape[0]):
            n = int(nb[i])
            gt = np.concatenate([labels[i][:n].numpy()[:, None],
                                 boxes[i][:n].numpy()], axis=1)
            metric.update(dets[i][:int(counts[i])].numpy(), gt)
    score = metric.eval()
    assert score > 0.15, f"mAP {score} not above chance"
