"""Built-in datasets (the port's own copy of paddle_tpu/data/datasets.py,
pure numpy).

Capability-equivalent of Paddle's python/paddle/dataset/ (mnist, cifar,
uci_housing, imdb, imikolov, wmt, movielens, ...): each dataset exposes
`train()`/`test()` reader factories yielding numpy samples. Nothing is
downloaded, so each dataset has two paths:
1. If the raw files exist under FLAGS_data_dir (user-provided), load them
   (MNIST idx format, CIFAR pickle, housing csv: the formats Paddle's
   download cache stores). The flag's default is the JAX package's
   directory, so both packages read the same files.
2. Otherwise fall back to a *deterministic synthetic* generator with the
   exact shapes/dtypes/cardinalities of the real dataset, seeded and
   learnable (labels correlate with inputs), which yields the JAX
   package's samples bit for bit.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from paddle_tpu_torch.utils.flags import FLAGS

FLAGS.define("data_dir", os.path.expanduser("~/.cache/paddle_tpu/dataset"),
             "Directory holding raw dataset files (reference: "
             "paddle.dataset.common.DATA_HOME).")


# ----------------------------------------------------------------- synthetic

def _synthetic_classification(n: int, shape: Tuple[int, ...], num_classes: int,
                              seed: int, template_seed: int = 1234) -> Callable:
    """Learnable synthetic data: label = argmax over class-template dot
    products + noise. A linear probe reaches high accuracy, so convergence
    tests exercise real optimisation dynamics. `template_seed` fixes the
    class templates so train/test splits (different `seed`) share the same
    underlying concept — like real dataset splits do."""
    def reader() -> Iterator:
        dim = int(np.prod(shape))
        templates = np.random.RandomState(
            template_seed + dim * 31 + num_classes).randn(
            num_classes, dim).astype(np.float32)
        rng = np.random.RandomState(seed)
        for start in range(0, n, 256):
            m = min(256, n - start)
            noise = rng.randn(m, dim).astype(np.float32)
            labels = rng.randint(0, num_classes, size=m)
            x = 0.6 * templates[labels] + noise
            for i in range(m):
                yield x[i].reshape(shape), np.int64(labels[i])
    return reader


def _synthetic_regression(n: int, dim: int, seed: int) -> Callable:
    def reader() -> Iterator:
        rng = np.random.RandomState(seed)
        w = rng.randn(dim).astype(np.float32)
        for _ in range(n):
            x = rng.randn(dim).astype(np.float32)
            y = np.float32(x @ w + 0.1 * rng.randn())
            yield x, np.array([y], np.float32)
    return reader


# --------------------------------------------------------------------- MNIST

def _mnist_files(prefix: str):
    d = FLAGS.get("data_dir")
    img = os.path.join(d, "mnist", f"{prefix}-images-idx3-ubyte.gz")
    lbl = os.path.join(d, "mnist", f"{prefix}-labels-idx1-ubyte.gz")
    return (img, lbl) if os.path.exists(img) and os.path.exists(lbl) else None


def _mnist_reader(img_path: str, lbl_path: str) -> Callable:
    """Parse the idx format (reference: dataset/mnist.py reader_creator)."""
    def reader() -> Iterator:
        with gzip.open(img_path, "rb") as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            images = np.frombuffer(f.read(), np.uint8).reshape(n, rows, cols)
        with gzip.open(lbl_path, "rb") as f:
            struct.unpack(">II", f.read(8))
            labels = np.frombuffer(f.read(), np.uint8)
        for i in range(len(labels)):
            img = images[i].astype(np.float32) / 127.5 - 1.0
            yield img.reshape(28, 28, 1), np.int64(labels[i])
    return reader


def mnist_train(synthetic_n: int = 8192) -> Callable:
    files = _mnist_files("train")
    if files:
        return _mnist_reader(*files)
    return _synthetic_classification(synthetic_n, (28, 28, 1), 10, seed=0)


def mnist_test(synthetic_n: int = 1024) -> Callable:
    files = _mnist_files("t10k")
    if files:
        return _mnist_reader(*files)
    return _synthetic_classification(synthetic_n, (28, 28, 1), 10, seed=1)


# --------------------------------------------------------------------- CIFAR

def _cifar_reader(tar_path: str, member_match: str) -> Callable:
    """Parse the CIFAR python-pickle tarball (reference dataset/cifar.py
    reader_creator): batches of {data [N,3072], labels} dicts. Matches
    cifar-10's data_batch_N/test_batch and cifar-100's train/test members
    (metadata members are excluded by suffix)."""
    def reader() -> Iterator:
        import pickle
        import tarfile
        with tarfile.open(tar_path, "r:*") as tf:
            names = sorted(
                m.name for m in tf.getmembers()
                if m.isfile()
                and m.name.rsplit("/", 1)[-1].startswith(member_match)
                and "meta" not in m.name and not m.name.endswith(".html"))
            for name in names:
                obj = pickle.load(tf.extractfile(name), encoding="bytes")
                data = obj[b"data"]
                key = (b"fine_labels" if b"fine_labels" in obj
                       else b"labels")
                labels = obj[key]
                for row, lbl in zip(data, labels):
                    img = row.reshape(3, 32, 32).transpose(1, 2, 0)
                    yield (img.astype(np.float32) / 127.5 - 1.0,
                           np.int64(lbl))
    return reader


def _cifar_path(name: str):
    p = os.path.join(FLAGS.get("data_dir"), "cifar", name)
    return p if os.path.exists(p) else None


def cifar10_train(synthetic_n: int = 8192) -> Callable:
    p = _cifar_path("cifar-10-python.tar.gz")
    if p:
        return _cifar_reader(p, "data_batch")
    return _synthetic_classification(synthetic_n, (32, 32, 3), 10, seed=2)


def cifar10_test(synthetic_n: int = 1024) -> Callable:
    p = _cifar_path("cifar-10-python.tar.gz")
    if p:
        return _cifar_reader(p, "test_batch")
    return _synthetic_classification(synthetic_n, (32, 32, 3), 10, seed=3)


def cifar100_train(synthetic_n: int = 8192) -> Callable:
    p = _cifar_path("cifar-100-python.tar.gz")
    if p:
        return _cifar_reader(p, "train")
    return _synthetic_classification(synthetic_n, (32, 32, 3), 100, seed=12)


def cifar100_test(synthetic_n: int = 1024) -> Callable:
    p = _cifar_path("cifar-100-python.tar.gz")
    if p:
        return _cifar_reader(p, "test")
    return _synthetic_classification(synthetic_n, (32, 32, 3), 100, seed=13)


def flowers_train(synthetic_n: int = 2048, image_size: int = 224) -> Callable:
    return _synthetic_classification(
        synthetic_n, (image_size, image_size, 3), 102, seed=4)


# ------------------------------------------------------------------- housing

def _housing_rows():
    """Parse housing.data (reference dataset/uci_housing.py load_data:
    whitespace table, feature-normalised, 80/20 split)."""
    p = os.path.join(FLAGS.get("data_dir"), "uci_housing", "housing.data")
    if not os.path.exists(p):
        return None
    raw = np.loadtxt(p).astype(np.float32)
    x, y = raw[:, :-1], raw[:, -1:]
    lo, hi, avg = x.min(0), x.max(0), x.mean(0)
    x = (x - avg) / np.maximum(hi - lo, 1e-6)
    return x, y


def _housing_reader(split: str) -> Optional[Callable]:
    rows = _housing_rows()
    if rows is None:
        return None
    x, y = rows
    cut = int(len(x) * 0.8)
    sl = slice(0, cut) if split == "train" else slice(cut, None)

    def reader() -> Iterator:
        for xi, yi in zip(x[sl], y[sl]):
            yield xi, yi
    return reader


def uci_housing_train(synthetic_n: int = 404) -> Callable:
    """fit_a_line dataset (reference dataset/uci_housing.py: 13 features)."""
    return _housing_reader("train") or _synthetic_regression(
        synthetic_n, 13, seed=5)


def uci_housing_test(synthetic_n: int = 102) -> Callable:
    return _housing_reader("test") or _synthetic_regression(
        synthetic_n, 13, seed=6)


# ------------------------------------------------------------------ language

def _synthetic_lm(n: int, vocab: int, seq_len: int, seed: int) -> Callable:
    """Markov-chain token streams: next token depends on current, so language
    models have real signal to learn (≈ imikolov capability)."""
    def reader() -> Iterator:
        rng = np.random.RandomState(seed)
        trans = rng.dirichlet(np.ones(vocab) * 0.05, size=vocab)
        for _ in range(n):
            seq = np.empty(seq_len + 1, np.int64)
            seq[0] = rng.randint(vocab)
            for t in range(1, seq_len + 1):
                seq[t] = rng.choice(vocab, p=trans[seq[t - 1]])
            yield seq[:-1], seq[1:]
    return reader


def imikolov_train(vocab: int = 2048, seq_len: int = 20,
                   synthetic_n: int = 4096) -> Callable:
    return _synthetic_lm(synthetic_n, vocab, seq_len, seed=7)


def imdb_train(vocab: int = 5000, seq_len: int = 128,
               synthetic_n: int = 2048) -> Callable:
    """Sentiment classification: ragged sequences + binary label.

    Yields (tokens[int64 seq_len], length, label); label correlates with the
    prevalence of a "positive" token subset so classifiers can learn.
    """
    def reader() -> Iterator:
        rng = np.random.RandomState(8)
        pos_tokens = rng.choice(vocab, vocab // 8, replace=False)
        pos_mask = np.zeros(vocab, bool)
        pos_mask[pos_tokens] = True
        for _ in range(synthetic_n):
            length = rng.randint(seq_len // 4, seq_len + 1)
            label = rng.randint(2)
            if label:
                probs = np.where(pos_mask, 4.0, 1.0)
            else:
                probs = np.where(pos_mask, 0.25, 1.0)
            probs = probs / probs.sum()
            toks = rng.choice(vocab, size=length, p=probs)
            padded = np.zeros(seq_len, np.int64)
            padded[:length] = toks
            yield padded, np.int64(length), np.int64(label)
    return reader


def wmt_synthetic(src_vocab: int = 4096, trg_vocab: int = 4096,
                  seq_len: int = 32, synthetic_n: int = 2048,
                  seed: int = 9) -> Callable:
    """Translation pairs where target is a learnable function of source
    (token-wise affine map mod vocab) — stands in for wmt14/16."""
    def reader() -> Iterator:
        rng = np.random.RandomState(seed)
        perm = rng.permutation(src_vocab) % trg_vocab
        for _ in range(synthetic_n):
            n = rng.randint(seq_len // 2, seq_len + 1)
            src = np.zeros(seq_len, np.int64)
            trg = np.zeros(seq_len, np.int64)
            toks = rng.randint(1, src_vocab, size=n)
            src[:n] = toks
            trg[:n] = perm[toks]
            yield src, np.int64(n), trg
    return reader



def movielens_train(num_users: int = 6040, num_movies: int = 3952,
                    num_genres: int = 18, synthetic_n: int = 8192,
                    seed: int = 14) -> Callable:
    """Recommender rows (reference dataset/movielens.py ml-1m): yields
    (user_id, gender, age_bucket, occupation, movie_id, genres_multihot,
    rating). Loads the ml-1m ratings.dat/users.dat/movies.dat files when
    present under data_dir; synthetic latent-factor ratings otherwise."""
    d = os.path.join(FLAGS.get("data_dir"), "ml-1m")
    if os.path.exists(os.path.join(d, "ratings.dat")):
        return _movielens_file_reader(d, num_genres)

    def reader() -> Iterator:
        rng = np.random.RandomState(seed)
        uf = rng.randn(num_users, 8).astype(np.float32)
        mf = rng.randn(num_movies, 8).astype(np.float32)
        for _ in range(synthetic_n):
            u = rng.randint(num_users)
            m = rng.randint(num_movies)
            score = uf[u] @ mf[m] / np.sqrt(8) + 0.3 * rng.randn()
            rating = np.float32(np.clip(np.round(3 + score), 1, 5))
            genres = np.zeros(num_genres, np.float32)
            genres[rng.choice(num_genres, rng.randint(1, 4),
                              replace=False)] = 1.0
            yield (np.int64(u), np.int64(rng.randint(2)),
                   np.int64(rng.randint(7)), np.int64(rng.randint(21)),
                   np.int64(m), genres, rating)
    return reader


def _movielens_file_reader(d: str, num_genres: int) -> Callable:
    GENRES = ["Action", "Adventure", "Animation", "Children's", "Comedy",
              "Crime", "Documentary", "Drama", "Fantasy", "Film-Noir",
              "Horror", "Musical", "Mystery", "Romance", "Sci-Fi",
              "Thriller", "War", "Western"]
    AGES = {1: 0, 18: 1, 25: 2, 35: 3, 45: 4, 50: 5, 56: 6}

    def reader() -> Iterator:
        users, movies = {}, {}
        with open(os.path.join(d, "users.dat"), encoding="latin1") as f:
            for line in f:
                uid, gender, age, occ, _ = line.strip().split("::")
                users[int(uid)] = (np.int64(gender == "F"),
                                   np.int64(AGES.get(int(age), 0)),
                                   np.int64(occ))
        with open(os.path.join(d, "movies.dat"), encoding="latin1") as f:
            for line in f:
                mid, _, genres = line.strip().split("::")
                g = np.zeros(num_genres, np.float32)
                for name in genres.split("|"):
                    if name in GENRES and GENRES.index(name) < num_genres:
                        g[GENRES.index(name)] = 1.0
                movies[int(mid)] = g
        with open(os.path.join(d, "ratings.dat"), encoding="latin1") as f:
            for line in f:
                uid, mid, rating, _ = line.strip().split("::")
                u, m = int(uid), int(mid)
                if u in users and m in movies:
                    g, a, o = users[u]
                    yield (np.int64(u), g, a, o, np.int64(m), movies[m],
                           np.float32(rating))
    return reader


# ----------------------------------------------------------------- conll05

def conll05_train(vocab: int = 5000, num_labels: int = 67, seq_len: int = 40,
                  synthetic_n: int = 2048, seed: int = 15) -> Callable:
    """Semantic-role labeling rows (reference dataset/conll05.py,
    label_semantic_roles book chapter): yields (words, predicate_pos_mark,
    length, bio_labels) — labels correlate with distance to the predicate
    so taggers can learn."""
    def reader() -> Iterator:
        rng = np.random.RandomState(seed)
        for _ in range(synthetic_n):
            n = rng.randint(seq_len // 3, seq_len + 1)
            words = np.zeros(seq_len, np.int64)
            words[:n] = rng.randint(1, vocab, n)
            pred = rng.randint(n)
            mark = np.zeros(seq_len, np.int64)
            mark[pred] = 1
            labels = np.zeros(seq_len, np.int64)
            dist = np.abs(np.arange(n) - pred)
            labels[:n] = (dist + words[:n]) % num_labels
            yield words, mark, np.int64(n), labels
    return reader


# ----------------------------------------------------------------- voc2012

def voc2012_train(image_size: int = 224, num_classes: int = 20,
                  max_boxes: int = 8, synthetic_n: int = 512,
                  seed: int = 16) -> Callable:
    """Detection rows (reference dataset/voc2012.py): yields
    (image [S,S,3], boxes [max_boxes,4] normalized xyxy, labels
    [max_boxes], num_boxes). Boxes paint bright rectangles into the image
    so detectors have signal."""
    def reader() -> Iterator:
        rng = np.random.RandomState(seed)
        for _ in range(synthetic_n):
            img = rng.randn(image_size, image_size, 3).astype(np.float32) * .1
            nb = rng.randint(1, max_boxes + 1)
            boxes = np.zeros((max_boxes, 4), np.float32)
            labels = np.zeros(max_boxes, np.int64)
            for b in range(nb):
                x1, y1 = rng.uniform(0, 0.7, 2)
                w, h = rng.uniform(0.1, 0.3, 2)
                boxes[b] = [x1, y1, min(x1 + w, 1.0), min(y1 + h, 1.0)]
                labels[b] = rng.randint(num_classes)
                px = (boxes[b] * image_size).astype(int)
                img[px[1]:px[3], px[0]:px[2], labels[b] % 3] += 1.0
            yield img, boxes, labels, np.int64(nb)
    return reader


# --------------------------------------------------------------- sentiment

def sentiment_train(vocab: int = 5000, seq_len: int = 100,
                    synthetic_n: int = 2048) -> Callable:
    """Movie-review sentiment (reference dataset/sentiment.py; same row
    shape as imdb): (tokens, length, label)."""
    return imdb_train(vocab=vocab, seq_len=seq_len, synthetic_n=synthetic_n)


# ------------------------------------------------------------------ mq2007

def mq2007_train(num_queries: int = 128, docs_per_query: int = 16,
                 feature_dim: int = 46, seed: int = 17) -> Callable:
    """Learning-to-rank rows (reference dataset/mq2007.py, pairwise mode):
    yields (features [D, F], relevance [D]) per query group; relevance is
    a noisy linear function of features so rankers can learn."""
    def reader() -> Iterator:
        rng = np.random.RandomState(seed)
        w = rng.randn(feature_dim).astype(np.float32)
        for _ in range(num_queries):
            feats = rng.randn(docs_per_query, feature_dim).astype(np.float32)
            scores = feats @ w + 0.2 * rng.randn(docs_per_query)
            rel = np.clip(np.digitize(
                scores, [-0.8, 0.8]), 0, 2).astype(np.int64)
            yield feats, rel
    return reader


# --------------------------------------------------------------- word2vec

def imikolov_ngram_train(vocab: int = 2048, context: int = 4,
                         synthetic_n: int = 8192, seed: int = 18
                         ) -> Callable:
    """N-gram rows for the word2vec book chapter (reference
    dataset/imikolov.py NGRAM mode): (context_tokens [C], next_token)."""
    lm = _synthetic_lm(synthetic_n, vocab, context * 4, seed)

    def reader() -> Iterator:
        count = 0
        for seq, nxt in lm():
            full = np.concatenate([seq, nxt[-1:]])
            for i in range(len(full) - context):
                yield full[i:i + context], np.int64(full[i + context])
                count += 1
                if count >= synthetic_n:
                    return
    return reader


# ----------------------------------------------------------------------- CTR

def ctr_synthetic(num_fields: int = 26, vocab_per_field: int = 1000,
                  dense_dim: int = 13, synthetic_n: int = 8192,
                  seed: int = 10) -> Callable:
    """Criteo-style CTR rows: dense features + sparse categorical ids +
    click label (≈ dataset used by dist_ctr.py / DeepFM in BASELINE)."""
    def reader() -> Iterator:
        rng = np.random.RandomState(seed)
        field_w = rng.randn(num_fields, vocab_per_field).astype(np.float32)
        dense_w = rng.randn(dense_dim).astype(np.float32)
        for _ in range(synthetic_n):
            dense = rng.randn(dense_dim).astype(np.float32)
            ids = rng.randint(0, vocab_per_field, size=num_fields)
            logit = dense @ dense_w * 0.3 + field_w[
                np.arange(num_fields), ids].sum() * 0.3
            label = np.int64(rng.rand() < 1 / (1 + np.exp(-logit)))
            yield dense, ids.astype(np.int64), label
    return reader
