"""The port's `data/` against tests/test_data.py's seven tests and
tests/test_datasets.py's twenty-two, and against the JAX package: every
reader, transform, parser and cache helper runs through both
`paddle_tpu_torch.data` and `paddle_tpu.data` on the same inputs, and
the two results must be equal bit for bit (`_both`), besides the
property checks of the JAX tests. The file parsers read one directory,
both packages' `data_dir` pointed at it; so do the synthetic datasets
(`test_synthetic_samples_equal_jax`), the directory empty so both take
the synthetic path. The feeders put batches on the card by default;
these tests ask for the CPU.
"""

import gzip
import pickle
import struct
import tarfile

import numpy as np
import pytest
import torch

import paddle_tpu.data as jax_data
from paddle_tpu.data import datasets as jax_datasets
from paddle_tpu.utils.flags import FLAGS as JAX_FLAGS
from paddle_tpu_torch import data
from paddle_tpu_torch.data import datasets
from paddle_tpu_torch.testing import assert_same_bits
from paddle_tpu_torch.utils.flags import FLAGS


def _both(run):
    """`run(package)` through the port's `data` and the JAX package's on
    the same inputs; the results equal bit for bit. Returns the port's."""
    got = run(data)
    assert_same_bits(got, run(jax_data))
    return got


def _both_raise(exc, match, run):
    """`run(package)` raises `exc` with the same message in both."""
    msgs = []
    for pkg in (data, jax_data):
        with pytest.raises(exc, match=match) as info:
            run(pkg)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def _on_cpu(pkg):
    """The port's feeders default to the card; JAX's to its device."""
    return {"device": "cpu"} if pkg is data else {}


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    """Point both packages' `data_dir` flag at one directory."""
    monkeypatch.setitem(FLAGS._values, "data_dir", str(tmp_path))
    monkeypatch.setitem(JAX_FLAGS._values, "data_dir", str(tmp_path))
    return tmp_path


# ------------------------------------------ tests/test_data.py's seven

def _counter(n):
    def reader():
        return iter(range(n))
    return reader


def test_shuffle_preserves_multiset():
    out = _both(lambda p: list(p.shuffle(_counter(20), buf_size=7,
                                         seed=3)()))
    assert sorted(out) == list(range(20))
    assert out != list(range(20))


def test_book_pipeline_equals_jax():
    """The `book` chapters' pipeline: seeded shuffle of synthetic MNIST
    in a 512-sample buffer, batched by 64; JAX's batches and order."""
    batches = _both(lambda p: list(p.batch(p.shuffle(
        p.datasets.mnist_train(640), buf_size=512, seed=0), 64)()))
    assert len(batches) == 10 and batches[0][0].shape == (64, 28, 28, 1)


def test_chain_compose_firstn():
    assert _both(lambda p: list(p.chain(_counter(3), _counter(2))())) \
        == [0, 1, 2, 0, 1]
    composed = _both(lambda p: list(p.compose(_counter(3), _counter(3))()))
    assert composed == [(0, 0), (1, 1), (2, 2)]
    assert _both(lambda p: list(p.firstn(_counter(100), 5)())) \
        == [0, 1, 2, 3, 4]
    assert _both(lambda p: list(p.map_readers(
        lambda a, b: a * 10 + b, _counter(4), _counter(4))())) \
        == [0, 11, 22, 33]


def test_buffered_and_xmap():
    assert _both(lambda p: list(p.buffered(_counter(10), 3)())) \
        == list(range(10))
    out = _both(lambda p: list(p.xmap_readers(
        lambda x: x * 2, _counter(10), 4, 8, order=True)()))
    assert out == [2 * i for i in range(10)]
    # unordered: the threads' interleaving differs run to run, so the
    # multisets are compared
    unordered = _both(lambda p: sorted(p.xmap_readers(
        lambda x: x * 2, _counter(10), 4, 8)()))
    assert unordered == [2 * i for i in range(10)]


def test_batch_collate():
    def reader():
        for i in range(10):
            yield np.full((3,), i, np.float32), np.int64(i)
    batches = _both(lambda p: list(p.batch(reader, 4)()))
    assert len(batches) == 2  # drop_last
    x, y = batches[0]
    assert x.shape == (4, 3) and y.shape == (4,)
    batches = _both(lambda p: list(p.batch(reader, 4, drop_last=False)()))
    assert batches[-1][0].shape == (2, 3)


def test_mnist_synthetic_learnable_shapes():
    samples = _both(lambda p: list(p.firstn(p.datasets.mnist_train(512),
                                            512)()))
    x, y = samples[0]
    assert x.shape == (28, 28, 1) and x.dtype == np.float32
    labels = np.array([s[1] for s in samples])
    assert set(labels) <= set(range(10))
    # deterministic across invocations
    again = next(datasets.mnist_train(512)())
    np.testing.assert_array_equal(x, again[0])


def test_device_prefetch_order():
    def reader():
        for i in range(7):
            yield np.full((2,), i, np.float32)
    out = _both(lambda p: list(p.device_prefetch(reader(), size=2,
                                                 **_on_cpu(p))))
    assert [int(b[0]) for b in out] == list(range(7))
    assert all(isinstance(b, torch.Tensor) for b in out)


def test_ctr_and_imdb_shapes():
    dense, ids, label = _both(lambda p: next(p.datasets.ctr_synthetic(
        synthetic_n=4)()))
    assert dense.shape == (13,) and ids.shape == (26,)
    toks, length, label = _both(lambda p: next(p.datasets.imdb_train(
        synthetic_n=2)()))
    assert toks.shape == (128,) and 0 < int(length) <= 128

# ------------------------------------ tests/test_datasets.py's twenty-two

def _first(name, n=3, **kw):
    """The first `n` samples of dataset `name`, equal in both packages."""
    def run(p):
        it = getattr(p.datasets, name)(**kw)()
        return [next(it) for _ in range(n)]
    return _both(run)


def test_mnist_synthetic_rows():
    for img, lbl in _first("mnist_train"):
        assert img.shape == (28, 28, 1) and img.dtype == np.float32
        assert 0 <= int(lbl) < 10


def test_cifar_synthetic_rows():
    for img, lbl in _first("cifar10_train"):
        assert img.shape == (32, 32, 3)
    for img, lbl in _first("cifar100_train"):
        assert 0 <= int(lbl) < 100


def test_movielens_rows():
    for u, g, a, o, m, genres, r in _first("movielens_train"):
        assert genres.shape == (18,)
        assert 1.0 <= float(r) <= 5.0
        assert int(g) in (0, 1)


def test_conll05_rows():
    for words, mark, n, labels in _first("conll05_train"):
        assert words.shape == labels.shape == mark.shape
        assert int(mark.sum()) == 1          # one predicate
        assert int(n) <= words.shape[0]
        assert np.all(labels[int(n):] == 0)


def test_voc2012_rows():
    for img, boxes, labels, nb in _first("voc2012_train", image_size=64):
        assert img.shape == (64, 64, 3)
        assert boxes.shape == (8, 4) and labels.shape == (8,)
        b = boxes[:int(nb)]
        assert np.all(b[:, 2] >= b[:, 0]) and np.all(b <= 1.0)


def test_mq2007_rows():
    for feats, rel in _first("mq2007_train"):
        assert feats.shape == (16, 46)
        assert rel.shape == (16,) and set(np.unique(rel)) <= {0, 1, 2}


def test_imikolov_ngram_rows():
    for ctx, nxt in _first("imikolov_ngram_train", context=4):
        assert ctx.shape == (4,) and np.isscalar(int(nxt))


def _rows(name):
    """Every sample of dataset `name` read from `data_dir`'s files, equal
    in both packages."""
    return _both(lambda p: list(getattr(p.datasets, name)()()))


def test_mnist_idx_file_parser(data_dir):
    """Write real idx-format files and check the parser path engages."""
    d = data_dir / "mnist"
    d.mkdir()
    images = np.arange(2 * 28 * 28, dtype=np.uint8).reshape(2, 28, 28)
    labels = np.array([3, 7], np.uint8)
    with gzip.open(d / "train-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 2, 28, 28) + images.tobytes())
    with gzip.open(d / "train-labels-idx1-ubyte.gz", "wb") as f:
        f.write(struct.pack(">II", 2049, 2) + labels.tobytes())
    rows = _rows("mnist_train")
    assert len(rows) == 2
    assert int(rows[0][1]) == 3 and int(rows[1][1]) == 7
    assert rows[0][0].shape == (28, 28, 1)


def test_cifar_pickle_tar_parser(data_dir):
    d = data_dir / "cifar"
    d.mkdir()
    pixels = np.random.RandomState(0).randint(
        0, 256, (4, 3072)).astype(np.uint8)
    batch = {b"data": pixels, b"labels": [0, 1, 2, 3]}
    inner = data_dir / "data_batch_1"
    with open(inner, "wb") as f:
        pickle.dump(batch, f)
    with tarfile.open(d / "cifar-10-python.tar.gz", "w:gz") as tf:
        tf.add(inner, arcname="cifar-10-batches-py/data_batch_1")
    rows = _rows("cifar10_train")
    assert len(rows) == 4
    assert rows[0][0].shape == (32, 32, 3)
    assert [int(r[1]) for r in rows] == [0, 1, 2, 3]


def test_cifar100_pickle_tar_parser(data_dir):
    """cifar-100 members are named 'train'/'test' (no digits, no 'batch')
    — the filter must still find them and use fine_labels."""
    d = data_dir / "cifar"
    d.mkdir()
    pixels = np.random.RandomState(0).randint(
        0, 256, (3, 3072)).astype(np.uint8)
    batch = {b"data": pixels, b"fine_labels": [10, 20, 99],
             b"coarse_labels": [1, 2, 3]}
    inner = data_dir / "train"
    with open(inner, "wb") as f:
        pickle.dump(batch, f)
    with tarfile.open(d / "cifar-100-python.tar.gz", "w:gz") as tf:
        tf.add(inner, arcname="cifar-100-python/train")
        meta = data_dir / "meta"
        meta.write_bytes(pickle.dumps({b"fine_label_names": []}))
        tf.add(meta, arcname="cifar-100-python/meta")
    rows = _rows("cifar100_train")
    assert len(rows) == 3
    assert [int(r[1]) for r in rows] == [10, 20, 99]


def test_mnist_test_split_idx_parser(data_dir):
    """The t10k-prefixed test-split files engage the same idx parser."""
    d = data_dir / "mnist"
    d.mkdir()
    images = np.full((1, 28, 28), 9, np.uint8)
    with gzip.open(d / "t10k-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 1, 28, 28) + images.tobytes())
    with gzip.open(d / "t10k-labels-idx1-ubyte.gz", "wb") as f:
        f.write(struct.pack(">II", 2049, 1) + np.array([5], np.uint8)
                .tobytes())
    rows = _rows("mnist_test")
    assert len(rows) == 1 and int(rows[0][1]) == 5


def test_cifar_test_split_members(data_dir):
    """cifar-10 'test_batch' and cifar-100 'test' members engage the
    file parser for the *_test reader factories too."""
    d = data_dir / "cifar"
    d.mkdir()
    pixels = np.random.RandomState(1).randint(
        0, 256, (2, 3072)).astype(np.uint8)
    b10 = data_dir / "test_batch"
    b10.write_bytes(pickle.dumps({b"data": pixels, b"labels": [7, 8]}))
    with tarfile.open(d / "cifar-10-python.tar.gz", "w:gz") as tf:
        tf.add(b10, arcname="cifar-10-batches-py/test_batch")
    b100 = data_dir / "test"
    b100.write_bytes(pickle.dumps(
        {b"data": pixels, b"fine_labels": [42, 1],
         b"coarse_labels": [0, 1]}))
    with tarfile.open(d / "cifar-100-python.tar.gz", "w:gz") as tf:
        tf.add(b100, arcname="cifar-100-python/test")
    rows10 = _rows("cifar10_test")
    assert [int(r[1]) for r in rows10] == [7, 8]
    rows100 = _rows("cifar100_test")
    assert [int(r[1]) for r in rows100] == [42, 1]


def test_imikolov_ngram_count_honored():
    rows = _both(lambda p: list(p.datasets.imikolov_ngram_train(
        synthetic_n=100)()))
    assert len(rows) == 100


def test_housing_file_parser(data_dir):
    d = data_dir / "uci_housing"
    d.mkdir()
    rs = np.random.RandomState(0)
    rows = np.c_[rs.randn(10, 13), rs.rand(10, 1) * 50]
    np.savetxt(d / "housing.data", rows)
    train = _rows("uci_housing_train")
    test = _rows("uci_housing_test")
    assert len(train) == 8 and len(test) == 2       # 80/20 split
    assert train[0][0].shape == (13,) and train[0][1].shape == (1,)


def test_movielens_file_parser(data_dir):
    d = data_dir / "ml-1m"
    d.mkdir()
    (d / "users.dat").write_text("1::F::25::10::12345\n2::M::1::3::54321\n")
    (d / "movies.dat").write_text(
        "10::Toy Story (1995)::Animation|Comedy\n20::Heat (1995)::Action\n")
    (d / "ratings.dat").write_text(
        "1::10::5::978300760\n2::20::3::978302109\n")
    rows = _rows("movielens_train")
    assert len(rows) == 2
    u, g, a, o, m, genres, r = rows[0]
    assert int(u) == 1 and int(g) == 1 and float(r) == 5.0
    assert genres[2] == 1.0 and genres[4] == 1.0    # Animation, Comedy


# --------------------------------------------------------------- transforms

def _image(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def test_simple_transform_shapes():
    img = _image((100, 80, 3))
    out = _both(lambda p: p.transforms.simple_transform(
        img, 64, 56, is_train=True, rng=np.random.RandomState(1)))
    assert out.shape == (56, 56, 3)
    out = _both(lambda p: p.transforms.simple_transform(
        img, 64, 56, is_train=False))
    assert out.shape == (56, 56, 3)


def test_resize_short_keeps_aspect():
    img = _image((100, 50, 3))
    out = _both(lambda p: p.transforms.resize_short(img, 25))
    assert out.shape == (50, 25, 3)


def test_center_crop_and_flip():
    img = np.arange(16, dtype=np.float32).reshape(4, 4, 1)
    c = _both(lambda p: p.transforms.center_crop(img, 2))
    assert c.shape == (2, 2, 1)
    f = _both(lambda p: p.transforms.left_right_flip(img))
    assert f[0, 0, 0] == img[0, -1, 0]
    _both(lambda p: p.transforms.random_crop(
        _image((9, 7, 3)), 5, np.random.RandomState(2)))
    _both(lambda p: p.transforms.normalize(
        _image((4, 4, 3)), (0.1, 0.2, 0.3), (0.5, 0.6, 0.7)))


def test_to_chw():
    out = _both(lambda p: p.transforms.to_chw(_image((4, 5, 3))))
    assert out.shape == (3, 4, 5)


# ------------------------------------------------------------------- common

def test_md5file(tmp_path):
    p = tmp_path / "x.bin"
    p.write_bytes(b"hello world")
    assert _both(lambda pkg: pkg.common.md5file(str(p))) \
        == "5eb63bbbe01eeed093cb22bb8f5acdc3"


def test_download_verifies_cache(data_dir):
    _both_raise(FileNotFoundError, "no\\s+network egress",
                lambda p: p.common.download("http://x/y.tgz", "mod"))
    d = data_dir / "mod"
    d.mkdir()
    (d / "y.tgz").write_bytes(b"data")
    path = _both(lambda p: p.common.download("http://x/y.tgz", "mod"))
    assert path.endswith("y.tgz")
    _both_raise(IOError, "md5", lambda p: p.common.download(
        "http://x/y.tgz", "mod", md5sum="0" * 32))


def test_split_and_cluster_files_reader(tmp_path, monkeypatch):
    """Each package splits into a directory of its own: the same chunk
    names, the same bytes in each chunk, the same shards read back."""
    def run(p):
        where = tmp_path / p.__name__
        where.mkdir()
        monkeypatch.chdir(where)
        files = p.common.split(lambda: iter(range(10)), 3,
                               suffix="chunk-%05d.pickle")
        chunks = [(where / f).read_bytes() for f in files]
        shards = [list(p.common.cluster_files_reader(
            str(where / "chunk-*.pickle"), trainer_count=2,
            trainer_id=k)()) for k in (0, 1)]
        return files, chunks, shards
    files, _, shards = _both(run)
    assert len(files) == 4                           # 3+3+3+1
    all_items = sorted(shards[0] + shards[1])
    assert all_items == list(range(10))              # disjoint, complete

# ------------------------------------------------------------- feeders

def test_data_feeder_casts_and_places():
    feeder = data.DataFeeder(["x", "y"], dtypes={"y": np.int32},
                             device="cpu")
    out = feeder.feed((np.ones((2, 3)), np.array([1, 2], np.int64)))
    assert out["x"].dtype == torch.float64 and out["y"].dtype == torch.int32
    assert feeder.feed({"x": np.zeros(1), "y": np.zeros(1)})["y"].shape \
        == (1,)
    # float32 in: JAX without x64 turns float64 into float32, and torch
    # keeps it, so the parity batch is float32
    batch = (np.arange(6, dtype=np.float32).reshape(2, 3),
             np.array([1, 2], np.int64))
    _both(lambda p: p.DataFeeder(["x", "y"], dtypes={"y": np.int32},
                                 **_on_cpu(p)).feed(batch))


def test_sharding_waits_for_the_meshes():
    with pytest.raises(NotImplementedError, match="item 10"):
        list(data.device_prefetch(iter([np.zeros(2)]), sharding=object()))
    with pytest.raises(NotImplementedError, match="item 10"):
        data.DataFeeder(["x"], sharding=object())


def test_the_port_exports_jax_data_names():
    names = {n for n in vars(jax_data) if not n.startswith("_")}
    datafeed = {"datafeed", "MultiSlotDataFeed", "SlotSpec", "to_padded",
                "write_slot_file", "feeder"}
    missing = sorted(n for n in names - datafeed if not hasattr(data, n))
    assert not missing


# ------------------------------------------------------ parity with JAX

SYNTHETIC = {
    "mnist_train": dict(synthetic_n=40), "mnist_test": dict(synthetic_n=40),
    "cifar10_train": dict(synthetic_n=20),
    "cifar10_test": dict(synthetic_n=20),
    "cifar100_train": dict(synthetic_n=20),
    "cifar100_test": dict(synthetic_n=20),
    "flowers_train": dict(synthetic_n=4, image_size=32),
    "uci_housing_train": dict(synthetic_n=20),
    "uci_housing_test": dict(synthetic_n=20),
    "imikolov_train": dict(vocab=64, seq_len=8, synthetic_n=6),
    "imdb_train": dict(vocab=64, seq_len=16, synthetic_n=6),
    "wmt_synthetic": dict(src_vocab=64, trg_vocab=48, seq_len=8,
                          synthetic_n=6),
    "movielens_train": dict(synthetic_n=6),
    "conll05_train": dict(vocab=64, seq_len=12, synthetic_n=6),
    "voc2012_train": dict(image_size=32, synthetic_n=4),
    "sentiment_train": dict(vocab=64, seq_len=16, synthetic_n=6),
    "mq2007_train": dict(num_queries=4),
    "imikolov_ngram_train": dict(vocab=64, synthetic_n=20),
    "ctr_synthetic": dict(synthetic_n=6),
}


def test_synthetic_table_covers_every_dataset():
    public = {n for n, v in vars(jax_datasets).items()
              if callable(v) and not n.startswith("_")
              and getattr(v, "__module__", "") == jax_datasets.__name__}
    assert public == set(SYNTHETIC)


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_synthetic_samples_equal_jax(name, tmp_path, monkeypatch):
    monkeypatch.setitem(FLAGS._values, "data_dir", str(tmp_path))
    monkeypatch.setitem(JAX_FLAGS._values, "data_dir", str(tmp_path))
    kw = SYNTHETIC[name]
    got = list(getattr(datasets, name)(**kw)())
    want = list(getattr(jax_datasets, name)(**kw)())
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        assert len(a) == len(b)
        for j, (u, v) in enumerate(zip(a, b)):
            u, v = np.asarray(u), np.asarray(v)
            assert u.dtype == v.dtype and u.shape == v.shape, (i, j)
            assert u.tobytes() == v.tobytes(), (name, i, j)
