"""The port's MultiSlotDataFeed (`paddle_tpu_torch.data.datafeed`) and
`train_from_files` against tests/test_datafeed.py's ten tests (native
C++ parser against the Python one), plus the crossing with the JAX
package: `write_slot_file` writes the same bytes for the same examples,
both packages give equal batches from one file (one thread, native and
Python), and `train_from_files` on DeepFM with JAX's parameters gives
JAX's losses within 1e-5 over the first 8 float32 steps."""

import numpy as np
import pytest
import torch

from paddle_tpu.data import datafeed as JDF
from paddle_tpu_torch.core import Trainer, train_from_files
from paddle_tpu_torch.data import datafeed as DF
from paddle_tpu_torch.models import DeepFM
from paddle_tpu_torch.ops import functional as F
from paddle_tpu_torch.optim import Adam
from paddle_tpu_torch.testing import one_torch_thread
from paddle_tpu_torch.utils import native

CONFIG = "label:int64:dense:1;dense:float:dense:3;ids:int64:sparse"
CTR = "label:int64:dense:1;dense:float:dense:2;ids:int64:sparse"


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _write(tmp_path, n_files=2, rows_per_file=7, seed=0, write=None):
    rs = np.random.RandomState(seed)
    files, all_rows = [], []
    for fi in range(n_files):
        exs = []
        for _ in range(rows_per_file):
            label = [int(rs.randint(0, 2))]
            dense = [float(np.float32(x)) for x in rs.randn(3)]
            ids = [int(x) for x in rs.randint(0, 100, rs.randint(1, 6))]
            exs.append((label, dense, ids))
            all_rows.append((label, dense, ids))
        p = tmp_path / f"part-{fi}.txt"
        (write or DF.write_slot_file)(str(p), exs, CONFIG)
        files.append(str(p))
    return files, all_rows


def _collect(feed):
    rows = []
    for batch in feed:
        labels = batch["label"]
        dense = batch["dense"]
        vals, offs = batch["ids"]
        for r in range(labels.shape[0]):
            rows.append((
                [int(labels[r, 0])],
                [float(x) for x in dense[r]],
                [int(x) for x in vals[offs[r]:offs[r + 1]]]))
    return rows


# ---------------------------------------- tests/test_datafeed.py mirrors

def test_python_roundtrip(tmp_path):
    files, want = _write(tmp_path)
    feed = DF.MultiSlotDataFeed(files, CONFIG, batch_size=4, native=False)
    got = _collect(feed)
    assert sorted(map(repr, got)) == sorted(map(repr, want))
    # deterministic single-source order for the python path
    assert got[:7] == want[:7]


def test_native_matches_python(tmp_path):
    files, want = _write(tmp_path, n_files=3, rows_per_file=11)
    got = _collect(DF.MultiSlotDataFeed(files, CONFIG, batch_size=4,
                                        nthreads=3, native=True))
    # multi-threaded: file order is nondeterministic, content identical
    assert sorted(map(repr, got)) == sorted(map(repr, want))


def test_batch_shapes_and_partial(tmp_path):
    files, want = _write(tmp_path, n_files=1, rows_per_file=5)
    batches = list(DF.MultiSlotDataFeed(files, CONFIG, batch_size=4,
                                        native=False))
    assert [b["label"].shape[0] for b in batches] == [4, 1]
    assert batches[0]["dense"].shape == (4, 3)
    vals, offs = batches[0]["ids"]
    assert offs.shape == (5,) and offs[0] == 0 and offs[-1] == len(vals)


def test_native_tail_merge(tmp_path):
    """Per-worker end-of-file partials merge into at most ONE tail batch:
    2 files x 10 rows with batch_size=16 must yield one 16-row batch and
    one 4-row tail, not two dropped 10-row partials."""
    files, want = _write(tmp_path, n_files=2, rows_per_file=10)
    batches = list(DF.MultiSlotDataFeed(files, CONFIG, batch_size=16,
                                        nthreads=2, native=True))
    sizes = sorted(b["label"].shape[0] for b in batches)
    assert sizes == [4, 16]
    got = _collect(iter(batches))
    assert sorted(map(repr, got)) == sorted(map(repr, want))


def test_malformed_line_raises(tmp_path):
    p = tmp_path / "bad.txt"
    p.write_text("1 0 3 1.0 2.0 3.0 2 5\n")  # sparse slot claims 2, has 1
    for native_ in (False, None, True):
        feed = DF.MultiSlotDataFeed([str(p)], CONFIG, batch_size=2,
                                    native=native_)
        with pytest.raises(RuntimeError, match="malformed|datafeed"):
            list(feed)


def test_dense_width_enforced(tmp_path):
    p = tmp_path / "bad.txt"
    p.write_text("1 0 2 1.0 2.0 1 5\n")  # dense slot has 2 values, dim=3
    for native_ in (False, True):
        with pytest.raises(RuntimeError):
            list(DF.MultiSlotDataFeed([str(p)], CONFIG, batch_size=2,
                                      native=native_))


def test_to_padded():
    vals = np.array([1, 2, 3, 4, 5, 6], np.int64)
    offs = np.array([0, 2, 2, 6], np.int64)
    padded, mask = DF.to_padded(vals, offs, max_len=3, pad=-1)
    np.testing.assert_array_equal(
        padded, [[1, 2, -1], [-1, -1, -1], [3, 4, 5]])
    np.testing.assert_array_equal(
        mask, [[True, True, False], [False] * 3, [True] * 3])


def test_config_validation():
    with pytest.raises(ValueError):
        DF.parse_config("")
    with pytest.raises(ValueError):
        DF.parse_config("a:int64")
    with pytest.raises(ValueError):
        DF.parse_config("a:int32:dense:1")
    with pytest.raises(ValueError):
        DF.parse_config("a:int64:ragged:1")
    specs = DF.parse_config("a:int64:sparse;b:float:dense:4")
    assert specs[1].dense and specs[1].dim == 4


def _ctr_files(tmp_path, n_files=2, rows=64, seed=3, prefix="ctr"):
    rs = np.random.RandomState(seed)
    files = []
    for fi in range(n_files):
        exs = []
        for _ in range(rows):
            ids = [int(x) for x in rs.randint(0, 50, 4)]
            label = [int(ids[0] % 2)]          # learnable from the ids
            dense = [float(np.float32(v)) for v in rs.randn(2)]
            exs.append((label, dense, ids))
        p = tmp_path / f"{prefix}-{fi}.txt"
        DF.write_slot_file(str(p), exs, CTR)
        files.append(str(p))
    return files


def _deepfm_loss(module, batch, generator, training):
    dense, sparse, y = batch
    logit = module(dense, sparse, generator=generator)
    return torch.mean(F.sigmoid_cross_entropy_with_logits(logit, y)), {}


def _batch_fn(b):
    padded, _ = b["ids"]
    return (b["dense"], padded, b["label"][:, 0].astype(np.float32))


def test_train_from_files(tmp_path):
    """The AsyncExecutor.RunFromFile capability: slot files -> native
    parse -> device prefetch -> train steps; loss drops on a learnable
    signal."""
    files = _ctr_files(tmp_path)
    torch.manual_seed(0)
    model = DeepFM(num_fields=4, vocab_per_field=50, dense_dim=2,
                   device="cpu")
    trainer = Trainer(model, Adam(model.parameters(), 5e-3), _deepfm_loss)
    seen, steps = [], []

    def cb(s, f):
        steps.append(s)
        seen.append(float(f["loss"]))
    ts = train_from_files(trainer, files, CTR, _batch_fn, batch_size=16,
                          epochs=6, max_sparse_len=4, callback=cb)
    assert len(seen) == 48  # 128 rows / 16 per batch * 6 epochs
    assert steps == list(range(1, 49)) and int(ts.step) == 48
    assert np.mean(seen[-8:]) < np.mean(seen[:8]) - 0.05
    # missing max_sparse_len with sparse slots -> clear error
    with pytest.raises(ValueError, match="max_sparse_len"):
        train_from_files(trainer, files, CTR, _batch_fn, batch_size=16)


def test_feeds_deepfm_style_batch(tmp_path):
    """The CTR consumption path: sparse ids -> padded+mask for embedding."""
    files, _ = _write(tmp_path, n_files=1, rows_per_file=8)
    batch = next(iter(DF.MultiSlotDataFeed(files, CONFIG, batch_size=8,
                                           native=False)))
    vals, offs = batch["ids"]
    padded, mask = DF.to_padded(vals, offs, max_len=5)
    assert padded.shape == (8, 5) and mask.shape == (8, 5)
    assert padded[mask].sum() == vals[:].sum() - sum(
        vals[offs[r] + 5:offs[r + 1]].sum()
        for r in range(8) if offs[r + 1] - offs[r] > 5)


# ------------------------------------------------- the port's own contract

def test_native_true_raises_with_the_compiler_message(tmp_path,
                                                      monkeypatch):
    """native=True raises, carrying g++'s output, when the library does
    not build; native=None then parses in Python."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    src = tmp_path / "datafeed.cc"
    src.write_text("not C++;\n")
    monkeypatch.setattr(DF, "_lazy", native.LazyLib(
        str(src), "libdatafeed.so", DF._bind, ("-pthread",)))
    files, want = _write(tmp_path, n_files=1, rows_per_file=3)
    with pytest.raises(RuntimeError, match="(?s)datafeed.*g\\+\\+.*error"):
        DF.MultiSlotDataFeed(files, CONFIG, native=True)
    feed = DF.MultiSlotDataFeed(files, CONFIG, native=None)
    assert feed._lib is None and _collect(feed) == want


def test_train_from_files_drops_the_tail_and_runs_epochs(tmp_path):
    files = _ctr_files(tmp_path, n_files=1, rows=40)
    torch.manual_seed(0)
    model = DeepFM(num_fields=4, vocab_per_field=50, dense_dim=2,
                   mlp_dims=(8,), device="cpu")
    trainer = Trainer(model, Adam(model.parameters(), 5e-3), _deepfm_loss)
    shapes = []
    trainer.loss_fn = lambda m, b, g, t: (shapes.append(tuple(b[1].shape)),
                                          _deepfm_loss(m, b, g, t))[1]
    train_from_files(trainer, files, CTR, _batch_fn, batch_size=16,
                     epochs=2, max_sparse_len=4)
    assert shapes == [(16, 4)] * 4          # 40 rows: 2 full batches x 2
    shapes.clear()
    ts = train_from_files(trainer, files, CTR, _batch_fn, batch_size=16,
                          max_sparse_len=4, drop_last=False)
    assert shapes == [(16, 4), (16, 4), (8, 4)] and int(ts.step) == 7


# --------------------------------------------------- crossing with JAX's

def _examples(n, seed):
    rs = np.random.RandomState(seed)
    return [([int(rs.randint(0, 2))],
             [float(v) for v in rs.randn(3).astype(np.float32)]
             + [], [int(x) for x in rs.randint(-5, 10 ** 12,
                                                rs.randint(0, 7))])
            for _ in range(n)]


def test_write_slot_file_is_byte_identical(tmp_path):
    exs = _examples(50, 7) + [([1], [0.1, -2.5e-8, 3e20], [])]
    DF.write_slot_file(str(tmp_path / "port.txt"), exs, CONFIG)
    JDF.write_slot_file(str(tmp_path / "jax.txt"), exs, CONFIG)
    a = (tmp_path / "port.txt").read_bytes()
    assert a == (tmp_path / "jax.txt").read_bytes() and a


@pytest.mark.parametrize("native_", [True, False],
                         ids=["native", "python"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_batches_equal_jaxs_from_one_file(tmp_path, native_, writer):
    """One thread: both packages' feeds give the same batches, in order,
    from files either package wrote (a 3-row tail included)."""
    write = DF.write_slot_file if writer == "port" else JDF.write_slot_file
    files, _ = _write(tmp_path, n_files=2, rows_per_file=9, write=write)
    mine = list(DF.MultiSlotDataFeed(files, CONFIG, batch_size=5,
                                     nthreads=1, native=native_))
    theirs = list(JDF.MultiSlotDataFeed(files, CONFIG, batch_size=5,
                                        nthreads=1, native=native_))
    assert [DF._batch_rows(b) for b in mine] == \
        [JDF._batch_rows(b) for b in theirs]
    assert sum(DF._batch_rows(b) for b in mine) == 18
    for a, b in zip(mine, theirs):
        assert a.keys() == b.keys()
        for k in a:
            for x, y in zip(*((a[k], b[k]) if isinstance(a[k], tuple)
                              else ((a[k],), (b[k],)))):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


def test_to_padded_matches_jax():
    rs = np.random.RandomState(2)
    lens = rs.randint(0, 9, 12)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    vals = rs.randint(0, 1000, offs[-1]).astype(np.int64)
    for max_len in (1, 4, 12):
        got = DF.to_padded(vals, offs, max_len, pad=-3)
        want = JDF.to_padded(vals, offs, max_len, pad=-3)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_train_from_files_matches_jax_deepfm(tmp_path):
    """DeepFM on the same files and weights (the port's seeded init
    carried into JAX's layout), Adam 5e-3, batch 16, one feed thread: the
    first 8 float32 losses within 1e-5 of JAX's train_from_files."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.core.executor import Trainer as JTrainer
    from paddle_tpu.core.executor import TrainState as JTrainState
    from paddle_tpu.core.executor import train_from_files as jtrain
    from paddle_tpu.models.nlp import DeepFM as JDeepFM
    from paddle_tpu.ops import functional as JF
    from paddle_tpu.optim.optimizer import Adam as JAdam
    from paddle_tpu_torch.models import to_jax_params

    files = _ctr_files(tmp_path)
    kw = dict(num_fields=4, vocab_per_field=50, dense_dim=2, embed_dim=8,
              mlp_dims=(32, 16))
    torch.manual_seed(0)
    model = DeepFM(**kw, device="cpu")
    # copies now: to_jax_params' arrays share the parameters' memory
    jparams = jax.tree.map(jnp.array, to_jax_params(model)["params"])
    trainer = Trainer(model, Adam(model.parameters(), 5e-3), _deepfm_loss)
    mine = []
    train_from_files(trainer, files, CTR, _batch_fn, batch_size=16,
                     nthreads=1, max_sparse_len=4,
                     callback=lambda s, f: mine.append(float(f["loss"])))

    def jloss(module, variables, batch, rng, training):
        dense, sparse, y = batch
        logit, mut = module.apply(variables, dense, sparse,
                                  training=training, rngs=rng, mutable=True)
        loss = jnp.mean(JF.sigmoid_cross_entropy_with_logits(logit, y))
        return (loss, {}), mut.get("state", {})

    jtr = JTrainer(JDeepFM(**kw), JAdam(5e-3), jloss)
    ts = JTrainState(params=jparams, state={},
                     opt_state=jtr.optimizer.init(jparams),
                     step=jnp.zeros((), jnp.int32))
    theirs = []
    jtrain(jtr, ts, files, CTR,
           lambda b: (jnp.asarray(b["dense"]), jnp.asarray(b["ids"][0]),
                      jnp.asarray(b["label"][:, 0], jnp.float32)),
           batch_size=16, nthreads=1, max_sparse_len=4,
           callback=lambda s, f: theirs.append(float(f["loss"])))
    assert len(mine) == len(theirs) == 8
    np.testing.assert_allclose(mine, theirs, rtol=1e-5, atol=1e-5)
