"""The port's sequence ops (`paddle_tpu_torch.ops.sequence`): the tests of
tests/test_sequence_ops.py and tests/test_sequence_tail.py on the port,
each holding it to the same numpy references as JAX's tests hold JAX's
ops, with the same inputs. Every sequence op's output is also held to
JAX's, in float64 and float32, by
tests/test_torch_op_grads.py::test_ops_match_jax (one place, since
XLA:CPU compiles each JAX op it meets)."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import sequence as S


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


@pytest.fixture
def ragged_batch(rng):
    b, t, d = 4, 7, 3
    x = rng.randn(b, t, d).astype(np.float32)
    lengths = np.array([7, 3, 5, 1])
    for i, l in enumerate(lengths):
        x[i, l:] = 0.0
    return x, lengths


def test_sequence_mask():
    m = S.sequence_mask(torch.tensor([2, 0, 3]), 4)
    expected = np.array([[1, 1, 0, 0], [0, 0, 0, 0], [1, 1, 1, 0]], bool)
    np.testing.assert_array_equal(_np(m), expected)
    assert m.dtype == torch.bool


def test_sequence_pool_all_types(ragged_batch):
    x, lengths = ragged_batch
    xl, ll = torch.from_numpy(x), torch.from_numpy(lengths)
    for pool in ("sum", "mean", "sqrt", "max", "first", "last"):
        out = _np(S.sequence_pool(xl, ll, pool))
        for i, l in enumerate(lengths):
            seq = x[i, :l] if l else np.zeros((1, x.shape[2]), np.float32)
            if pool == "sum":
                ref = seq.sum(0) if l else np.zeros(x.shape[2])
            elif pool == "mean":
                ref = seq.mean(0) if l else np.zeros(x.shape[2])
            elif pool == "sqrt":
                ref = seq.sum(0) / np.sqrt(max(l, 1))
            elif pool == "max":
                ref = seq.max(0) if l else np.full(x.shape[2], -1e9)
            elif pool == "first":
                ref = x[i, 0]
            else:
                ref = x[i, max(l - 1, 0)]
            np.testing.assert_allclose(out[i], ref, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{pool} row {i}")


def test_pack_pad_roundtrip(ragged_batch):
    x, lengths = ragged_batch
    r = S.pack_padded(torch.from_numpy(x), torch.from_numpy(lengths))
    assert r.segment_ids.dtype == torch.int32
    padded, mask = S.pad_packed(r, x.shape[1])
    np.testing.assert_allclose(_np(padded), x, rtol=1e-6)
    np.testing.assert_array_equal(
        _np(mask), _np(S.sequence_mask(torch.from_numpy(lengths),
                                       x.shape[1])))


def test_segment_pool_matches_sequence_pool(ragged_batch):
    x, lengths = ragged_batch
    xt, lt = torch.from_numpy(x), torch.from_numpy(lengths)
    r = S.pack_padded(xt, lt)
    for pool in ("sum", "mean"):
        a = _np(S.segment_pool(r, pool))
        b = _np(S.sequence_pool(xt, lt, pool))
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_sequence_softmax(ragged_batch):
    x, lengths = ragged_batch
    out = _np(S.sequence_softmax(torch.from_numpy(x[..., 0]),
                                 torch.from_numpy(lengths)))
    for i, l in enumerate(lengths):
        if l:
            e = np.exp(x[i, :l, 0] - x[i, :l, 0].max())
            np.testing.assert_allclose(out[i, :l], e / e.sum(), rtol=1e-5)
        np.testing.assert_allclose(out[i, l:], 0.0, atol=1e-6)


def test_sequence_reverse(ragged_batch):
    x, lengths = ragged_batch
    out = _np(S.sequence_reverse(torch.from_numpy(x),
                                 torch.from_numpy(lengths)))
    for i, l in enumerate(lengths):
        np.testing.assert_allclose(out[i, :l], x[i, :l][::-1], rtol=1e-6)
        np.testing.assert_allclose(out[i, l:], x[i, l:], rtol=1e-6)


def test_sequence_concat():
    a_np = np.arange(12, dtype=np.float32).reshape(2, 3, 2)
    b_np = 100 + np.arange(8, dtype=np.float32).reshape(2, 2, 2)
    a, b = torch.from_numpy(a_np), torch.from_numpy(b_np)
    la, lb = torch.tensor([3, 1]), torch.tensor([2, 2])
    out, lens = S.sequence_concat([a, b], [la, lb], maxlen=5)
    out = _np(out)
    np.testing.assert_array_equal(_np(lens), [5, 3])
    np.testing.assert_allclose(out[0, :3], a_np[0])
    np.testing.assert_allclose(out[0, 3:5], b_np[0])
    np.testing.assert_allclose(out[1, 0], a_np[1, 0])
    np.testing.assert_allclose(out[1, 1:3], b_np[1])


def test_sequence_erase():
    toks_np = np.array([[1, 2, 3, 2, 5], [2, 2, 2, 0, 0]])
    out, nl = S.sequence_erase(torch.from_numpy(toks_np),
                               torch.tensor([5, 3]), [2])
    np.testing.assert_array_equal(_np(nl), [3, 0])
    np.testing.assert_array_equal(_np(out[0, :3]), [1, 3, 5])
    np.testing.assert_array_equal(_np(out[1]), [0, 0, 0, 0, 0])


def test_sequence_enumerate():
    toks = torch.tensor([[1, 2, 3, 4, 0]])
    out = _np(S.sequence_enumerate(toks, torch.tensor([4]), 2, pad_value=9))
    np.testing.assert_array_equal(out[0, 0], [1, 2])
    np.testing.assert_array_equal(out[0, 2], [3, 4])
    np.testing.assert_array_equal(out[0, 3], [4, 9])
    np.testing.assert_array_equal(out[0, 4], [9, 9])


def test_sequence_conv_masks_padding(ragged_batch, rng):
    x, lengths = ragged_batch
    d, out_d, ctx = x.shape[2], 5, 3
    w = rng.randn(ctx * d, out_d).astype(np.float32)
    out = _np(S.sequence_conv(torch.from_numpy(x), torch.from_numpy(lengths),
                              torch.from_numpy(w), context_size=ctx))
    assert out.shape == (x.shape[0], x.shape[1], out_d)
    for i, l in enumerate(lengths):
        np.testing.assert_allclose(out[i, l:], 0.0, atol=1e-6)
    # middle position of row 0 = full window
    i, t = 0, 3
    window = np.concatenate([x[i, t - 1], x[i, t], x[i, t + 1]])
    np.testing.assert_allclose(out[i, t], window @ w, rtol=1e-4, atol=1e-5)


def test_shrink_memory():
    out = _np(S.shrink_memory(torch.ones((3, 4)), 2, torch.tensor([5, 1, 3])))
    np.testing.assert_allclose(out[0], 1.0)
    np.testing.assert_allclose(out[1], 0.0)
    np.testing.assert_allclose(out[2], 1.0)


# -- tests/test_sequence_tail.py ---------------------------------------------

def test_sequence_expand_as():
    x = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    out = S.sequence_expand_as(x, torch.tensor([2, 1]), maxlen=3)
    assert out.shape == (2, 3, 2)
    np.testing.assert_allclose(_np(out[0, 0]), [1, 2])
    np.testing.assert_allclose(_np(out[0, 1]), [1, 2])
    np.testing.assert_allclose(_np(out[0, 2]), [0, 0])
    np.testing.assert_allclose(_np(out[1, 1]), [0, 0])


def test_sequence_reshape_roundtrip():
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    out, new_len = S.sequence_reshape(x, torch.tensor([2, 3]), new_dim=2)
    assert out.shape == (2, 6, 2)
    np.testing.assert_array_equal(_np(new_len), [4, 6])
    # payload of row 0 (2 steps * 4 dims = 8 values -> 4 steps of 2)
    np.testing.assert_allclose(_np(out[0, :4]).reshape(-1),
                               np.arange(8, dtype=np.float32))
    np.testing.assert_allclose(_np(out[0, 4:]), 0.0)


def test_sequence_scatter_masks_padding():
    idx = np.array([[0, 1, 1], [4, 0, 0]])
    upd = np.array([[1.0, 2.0, 3.0], [7.0, 9.0, 9.0]], np.float32)
    out = S.sequence_scatter(torch.zeros((2, 5)), torch.from_numpy(idx),
                             torch.from_numpy(upd), torch.tensor([3, 1]))
    np.testing.assert_allclose(_np(out[0]), [1, 5, 0, 0, 0])
    np.testing.assert_allclose(_np(out[1]), [0, 0, 0, 0, 7])
