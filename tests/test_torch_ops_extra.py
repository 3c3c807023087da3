"""The port's lattices and extras (`paddle_tpu_torch.ops.lattice`,
`.extras`) against tests/test_ops_extra.py, case for case, with the
port's `check_grad`. Where the JAX test draws random inputs, the same
inputs also go through JAX's op. That file's two sampled-softmax tests
(NCE, hierarchical sigmoid) wait for the port of `nn.sampled`."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops.extras as JE
import paddle_tpu.ops.lattice as JL
import paddle_tpu_torch.ops.extras as E
import paddle_tpu_torch.ops.lattice as L
from paddle_tpu_torch.models.transformer import sinusoid_position_encoding
from paddle_tpu_torch.testing import check_grad

RS = np.random.RandomState(0)


def _t(x):
    return torch.as_tensor(np.array(x))


# ------------------------------------------------------------------- CRF

def _brute_force_crf(emis, trans, length):
    k = emis.shape[1]
    start, stop, pair = trans[0], trans[1], trans[2:]
    scores = {}
    for path in itertools.product(range(k), repeat=length):
        s = start[path[0]] + emis[0, path[0]] + stop[path[-1]]
        for i in range(1, length):
            s += pair[path[i - 1], path[i]] + emis[i, path[i]]
        scores[path] = s
    return scores


def test_crf_forward_matches_enumeration():
    k, t = 3, 4
    emis = RS.randn(1, t, k).astype(np.float32)
    trans = RS.randn(k + 2, k).astype(np.float32)
    want = np.logaddexp.reduce(list(_brute_force_crf(emis[0], trans,
                                                     t).values()))
    got = float(L.crf_forward(_t(emis), _t(trans))[0])
    assert got == pytest.approx(float(want), rel=1e-5)


def test_crf_decoding_matches_enumeration():
    k, t = 3, 4
    emis = RS.randn(2, t, k).astype(np.float32)
    trans = RS.randn(k + 2, k).astype(np.float32)
    tags, score = L.crf_decoding(_t(emis), _t(trans))
    for bi in range(2):
        scores = _brute_force_crf(emis[bi], trans, t)
        best = max(scores, key=scores.get)
        assert tuple(tags[bi].numpy()) == best
        assert float(score[bi]) == pytest.approx(float(scores[best]),
                                                 rel=1e-5)


def test_crf_ragged_lengths():
    k, t = 3, 5
    emis = RS.randn(1, t, k).astype(np.float32)
    trans = RS.randn(k + 2, k).astype(np.float32)
    got = float(L.crf_forward(_t(emis), _t(trans),
                              torch.tensor([3], dtype=torch.int32))[0])
    want = np.logaddexp.reduce(
        list(_brute_force_crf(emis[0, :3], trans, 3).values()))
    assert got == pytest.approx(float(want), rel=1e-5)


def test_crf_nll_trains():
    """CRF NLL decreases under gradient descent and decodes the truth;
    its first loss and gradient are JAX's."""
    k, t, b = 4, 6, 8
    emis0 = RS.randn(b, t, k).astype(np.float32)
    tags = RS.randint(0, k, (b, t)).astype(np.int32)
    trans0 = (0.01 * RS.randn(k + 2, k)).astype(np.float32)
    emis = _t(emis0).requires_grad_(True)
    trans = _t(trans0).requires_grad_(True)

    def loss():
        return torch.mean(L.linear_chain_crf(emis, _t(tags), trans))

    l0 = float(loss().detach())
    jl0, (jgt, jge) = jax.jit(jax.value_and_grad(
        lambda tr, em: jnp.mean(JL.linear_chain_crf(em, tags, tr)),
        argnums=(0, 1)))(trans0, emis0)
    gt, ge = torch.autograd.grad(loss(), (trans, emis))
    assert l0 == pytest.approx(float(jl0), rel=1e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(jgt), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(ge.numpy(), np.asarray(jge), rtol=1e-4,
                               atol=1e-6)
    for _ in range(60):
        gt, ge = torch.autograd.grad(loss(), (trans, emis))
        with torch.no_grad():
            trans -= 0.5 * gt
            emis -= 0.5 * ge
    assert float(loss().detach()) < l0 * 0.2
    dec, _ = L.crf_decoding(emis.detach(), trans.detach())
    assert float((dec == _t(tags)).float().mean()) > 0.95


# ------------------------------------------------------------------- CTC

def _brute_force_ctc(logp, labels, blank=0):
    t, v = logp.shape
    total = -np.inf
    for path in itertools.product(range(v), repeat=t):
        out, prev = [], None
        for p in path:
            if p != prev:
                out.append(p)
            prev = p
        if [p for p in out if p != blank] == list(labels):
            total = np.logaddexp(total, sum(logp[i, path[i]]
                                            for i in range(t)))
    return -total


def test_ctc_loss_matches_enumeration():
    t, v = 4, 3
    logits = RS.randn(1, t, v).astype(np.float32)
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
    labels = np.array([[1, 2]], np.int32)
    got = float(L.ctc_loss(_t(logp), _t(labels))[0])
    assert got == pytest.approx(_brute_force_ctc(logp[0], [1, 2]), rel=1e-5)


def test_ctc_loss_trains_and_decodes():
    t, v = 12, 5
    labels = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    logits = _t((0.01 * RS.randn(1, t, v)).astype(np.float32))
    logits.requires_grad_(True)

    def loss():
        return torch.mean(L.ctc_loss(torch.log_softmax(logits, -1), labels))

    for _ in range(200):
        (g,) = torch.autograd.grad(loss(), logits)
        with torch.no_grad():
            logits -= 1.0 * g
    assert float(loss().detach()) < 0.1
    aligned, n = L.ctc_align(torch.argmax(logits.detach(), -1))
    assert aligned[0, :int(n[0])].tolist() == [1, 2, 3]


def test_ctc_align():
    toks = torch.tensor([[0, 1, 1, 0, 2, 2, 3, 0]])
    out, n = L.ctc_align(toks)
    assert int(n[0]) == 3
    np.testing.assert_array_equal(out[0, :3].numpy(), [1, 2, 3])
    out2, n2 = L.ctc_align(toks, torch.tensor([4], dtype=torch.int32))
    assert int(n2[0]) == 1
    np.testing.assert_array_equal(out2[0, :1].numpy(), [1])


# ----------------------------------------------------------- vision warps

def test_affine_grid_identity_and_sampler():
    grid = E.affine_grid(torch.tensor([[[1.0, 0, 0], [0, 1.0, 0]]]), (4, 6))
    assert grid.shape == (1, 4, 6, 2)
    x = _t(RS.randn(1, 4, 6, 2).astype(np.float32))
    np.testing.assert_allclose(E.grid_sampler(x, grid).numpy(), x.numpy(),
                               atol=1e-5)


def test_grid_sampler_shift_zero_pad():
    y = E.grid_sampler(torch.ones(1, 4, 4, 1), torch.full((1, 4, 4, 2), 5.0))
    assert float(y.abs().sum()) == 0.0


def test_shuffle_channel_roundtrip():
    x = _t(RS.randn(1, 2, 2, 6).astype(np.float32))
    z = E.shuffle_channel(E.shuffle_channel(x, 2), 3)
    np.testing.assert_allclose(z.numpy(), x.numpy())


def test_space_depth_roundtrip():
    x = _t(RS.randn(1, 4, 4, 3).astype(np.float32))
    y = E.space_to_depth(x, 2)
    assert y.shape == (1, 2, 2, 12)
    np.testing.assert_allclose(E.depth_to_space(y, 2).numpy(), x.numpy())


def test_pool_with_index_and_unpool():
    xn = RS.randn(1, 4, 4, 2).astype(np.float32)
    x = _t(xn)
    out, idx = E.max_pool2d_with_index(x, 2, 2)
    np.testing.assert_allclose(out.numpy()[0, 0, 0, 0], xn[0, :2, :2, 0].max())
    rec = E.max_unpool2d(out, idx, (4, 4))
    assert rec.shape == x.shape
    assert float((rec != 0).sum()) == out.numel()
    np.testing.assert_allclose(float(rec.max()), float(x.max()))
    jout, jidx = JE.max_pool2d_with_index(jnp.asarray(xn), 2, 2)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_spp_shapes():
    assert E.spp(_t(RS.randn(2, 8, 8, 3).astype(np.float32)),
                 levels=(1, 2, 4)).shape == (2, (1 + 4 + 16) * 3)


def test_im2sequence():
    x = torch.arange(16, dtype=torch.float32).reshape(1, 4, 4, 1)
    seq = E.im2sequence(x, (2, 2), (2, 2))
    assert seq.shape == (1, 4, 4)
    np.testing.assert_allclose(seq[0, 0].numpy(), [0, 1, 4, 5])


# ---------------------------------------------------------- params/losses

def test_prelu_selu_grad():
    check_grad(lambda x, a: E.prelu(x, a),
               RS.uniform(-2, 2, (3, 4)) + np.where(RS.rand(3, 4) > .5,
                                                    .2, -.2),
               np.array(0.25), name="prelu")
    check_grad(E.selu, RS.uniform(.2, 2, (3, 4)), name="selu")


def test_row_conv():
    x = RS.randn(1, 5, 2).astype(np.float32)
    w = RS.randn(3, 2).astype(np.float32)
    y = E.row_conv(_t(x), _t(w)).numpy()
    np.testing.assert_allclose(y[0, 2], sum(x[0, 2 + k] * w[k]
                                            for k in range(3)), rtol=1e-5)
    np.testing.assert_allclose(y[0, 4], x[0, 4] * w[0], rtol=1e-5)
    np.testing.assert_allclose(y, np.asarray(JE.row_conv(x, w)), rtol=1e-6)


def test_conv_shift():
    x = RS.randn(2, 8).astype(np.float32)
    y = RS.randn(2, 3).astype(np.float32)
    out = E.conv_shift(_t(x), _t(y))
    want = sum(float(y[0, j]) * float(x[0, (2 + j - 1) % 8]) for j in range(3))
    assert float(out[0, 2]) == pytest.approx(want, rel=1e-4)


def test_bilinear_tensor_product():
    x = RS.randn(2, 3).astype(np.float32)
    y = RS.randn(2, 4).astype(np.float32)
    w = RS.randn(5, 3, 4).astype(np.float32)
    out = E.bilinear_tensor_product(_t(x), _t(y), _t(w))
    assert float(out[0, 2]) == pytest.approx(float(x[0] @ w[2] @ y[0]),
                                             rel=1e-4)


def test_add_position_encoding_matches_transformer():
    y = E.add_position_encoding(torch.zeros(1, 6, 8))
    np.testing.assert_allclose(y[0].numpy(),
                               sinusoid_position_encoding(6, 8, "cpu").numpy(),
                               atol=1e-5)


def test_multiplex():
    a = torch.tensor([[1.0, 1], [2, 2]])
    b = torch.tensor([[3.0, 3], [4, 4]])
    out = E.multiplex(torch.tensor([1, 0]), [a, b])
    np.testing.assert_allclose(out.numpy(), [[3, 3], [2, 2]])


def test_losses_shapes_and_signs():
    x = _t(RS.randn(6).astype(np.float32))
    y = _t(RS.randint(0, 2, 6).astype(np.float32))
    assert float(E.modified_huber_loss(x, y).min()) >= 0
    assert float(E.rank_loss(x, -x, y).min()) >= 0
    logits = _t(RS.randn(4, 5).astype(np.float32))
    assert E.bpr_loss(logits, torch.tensor([0, 1, 2, 3])).shape == (4,)
    assert float(E.teacher_student_sigmoid_loss(x, y).min()) >= 0


def test_center_loss_pulls_to_centers():
    feats = RS.randn(8, 4).astype(np.float32)
    labels = RS.randint(0, 3, 8)
    loss, new_centers = E.center_loss(_t(feats), _t(labels), torch.zeros(3, 4))
    assert loss.shape == (8,)
    assert float(torch.linalg.norm(new_centers)) > 0
    jloss, jcenters = jax.jit(JE.center_loss)(
        jnp.asarray(feats), jnp.asarray(labels), jnp.zeros((3, 4)))
    np.testing.assert_allclose(new_centers.numpy(), np.asarray(jcenters),
                               rtol=1e-6, atol=1e-7)


def test_mean_iou_perfect_and_partial():
    pred = torch.tensor([[0, 1], [2, 2]])
    assert float(E.mean_iou(pred, pred, 3)) == pytest.approx(1.0)
    v = float(E.mean_iou(pred, torch.tensor([[0, 1], [2, 0]]), 3))
    assert 0 < v < 1


def test_npair_loss_positive():
    a = _t(RS.randn(6, 4).astype(np.float32))
    p = _t(RS.randn(6, 4).astype(np.float32))
    assert float(E.npair_loss(a, p, torch.tensor([0, 0, 1, 1, 2, 2]))) > 0


# --------------------------------------------------------------- sampling

def test_sampling_id_distribution():
    probs = torch.tensor([[0.9, 0.1, 0.0]] * 512)
    ids = E.sampling_id(torch.Generator().manual_seed(0), probs)
    assert float((ids == 0).float().mean()) > 0.8
    assert int(ids.max()) <= 1


def test_random_ops():
    u = E.uniform_random(torch.Generator().manual_seed(0), (1000,), -2, 2)
    assert -2 <= float(u.min()) and float(u.max()) <= 2
    g = E.truncated_gaussian_random(torch.Generator().manual_seed(0),
                                    (1000,), std=2.0)
    assert float(g.abs().max()) <= 4.0 + 1e-5


def test_hash_embedding_ids():
    ids = np.array([3, 17, 3, 99])
    h = E.hash_embedding_ids(_t(ids), mod=1000, num_hash=2)
    assert h.shape == (4, 2)
    assert bool((h >= 0).all()) and bool((h < 1000).all())
    np.testing.assert_array_equal(h[0].numpy(), h[2].numpy())
    np.testing.assert_array_equal(h.numpy(), np.asarray(
        JE.hash_embedding_ids(jnp.asarray(ids), mod=1000, num_hash=2)))


# ----------------------------------------------------------- tensor utils

def test_tensor_utils():
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    np.testing.assert_allclose(E.crop(x, (0, 1, 1), (2, 2, 2))[0, 0].numpy(),
                               [5, 6])
    assert E.pad2d(torch.zeros(1, 2, 2, 1), [1, 1, 2, 2]).shape == \
        (1, 4, 6, 1)
    y = E.pad_constant_like(x, torch.ones(1, 2, 2), 7.0)
    assert y.shape == x.shape and float(y[1, 2, 3]) == 7.0
    parts = E.unstack(x, 1)
    assert len(parts) == 3 and parts[0].shape == (2, 4)
    assert E.flatten(x, 2).shape == (6, 4)
    assert float(E.increment(torch.tensor(1.0), 2.0)) == 3.0
    f = E.fill_constant_batch_size_like(x, (9, 5), 2.5)
    assert f.shape == (2, 5) and float(f[0, 0]) == 2.5
    assert float(E.squared_l2_norm(torch.tensor([3.0, 4.0]))) == 25.0


def test_positive_negative_pair():
    pos, neg, neu = E.positive_negative_pair(
        torch.tensor([0.9, 0.2, 0.8, 0.1]), torch.tensor([2.0, 1.0, 2.0, 0.0]),
        torch.tensor([0, 0, 1, 1]))
    assert int(pos) == 2 and int(neg) == 0 and int(neu) == 0
