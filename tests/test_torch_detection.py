"""The port's detection ops (`paddle_tpu_torch.ops.detection`) and its
DetectionMAP / PrecisionRecall metrics against tests/test_detection.py
and tests/test_detection_tail.py, case for case. The samplers are held
through their `*_by_uniform` selection, fed `jax.random.uniform(key,
(n,))`, against JAX's function with that key."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops.detection as JD
from paddle_tpu_torch.metrics import DetectionMAP, PrecisionRecall
from paddle_tpu_torch.ops import detection as D

BOXES = np.array([[0, 0, 10, 10],
                  [5, 5, 15, 15],
                  [20, 20, 30, 30],
                  [0, 0, 10, 10]], np.float32)
T = torch.tensor


def _t(x):
    return torch.as_tensor(np.asarray(x))


def test_iou_similarity():
    iou = D.iou_similarity(_t(BOXES), _t(BOXES)).numpy()
    assert iou.shape == (4, 4)
    np.testing.assert_allclose(np.diag(iou), 1.0, rtol=1e-6)
    assert iou[0, 1] == pytest.approx(25.0 / 175.0, rel=1e-5)
    assert iou[0, 2] == 0.0
    assert iou[0, 3] == pytest.approx(1.0)


def test_box_coder_roundtrip():
    priors = _t(BOXES)
    var = T([0.1, 0.1, 0.2, 0.2])
    gt = T([[2, 2, 9, 9], [18, 19, 31, 33]], dtype=torch.float32)
    enc = D.box_coder(priors, var, gt, "encode")
    assert enc.shape == (2, 4, 4)
    dec = D.box_coder(priors, var, enc, "decode")
    for i in range(2):
        for j in range(4):
            np.testing.assert_allclose(dec[i, j].numpy(), gt[i].numpy(),
                                       atol=1e-4)


def test_box_clip():
    out = D.box_clip(T([[-5, -5, 50, 8]], dtype=torch.float32), (20, 40))
    np.testing.assert_allclose(out[0].numpy(), [0, 0, 39, 8])


def test_prior_box():
    boxes, var = D.prior_box((2, 2), (100, 100), min_sizes=[30],
                             max_sizes=[60], aspect_ratios=[2.0],
                             device="cpu")
    assert boxes.shape == (2, 2, 4, 4) and var.shape == boxes.shape
    b = boxes.numpy()
    np.testing.assert_allclose(b[0, 0, 0], [0.10, 0.10, 0.40, 0.40],
                               atol=1e-6)
    side = np.sqrt(30 * 60) / 100
    np.testing.assert_allclose(b[0, 0, 3],
                               [0.25 - side / 2, 0.25 - side / 2,
                                0.25 + side / 2, 0.25 + side / 2], atol=1e-6)


def test_density_prior_box():
    boxes, _ = D.density_prior_box((2, 2), (32, 32), fixed_sizes=[8.0],
                                   fixed_ratios=[1.0], densities=[2],
                                   device="cpu")
    assert boxes.shape == (2, 2, 4, 4)
    b = boxes.numpy()
    centers = (b[0, 0, :, :2] + b[0, 0, :, 2:]) / 2
    assert len(np.unique(centers.round(4), axis=0)) == 4


def test_anchor_generator():
    anchors, var = D.anchor_generator((3, 4), anchor_sizes=[32, 64],
                                      aspect_ratios=[0.5, 1.0],
                                      stride=(16, 16), device="cpu")
    assert anchors.shape == (3, 4, 4, 4)
    a = anchors.numpy()
    np.testing.assert_allclose((a[0, 0, :, :2] + a[0, 0, :, 2:]) / 2, 8.0,
                               atol=1e-4)
    w = a[0, 0, 2, 2] - a[0, 0, 2, 0]
    h = a[0, 0, 2, 3] - a[0, 0, 2, 1]
    assert w == pytest.approx(h, rel=1e-5)


def test_bipartite_match():
    sim = T([[0.9, 0.1, 0.0], [0.8, 0.7, 0.2]])
    match, dist = D.bipartite_match(sim)
    np.testing.assert_array_equal(match.numpy(), [0, 1, -1])
    np.testing.assert_allclose(dist.numpy(), [0.9, 0.7, 0.0], atol=1e-6)


def test_target_assign():
    out, w = D.target_assign(T([[1., 2.], [3., 4.]]),
                             T([1, -1, 0], dtype=torch.int32))
    np.testing.assert_allclose(out.numpy(), [[3, 4], [0, 0], [1, 2]])
    np.testing.assert_allclose(w.numpy(), [1, 0, 1])


def test_mine_hard_examples():
    mask = D.mine_hard_examples(T([5.0, 1.0, 4.0, 3.0, 2.0]),
                                T([0, -1, -1, -1, -1], dtype=torch.int32),
                                neg_pos_ratio=2.0)
    np.testing.assert_array_equal(mask.numpy(),
                                  [False, False, True, True, False])


def test_nms():
    idx, ok = D.nms(_t(BOXES), T([0.9, 0.8, 0.7, 0.95]), iou_threshold=0.1,
                    max_output=4)
    assert list(idx[ok].numpy()) == [3, 2]


def test_nms_jit_static_shape():
    # no jit here: the static shapes are what JAX's jit needs
    idx, ok = D.nms(_t(BOXES), T([0.5, 0.6, 0.7, 0.4]), 0.5, max_output=3)
    assert idx.shape == (3,) and ok.shape == (3,)
    jidx, jok = jax.jit(lambda b, s: JD.nms(b, s, 0.5, max_output=3))(
        jnp.asarray(BOXES), jnp.asarray([0.5, 0.6, 0.7, 0.4]))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))


def test_multiclass_nms():
    scores = np.array([[0.9, 0.9, 0.9, 0.9],
                       [0.8, 0.2, 0.7, 0.1],
                       [0.1, 0.6, 0.05, 0.0]], np.float32)
    out, count = D.multiclass_nms(_t(BOXES), _t(scores), score_threshold=0.05,
                                  nms_threshold=0.3, keep_top_k=10)
    out, count = out.numpy(), int(count)
    assert out.shape == (10, 6)
    assert count >= 2
    assert out[0][0] in (1, 2) and out[0][1] == pytest.approx(0.8)
    assert np.all(out[count:, 0] == -1)
    jout, jcount = jax.jit(lambda b, s: JD.multiclass_nms(
        b, s, score_threshold=0.05, nms_threshold=0.3, keep_top_k=10))(
            jnp.asarray(BOXES), jnp.asarray(scores))
    np.testing.assert_array_equal(out, np.asarray(jout))
    assert count == int(jcount)


def test_roi_align_constant_field():
    out = D.roi_align(torch.full((16, 16, 3), 2.5),
                      T([[0, 0, 8, 8], [4, 4, 12, 15]], dtype=torch.float32),
                      (4, 4))
    assert out.shape == (2, 4, 4, 3)
    np.testing.assert_allclose(out.numpy(), 2.5, atol=1e-5)


def test_roi_align_gradient_field():
    xs = torch.arange(16.0)[None, :, None].expand(16, 16, 1)
    out = D.roi_align(xs, T([[2, 2, 10, 10]], dtype=torch.float32), (4, 4),
                      sampling_ratio=1).numpy()
    expect_x = 2 + (np.arange(4) + 0.5) * 2.0
    np.testing.assert_allclose(out[0, 0, :, 0], expect_x, atol=0.51)
    np.testing.assert_allclose(out[0, 0], out[0, 3], atol=1e-5)


def test_roi_pool_max():
    feat = torch.zeros(8, 8, 1)
    feat[2, 3, 0] = 7.0
    out = D.roi_pool(feat, T([[0, 0, 7, 7]], dtype=torch.float32), (2, 2))
    assert float(out.max()) == pytest.approx(7.0)


def test_generate_proposals():
    anchors, var = D.anchor_generator((4, 4), [16], [1.0], (8, 8),
                                      device="cpu")
    rs = np.random.RandomState(0)
    scores = rs.rand(16).astype(np.float32)
    deltas = (rs.randn(16, 4) * 0.1).astype(np.float32)
    rois, rscores, valid = D.generate_proposals(
        _t(scores), _t(deltas), anchors.reshape(-1, 4), var.reshape(-1, 4),
        (32, 32), pre_nms_top_n=16, post_nms_top_n=8, nms_threshold=0.7)
    rois, valid = rois.numpy(), valid.numpy()
    assert rois.shape == (8, 4) and valid.any()
    got = rois[valid]
    assert np.all(got[:, 0] >= 0) and np.all(got[:, 2] <= 31)
    assert np.all(got[:, 2] >= got[:, 0])
    want = jax.jit(lambda s, d, a, v: JD.generate_proposals(
        s, d, a, v, (32, 32), 16, 8, 0.7))(
            jnp.asarray(scores), jnp.asarray(deltas),
            jnp.asarray(anchors.reshape(-1, 4).numpy()),
            jnp.asarray(var.reshape(-1, 4).numpy()))
    np.testing.assert_allclose(rois, np.asarray(want[0]), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_array_equal(valid, np.asarray(want[2]))


def test_polygon_box_transform():
    out = D.polygon_box_transform(torch.zeros(1, 8, 2, 2)).numpy()
    np.testing.assert_allclose(out[0, 0], [[0, 4], [0, 4]])
    np.testing.assert_allclose(out[0, 1], [[0, 0], [4, 4]])


# ------------------------------------------------------ test_detection_tail

def _uniform(key: int, n: int) -> torch.Tensor:
    return torch.as_tensor(np.array(jax.random.uniform(
        jax.random.key(key), (n,))))


def test_rpn_target_assign_basic():
    anchors = np.array([[0, 0, 10, 10], [20, 20, 30, 30], [0, 0, 9, 9],
                        [100, 100, 110, 110]], np.float32)
    gt = np.array([[0, 0, 10, 10]], np.float32)
    labels, targets, fg_w = D.rpn_target_assign_by_uniform(
        _t(anchors), _t(gt), T([True]), _uniform(0, 4), num_samples=4,
        positive_overlap=0.7, negative_overlap=0.3)
    labels = labels.numpy()
    assert labels[0] == 1
    assert labels[3] in (0, -1)
    np.testing.assert_allclose(targets.numpy()[0], 0.0, atol=1e-5)
    assert fg_w.numpy()[0] == 1.0
    want = jax.jit(lambda a, g, v, k: JD.rpn_target_assign(
        a, g, v, k, num_samples=4, positive_overlap=0.7,
        negative_overlap=0.3))(jnp.asarray(anchors), jnp.asarray(gt),
                               jnp.array([True]), jax.random.key(0))
    np.testing.assert_array_equal(labels, np.asarray(want[0]))
    np.testing.assert_allclose(targets.numpy(), np.asarray(want[1]),
                               atol=1e-6)
    # the generator's form draws its own uniform vector
    g = torch.Generator().manual_seed(0)
    lab_g = D.rpn_target_assign(_t(anchors), _t(gt), T([True]), g, 4)[0]
    assert lab_g[0] == 1


def test_generate_proposal_labels_shapes_and_fg():
    rs = np.random.RandomState(0)
    rois = (np.abs(rs.randn(32, 4)) * 20).astype(np.float32)
    rois[:, 2:] = rois[:, :2] + 10
    gt = np.array([[0, 0, 10, 10], [50, 50, 60, 60]], np.float32)
    rois[0] = gt[0]
    args = (rois, gt, np.array([3, 7]), np.array([True, True]))
    out_rois, labels, targets, fg = D.generate_proposal_labels_by_uniform(
        *map(_t, args), _uniform(1, 32), batch_size_per_im=16)
    assert out_rois.shape == (16, 4) and labels.shape == (16,)
    assert 3 in labels.numpy()[fg.numpy() > 0]
    want = jax.jit(lambda r, g, c, v, k: JD.generate_proposal_labels(
        r, g, c, v, k, batch_size_per_im=16))(*map(jnp.asarray, args),
                                              jax.random.key(1))
    for g, w in zip((out_rois, labels, targets, fg), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_generate_mask_labels_crop():
    gt_masks = torch.zeros(1, 20, 20)
    gt_masks[:, 5:15, 5:15] = 1.0
    out = D.generate_mask_labels(T([[5, 5, 15, 15]], dtype=torch.float32),
                                 T([1.0]), T([0]), gt_masks, resolution=8)
    assert out.shape == (1, 8, 8)
    assert float(out.mean()) > 0.9


def test_psroi_pool_channel_groups():
    rs = np.random.RandomState(1)
    feats = _t(rs.randn(8, 8, 12).astype(np.float32))
    rois = T([[0, 0, 8, 8]], dtype=torch.float32)
    out = D.psroi_pool(feats, rois, (2, 2))
    assert out.shape == (1, 2, 2, 3)
    full = D.roi_align(feats, rois, (2, 2))
    np.testing.assert_allclose(out[0, 0, 0].numpy(),
                               full[0, 0, 0, 0:3].numpy(), rtol=1e-5,
                               atol=1e-5)


def test_roi_perspective_transform_identity():
    rs = np.random.RandomState(2)
    feats = _t(rs.randn(8, 8, 2).astype(np.float32))
    quads = T([[0, 0, 7, 0, 7, 7, 0, 7]], dtype=torch.float32)
    out = D.roi_perspective_transform(feats, quads, (8, 8))
    assert out.shape == (1, 8, 8, 2)
    np.testing.assert_allclose(out[0].numpy(), feats.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_yolov3_loss_decreases_on_fit():
    rs = np.random.RandomState(3)
    anchors = np.array([[32, 32], [64, 64]], np.float32)
    gt = np.array([[0.5, 0.5, 0.25, 0.25]], np.float32)
    preds = (rs.randn(4, 4, 2 * 8) * 0.1).astype(np.float32)
    args = (gt, np.array([1]), np.array([True]), anchors)

    p = _t(preds).requires_grad_(True)
    loss = D.yolov3_loss(p, *map(_t, args), 3, downsample=32)
    (g,) = torch.autograd.grad(loss, p)
    loss = float(loss.detach())
    assert np.isfinite(loss) and float(g.abs().sum()) > 0
    with torch.no_grad():
        assert float(D.yolov3_loss(p - 0.1 * g, *map(_t, args), 3)) < loss
    jl, jg = jax.jit(jax.value_and_grad(lambda x: JD.yolov3_loss(
        x, *map(jnp.asarray, args), 3, downsample=32)))(jnp.asarray(preds))
    np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-6)


def test_detection_map_perfect_and_miss():
    m = DetectionMAP(overlap_threshold=0.5)
    m.update([[0, 0.9, 0, 0, 10, 10]], [[0, 0, 0, 10, 10]])
    assert m.eval() == pytest.approx(1.0)
    m.reset()
    m.update([[0, 0.9, 50, 50, 60, 60]], [[0, 0, 0, 10, 10]])
    assert m.eval() == pytest.approx(0.0)
    m.reset()
    m.update(T([[0, 0.9, 0, 0, 10, 10], [0, 0.1, 50, 50, 60, 60]]),
             T([[0, 0, 0, 10, 10]]))
    assert m.eval() == pytest.approx(1.0)


def test_detection_map_11point():
    m = DetectionMAP(ap_version="11point")
    m.update([[0, 0.9, 0, 0, 10, 10]], [[0, 0, 0, 10, 10]])
    assert m.eval() == pytest.approx(1.0)


def test_precision_recall_multiclass():
    m = PrecisionRecall(num_classes=3)
    m.update(T([0, 1, 2, 1]), np.array([0, 1, 2, 2]))
    out = m.eval()
    assert out["micro_precision"] == pytest.approx(3 / 4)
    assert out["micro_recall"] == pytest.approx(3 / 4)
    assert 0 < out["macro_f1"] <= 1.0
