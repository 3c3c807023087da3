"""Detection op family (port of paddle_tpu/ops/detection.py): IoU, box
coding, priors and anchors, matching, NMS, RoI pooling, proposals,
training-target assignment and the YOLOv3 loss.

These are JAX's own static-shape formulations, not torchvision's: NMS
returns `max_output` padded indices and a valid mask, `roi_pool` is a
4x4 sample grid per bin with rounding, the samplers rank by a uniform
draw. Everything runs batched on the input's device, with no step
reading a value back to the host:

- `nms` keeps JAX's greedy loop (first maximum, as `jnp.argmax`);
  `multiclass_nms` runs every class at once over a [C, N] live tensor;
- `lax.top_k` becomes a stable descending sort (ties to the lower
  index), and the samplers' `argsort(argsort(...))` ranks are stable;
- `.at[].max` becomes `scatter_reduce(reduce="amax", include_self=True)`,
  so a padded gt row never clears a valid gt's forced anchor;
- `bipartite_match`'s final scatter keeps XLA's serial order: of
  several writes to one column, the last one stays.

The samplers take a `torch.Generator` where JAX takes a key; their
selection, `rpn_target_assign_by_uniform` and
`generate_proposal_labels_by_uniform`, takes the uniform vector itself,
so that JAX's draw can be fed to it. Index outputs are int64 where
JAX's are int32. Boxes are [x1, y1, x2, y2] unless noted.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.ops.functional import one_hot

NEG_INF = -1e9


def _stable_desc(x, k: int):
    """lax.top_k: the k largest, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _rank(x):
    """argsort(argsort(x)), both stable."""
    return torch.argsort(torch.argsort(x, stable=True), stable=True)


# ------------------------------------------------------------------- IoU

def box_area(boxes):
    return torch.clamp(boxes[..., 2] - boxes[..., 0], min=0) * \
        torch.clamp(boxes[..., 3] - boxes[..., 1], min=0)


def _iou(x, y, off: float):
    """IoU of boxes x and y broadcast against each other."""
    ix1 = torch.maximum(x[..., 0], y[..., 0])
    iy1 = torch.maximum(x[..., 1], y[..., 1])
    ix2 = torch.minimum(x[..., 2], y[..., 2])
    iy2 = torch.minimum(x[..., 3], y[..., 3])
    inter = torch.clamp(ix2 - ix1 + off, min=0) * \
        torch.clamp(iy2 - iy1 + off, min=0)
    ax = (x[..., 2] - x[..., 0] + off) * (x[..., 3] - x[..., 1] + off)
    ay = (y[..., 2] - y[..., 0] + off) * (y[..., 3] - y[..., 1] + off)
    union = ax + ay - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-10),
                       torch.zeros_like(union))


def iou_similarity(x, y, box_normalized: bool = True):
    """Pairwise IoU [N, 4] x [M, 4] -> [N, M]; the non-normalized mode
    adds the +1 pixel convention."""
    return _iou(x[:, None, :], y[None, :, :], 0.0 if box_normalized else 1.0)


# --------------------------------------------------------------- box coder

def box_coder(prior_boxes, prior_var, target, code_type: str = "encode",
              box_normalized: bool = True):
    """encode: target [N, 4] gt boxes against priors [M, 4] -> [N, M, 4]
    deltas. decode: deltas [N, M, 4] (or [N, 4] with M == N priors) ->
    boxes. prior_var [4] or [M, 4] (None = ones)."""
    off = 0.0 if box_normalized else 1.0
    pw = prior_boxes[..., 2] - prior_boxes[..., 0] + off
    ph = prior_boxes[..., 3] - prior_boxes[..., 1] + off
    pcx = prior_boxes[..., 0] + pw * 0.5
    pcy = prior_boxes[..., 1] + ph * 0.5
    v = (torch.ones(4, dtype=torch.float32, device=prior_boxes.device)
         if prior_var is None
         else torch.as_tensor(prior_var, device=prior_boxes.device))
    if code_type == "encode":
        tw = target[:, 2] - target[:, 0] + off
        th = target[:, 3] - target[:, 1] + off
        tcx = target[:, 0] + tw * 0.5
        tcy = target[:, 1] + th * 0.5
        dx = (tcx[:, None] - pcx[None]) / pw[None]
        dy = (tcy[:, None] - pcy[None]) / ph[None]
        dw = torch.log(torch.clamp(tw[:, None] / pw[None], min=1e-10))
        dh = torch.log(torch.clamp(th[:, None] / ph[None], min=1e-10))
        return torch.stack([dx, dy, dw, dh], dim=-1) / v
    if code_type == "decode":
        d = target * v
        cx = d[..., 0] * pw + pcx
        cy = d[..., 1] * ph + pcy
        w = torch.exp(d[..., 2]) * pw
        h = torch.exp(d[..., 3]) * ph
        return torch.stack([cx - w * 0.5, cy - h * 0.5,
                            cx + w * 0.5 - off, cy + h * 0.5 - off], dim=-1)
    raise ValueError(f"unknown code_type {code_type!r}")


def box_clip(boxes, im_shape):
    """Clip boxes into the image; im_shape = (h, w)."""
    h, w = im_shape[0], im_shape[1]

    def clip(v, hi):
        hi = torch.as_tensor(hi - 1, dtype=v.dtype, device=v.device)
        return torch.minimum(torch.clamp(v, min=0), hi)
    return torch.stack([clip(boxes[..., 0], w), clip(boxes[..., 1], h),
                        clip(boxes[..., 2], w), clip(boxes[..., 3], h)],
                       dim=-1)


def polygon_box_transform(x):
    """Quad offsets -> absolute coordinates on the grid: x [N, 8, H, W],
    even channels from 4 * col, odd from 4 * row."""
    _, c, hh, ww = x.shape
    dev = x.device
    col = torch.arange(ww, dtype=x.dtype, device=dev)[None, None, None] * 4.0
    row = torch.arange(hh, dtype=x.dtype, device=dev)[None, None, :,
                                                      None] * 4.0
    even = (torch.arange(c, device=dev) % 2 == 0)[None, :, None, None]
    return torch.where(even, col, row) - x


# ---------------------------------------------------------------- priors

def _grid_centers(fh: int, fw: int, sh: float, sw: float, offset: float,
                  dev):
    """Cell centers (cx, cy) as [H, W, 1] float32, jnp.meshgrid's xy."""
    cx = (torch.arange(fw, dtype=torch.float32, device=dev) + offset) * sw
    cy = (torch.arange(fh, dtype=torch.float32, device=dev) + offset) * sh
    cxg, cyg = torch.meshgrid(cx, cy, indexing="xy")
    return cxg[..., None], cyg[..., None]


def _boxes_and_var(boxes, variance, clip: bool):
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = torch.as_tensor(variance, dtype=torch.float32,
                          device=boxes.device).expand(boxes.shape)
    return boxes, var


def prior_box(feature_shape: Tuple[int, int], image_shape: Tuple[int, int],
              min_sizes: Sequence[float],
              max_sizes: Sequence[float] = (),
              aspect_ratios: Sequence[float] = (1.0,),
              variance: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
              flip: bool = True, clip: bool = False,
              step: Tuple[float, float] = (0.0, 0.0),
              offset: float = 0.5, device: DeviceLike = None):
    """SSD prior boxes: (boxes [H, W, P, 4], variances [H, W, P, 4]) in
    normalized coordinates, float32, on `device` (default the card)."""
    dev = resolve_device(device)
    fh, fw = feature_shape
    ih, iw = image_shape
    sw = step[1] or iw / fw
    sh = step[0] or ih / fh
    ars = [1.0]
    for ar in aspect_ratios:
        if all(abs(ar - a) > 1e-6 for a in ars):
            ars.append(ar)
            if flip:
                ars.append(1.0 / ar)
    whs = [(ms * np.sqrt(ar), ms / np.sqrt(ar))
           for ms in min_sizes for ar in ars]
    whs += [(np.sqrt(ms * xs), np.sqrt(ms * xs))
            for ms, xs in zip(min_sizes, max_sizes)]
    wh = torch.as_tensor(np.asarray(whs, np.float32), device=dev)
    cxg, cyg = _grid_centers(fh, fw, sh, sw, offset, dev)
    hw, hh = wh[None, None, :, 0] * 0.5, wh[None, None, :, 1] * 0.5
    boxes = torch.stack([(cxg - hw) / iw, (cyg - hh) / ih,
                         (cxg + hw) / iw, (cyg + hh) / ih], dim=-1)
    return _boxes_and_var(boxes, variance, clip)


def density_prior_box(feature_shape, image_shape,
                      fixed_sizes: Sequence[float],
                      fixed_ratios: Sequence[float],
                      densities: Sequence[int],
                      variance=(0.1, 0.1, 0.2, 0.2),
                      step=(0.0, 0.0), offset: float = 0.5,
                      clip: bool = False, device: DeviceLike = None):
    """Density prior boxes: each fixed size sampled on a density x
    density sub-grid per cell. Float32 on `device` (default the card)."""
    dev = resolve_device(device)
    fh, fw = feature_shape
    ih, iw = image_shape
    sw = step[1] or iw / fw
    sh = step[0] or ih / fh
    tmpl = []
    for size, density in zip(fixed_sizes, densities):
        shift = sw / density
        for ratio in fixed_ratios:
            bw, bh = size * np.sqrt(ratio), size / np.sqrt(ratio)
            for dx in range(density):
                for dy in range(density):
                    tmpl.append(((dx + 0.5) * shift - sw * 0.5,
                                 (dy + 0.5) * shift - sh * 0.5, bw, bh))
    t = torch.as_tensor(np.asarray(tmpl, np.float32), device=dev)
    cxg, cyg = _grid_centers(fh, fw, sh, sw, offset, dev)
    ccx = cxg + t[None, None, :, 0]
    ccy = cyg + t[None, None, :, 1]
    hw, hh = t[None, None, :, 2] * 0.5, t[None, None, :, 3] * 0.5
    boxes = torch.stack([(ccx - hw) / iw, (ccy - hh) / ih,
                         (ccx + hw) / iw, (ccy + hh) / ih], dim=-1)
    return _boxes_and_var(boxes, variance, clip)


def anchor_generator(feature_shape, anchor_sizes: Sequence[float],
                     aspect_ratios: Sequence[float],
                     stride: Tuple[float, float],
                     variance=(0.1, 0.1, 0.2, 0.2),
                     offset: float = 0.5, device: DeviceLike = None):
    """RPN anchors in image coordinates: (anchors [H, W, A, 4],
    variances), float32 on `device` (default the card)."""
    dev = resolve_device(device)
    fh, fw = feature_shape
    sx, sy = stride
    combos = []
    for ar in aspect_ratios:
        for sz in anchor_sizes:
            area = sx * sy
            w = np.sqrt(area / ar)
            h = w * ar
            combos.append((w * sz / np.sqrt(area), h * sz / np.sqrt(area)))
    wh = torch.as_tensor(np.asarray(combos, np.float32), device=dev)
    cxg, cyg = _grid_centers(fh, fw, sy, sx, offset, dev)
    hw, hh = wh[None, None, :, 0] * 0.5, wh[None, None, :, 1] * 0.5
    anchors = torch.stack([cxg - hw, cyg - hh, cxg + hw, cyg + hh], dim=-1)
    return _boxes_and_var(anchors, variance, False)


# ------------------------------------------------------------------ match

def bipartite_match(similarity):
    """Greedy bipartite matching: repeatedly take the largest entry
    (first maximum) while it is > 0, retire its row and column.
    similarity [N, M] (rows gt, columns priors) -> (match [M] int64
    row or -1, match_dist [M])."""
    n, m = similarity.shape
    k = min(n, m)
    dev = similarity.device
    row_ok = torch.ones(n, dtype=torch.bool, device=dev)
    col_ok = torch.ones(m, dtype=torch.bool, device=dev)
    rows, cols = torch.arange(n, device=dev), torch.arange(m, device=dev)
    steps = []
    for _ in range(k):
        masked = torch.where(row_ok[:, None] & col_ok[None, :], similarity,
                             torch.full_like(similarity, NEG_INF))
        flat = torch.argmax(masked)
        r, c = flat // m, flat % m
        best = masked.reshape(-1)[flat]
        valid = best > 0
        row_ok = row_ok & ~(valid & (rows == r))
        col_ok = col_ok & ~(valid & (cols == c))
        steps.append((r, c, best, valid))
    rs, cs, bests, valids = (torch.stack(s) for s in zip(*steps))
    # XLA scatters the k writes in order: an invalid step writes the
    # initial (-1, 0) at column 0, after any valid write there
    safe_c = torch.where(valids, cs, torch.zeros_like(cs))
    writes = safe_c[:, None] == cols[None, :]                  # [k, M]
    order = torch.arange(1, k + 1, device=dev)[:, None]
    last = torch.amax(torch.where(writes, order, torch.zeros_like(order)),
                      dim=0)                                   # [M]
    pick = torch.clamp(last - 1, min=0)
    hit = (last > 0) & valids[pick]
    match = torch.where(hit, rs[pick], torch.full_like(cols, -1))
    dist = torch.where(hit, bests[pick], torch.zeros_like(bests[pick]))
    return match, dist


def target_assign(x, match_indices, mismatch_value=0):
    """Per-prior targets by match index: x [N, D], match [M] -> (out
    [M, D], weight [M])."""
    out = x[torch.clamp(match_indices.long(), min=0)]
    w = match_indices >= 0
    return (torch.where(w[:, None], out, torch.full_like(out, mismatch_value)),
            w.to(x.dtype))


def mine_hard_examples(cls_loss, match_indices, neg_pos_ratio: float = 3.0):
    """OHEM (max_negative): the top-loss negatives up to neg_pos_ratio
    x positives. A boolean mask over priors [M]."""
    pos = match_indices >= 0
    n_neg = torch.minimum((neg_pos_ratio * torch.sum(pos)).long(),
                          torch.sum(~pos))
    neg_loss = torch.where(pos, torch.full_like(cls_loss, NEG_INF), cls_loss)
    return (~pos) & (_rank(-neg_loss) < n_neg)


# -------------------------------------------------------------------- NMS

def _nms_rows(boxes, scores, iou_threshold: float, max_output: int,
              score_threshold: float):
    """Greedy NMS of every row of scores [C, N] over boxes [N, 4] at
    once: (indices [C, max_output] int64 padded with -1, valid mask)."""
    live = torch.where(scores > score_threshold, scores,
                       torch.full_like(scores, NEG_INF))
    cols = torch.arange(scores.shape[1], device=scores.device)[None, :]
    idx, ok = [], []
    for _ in range(max_output):
        best = torch.argmax(live, dim=1)                          # [C]
        good = torch.gather(live, 1, best[:, None])[:, 0] > NEG_INF / 2
        iou = _iou(boxes[best][:, None, :], boxes[None, :, :], 0.0)
        live = torch.where((iou > iou_threshold) | (cols == best[:, None]),
                           torch.full_like(live, NEG_INF), live)
        idx.append(torch.where(good, best, torch.full_like(best, -1)))
        ok.append(good)
    return torch.stack(idx, dim=1), torch.stack(ok, dim=1)


def nms(boxes, scores, iou_threshold: float = 0.3, max_output: int = 100,
        score_threshold: float = -np.inf):
    """Static-shape greedy NMS: (indices [max_output] int64 padded with
    -1, valid mask)."""
    idx, ok = _nms_rows(boxes, scores[None], iou_threshold, max_output,
                        score_threshold)
    return idx[0], ok[0]


def multiclass_nms(boxes, scores, score_threshold: float = 0.01,
                   nms_threshold: float = 0.3, nms_top_k: int = 64,
                   keep_top_k: int = 100,
                   background_label: int = 0):
    """Per-class NMS, all classes at once, then the global top
    keep_top_k. boxes [N, 4], scores [C, N] -> (out [keep_top_k, 6]
    rows (label, score, x1, y1, x2, y2), padded rows label -1; the valid
    count)."""
    c = scores.shape[0]
    idx, ok = _nms_rows(boxes, scores, nms_threshold, nms_top_k,
                        score_threshold)
    safe = torch.clamp(idx, min=0)
    cls_s = torch.gather(scores, 1, safe)                       # [C, K]
    cls_b = boxes[safe]                                         # [C, K, 4]
    labels = torch.arange(c, device=scores.device)[:, None].expand_as(safe)
    flat_s = torch.where(ok & (labels != background_label), cls_s,
                         torch.full_like(cls_s, NEG_INF)).reshape(-1)
    top_s, pick = _stable_desc(flat_s, keep_top_k)
    valid = top_s > NEG_INF / 2
    dt = torch.promote_types(torch.float32, scores.dtype)
    lab = torch.where(valid, labels.reshape(-1)[pick],
                      torch.full_like(pick, -1)).to(dt)
    box = cls_b.reshape(-1, 4)[pick]
    out = torch.cat([lab[:, None],
                     torch.where(valid, top_s, torch.zeros_like(top_s)
                                 )[:, None].to(dt),
                     torch.where(valid[:, None], box,
                                 torch.zeros_like(box)).to(dt)], dim=-1)
    return out, torch.sum(valid)


# ------------------------------------------------------------------- RoI

def _bin_samples(lo, size, bins: int, sr: int):
    """lo + (bin + (s + 0.5) / sr) * size: [R, bins * sr] sample
    coordinates (lo, size [R])."""
    dev = lo.device
    frac = (torch.arange(bins, device=dev)[:, None]
            + (torch.arange(sr, dtype=torch.float32, device=dev)[None, :]
               + 0.5) / sr)
    return (lo[:, None, None] + frac[None] * size[:, None, None]).reshape(
        lo.shape[0], -1)


def _bilinear_corners(g, n: int):
    """floor-and-clip corners of sample coordinates g in [0, n - 1]: (i0,
    i1, weight of i1)."""
    f0 = torch.clamp(torch.floor(g), 0, n - 1)
    i1 = torch.clamp(f0 + 1, 0, n - 1).long()
    return f0.long(), i1, torch.clamp(g - f0, 0.0, 1.0)


def roi_align(features, rois, output_size: Tuple[int, int],
              spatial_scale: float = 1.0, sampling_ratio: int = 2):
    """RoI Align: features [H, W, C], rois [R, 4] in input coordinates;
    sampling_ratio^2 bilinear samples per bin, averaged. -> [R, ph, pw,
    C]."""
    hh, ww, _ = features.shape
    ph, pw = output_size
    sr = max(sampling_ratio, 1)
    x1, y1, x2, y2 = (rois.to(torch.float32) * spatial_scale).unbind(-1)
    gy = _bin_samples(y1, torch.clamp(y2 - y1, min=1.0) / ph, ph, sr)
    gx = _bin_samples(x1, torch.clamp(x2 - x1, min=1.0) / pw, pw, sr)
    y0i, y1i, wy = _bilinear_corners(gy, hh)
    x0i, x1i, wx = _bilinear_corners(gx, ww)

    def f(yi, xi):                                   # [R, ph*sr, pw*sr, C]
        return features[yi[:, :, None], xi[:, None, :]]
    wx, wy = wx[:, None, :, None], wy[:, :, None, None]
    top = f(y0i, x0i) * (1 - wx) + f(y0i, x1i) * wx
    bot = f(y1i, x0i) * (1 - wx) + f(y1i, x1i) * wx
    val = top * (1 - wy) + bot * wy
    return val.reshape(-1, ph, sr, pw, sr, val.shape[-1]).mean(dim=(2, 4))


def roi_pool(features, rois, output_size: Tuple[int, int],
             spatial_scale: float = 1.0):
    """RoI max pool as JAX approximates it: the max of a 4 x 4 grid of
    rounded samples per bin over the rounded RoI. -> [R, ph, pw, C]."""
    hh, ww, _ = features.shape
    ph, pw = output_size
    sr = 4
    x1, y1, x2, y2 = torch.round(rois.to(torch.float32)
                                 * spatial_scale).unbind(-1)
    gy = _bin_samples(y1, torch.clamp(y2 - y1 + 1, min=1.0) / ph, ph, sr) \
        - 0.5
    gx = _bin_samples(x1, torch.clamp(x2 - x1 + 1, min=1.0) / pw, pw, sr) \
        - 0.5
    yi = torch.clamp(torch.round(gy), 0, hh - 1).long()
    xi = torch.clamp(torch.round(gx), 0, ww - 1).long()
    vals = features[yi[:, :, None], xi[:, None, :]]
    return vals.reshape(-1, ph, sr, pw, sr, vals.shape[-1]).amax(dim=(2, 4))


# ------------------------------------------------------------- proposals

def generate_proposals(scores, deltas, anchors, variances, im_shape,
                       pre_nms_top_n: int = 6000,
                       post_nms_top_n: int = 1000,
                       nms_threshold: float = 0.7,
                       min_size: float = 0.0):
    """RPN proposals: top pre_nms_top_n by score, decode against the
    anchors, clip, drop small boxes, NMS. scores [A], deltas / anchors
    [A, 4] -> (rois [post_nms_top_n, 4], scores, valid mask)."""
    top_s, idx = _stable_desc(scores, min(pre_nms_top_n, scores.shape[0]))
    v = variances[idx] if variances is not None else None
    boxes = box_clip(box_coder(anchors[idx], v, deltas[idx], "decode"),
                     im_shape)
    ok = ((boxes[:, 2] - boxes[:, 0]) >= min_size) & \
        ((boxes[:, 3] - boxes[:, 1]) >= min_size)
    s = torch.where(ok, top_s, torch.full_like(top_s, NEG_INF))
    pick, valid = nms(boxes, s, nms_threshold, post_nms_top_n)
    safe = torch.clamp(pick, min=0)
    kept = boxes[safe]
    return (torch.where(valid[:, None], kept, torch.zeros_like(kept)),
            torch.where(valid, s[safe], torch.zeros_like(s[safe])), valid)


# ------------------------------------------------- training target assignment

def encode_boxes_paired(priors, targets, box_normalized: bool = False):
    """Row-wise encoding: priors [K, 4] against targets [K, 4] -> [K, 4]
    deltas (the diagonal of box_coder's pairwise encode)."""
    off = 0.0 if box_normalized else 1.0
    pw = priors[:, 2] - priors[:, 0] + off
    ph = priors[:, 3] - priors[:, 1] + off
    pcx = priors[:, 0] + pw * 0.5
    pcy = priors[:, 1] + ph * 0.5
    tw = targets[:, 2] - targets[:, 0] + off
    th = targets[:, 3] - targets[:, 1] + off
    tcx = targets[:, 0] + tw * 0.5
    tcy = targets[:, 1] + th * 0.5
    return torch.stack([(tcx - pcx) / pw, (tcy - pcy) / ph,
                        torch.log(torch.clamp(tw / pw, min=1e-10)),
                        torch.log(torch.clamp(th / ph, min=1e-10))], dim=-1)


def _best_gt(gt_boxes, boxes, gt_valid):
    """Each box's best IoU over the valid gts and its gt (first max),
    and the [G, A] IoU."""
    iou = iou_similarity(gt_boxes, boxes, box_normalized=False)
    iou = torch.where(gt_valid[:, None], iou, torch.zeros_like(iou))
    best_iou, best_gt = torch.max(iou, dim=0)
    return iou, best_iou, best_gt


def _sample(mask, u, n):
    """mask & (rank of u among the mask's entries < n), ranked stably."""
    rank = _rank(torch.where(mask, u, torch.full_like(u, 2.0)))
    return mask & (rank < n), rank


def rpn_target_assign_by_uniform(anchors, gt_boxes, gt_valid, u,
                                 num_samples: int = 256,
                                 fg_fraction: float = 0.5,
                                 positive_overlap: float = 0.7,
                                 negative_overlap: float = 0.3):
    """`rpn_target_assign`'s labeling and subsampling, ranked by the
    uniform draw u [A] (JAX draws `jax.random.uniform(rng, (A,))`)."""
    a = anchors.shape[0]
    iou, best_iou, best_gt = _best_gt(gt_boxes, anchors, gt_valid)
    best_anchor = torch.argmax(iou, dim=1)
    forced = torch.zeros(a, dtype=torch.int64, device=anchors.device
                         ).scatter_reduce(0, best_anchor, gt_valid.long(),
                                          reduce="amax",
                                          include_self=True) > 0
    fg = forced | (best_iou >= positive_overlap)
    bg = (~fg) & (best_iou < negative_overlap)
    n_fg = torch.clamp(torch.sum(fg), max=int(num_samples * fg_fraction))
    fg_keep, _ = _sample(fg, u, n_fg)
    bg_keep, _ = _sample(bg, u, torch.minimum(num_samples - n_fg,
                                              torch.sum(bg)))
    labels = torch.where(fg_keep, 1, torch.where(bg_keep, 0, -1))
    targets = encode_boxes_paired(anchors, gt_boxes[best_gt])
    targets = torch.where(fg_keep[:, None], targets, torch.zeros_like(targets))
    return labels, targets, fg_keep.to(torch.float32)


def rpn_target_assign(anchors, gt_boxes, gt_valid, rng: torch.Generator,
                      num_samples: int = 256, fg_fraction: float = 0.5,
                      positive_overlap: float = 0.7,
                      negative_overlap: float = 0.3):
    """RPN anchor labeling and subsampling. anchors [A, 4]; gt_boxes
    [G, 4]; gt_valid [G] bool. Returns (labels [A] int64 1 fg / 0 bg /
    -1 ignore, bbox targets [A, 4], inside weights [A] = fg mask).
    Anchors over positive_overlap (or a valid gt's best anchor) are fg,
    under negative_overlap bg; the subsample keeps num_samples with
    fg_fraction fg, ranked by a uniform draw from `rng`."""
    u = torch.rand(anchors.shape[0], generator=rng, device=anchors.device)
    return rpn_target_assign_by_uniform(
        anchors, gt_boxes, gt_valid, u, num_samples, fg_fraction,
        positive_overlap, negative_overlap)


def generate_proposal_labels_by_uniform(rois, gt_boxes, gt_classes, gt_valid,
                                        u, batch_size_per_im: int = 128,
                                        fg_fraction: float = 0.25,
                                        fg_thresh: float = 0.5,
                                        bg_thresh_hi: float = 0.5,
                                        bg_thresh_lo: float = 0.0):
    """`generate_proposal_labels`' sampling and targets, ranked by the
    uniform draw u [R] (JAX draws `jax.random.uniform(rng, (R,))`)."""
    _, best_iou, best_gt = _best_gt(gt_boxes, rois, gt_valid)
    fg = best_iou >= fg_thresh
    bg = (best_iou < bg_thresh_hi) & (best_iou >= bg_thresh_lo) & (~fg)
    s = batch_size_per_im
    n_fg = torch.clamp(torch.sum(fg), max=int(s * fg_fraction))
    fg_keep, fg_rank = _sample(fg, u, n_fg)
    bg_keep, bg_rank = _sample(bg, u, torch.minimum(s - n_fg, torch.sum(bg)))
    # selected rois first (fg, then bg, each in rank order), then the rest
    sel_key = torch.where(fg_keep, fg_rank,
                          torch.where(bg_keep, s + bg_rank,
                                      torch.full_like(bg_rank,
                                                      2 * s + 1000000)))
    order = torch.argsort(sel_key, stable=True)[:s]
    sel_valid = (fg_keep | bg_keep)[order]
    out_rois = rois[order]
    out_rois = torch.where(sel_valid[:, None], out_rois,
                           torch.zeros_like(out_rois))
    sel_fg = fg[order] & sel_valid
    labels = torch.where(sel_fg, gt_classes.long()[best_gt][order],
                         torch.where(sel_valid, 0, -1))
    targets = encode_boxes_paired(out_rois, gt_boxes[best_gt][order])
    targets = torch.where(sel_fg[:, None], targets, torch.zeros_like(targets))
    return out_rois, labels, targets, sel_fg.to(torch.float32)


def generate_proposal_labels(rois, gt_boxes, gt_classes, gt_valid,
                             rng: torch.Generator,
                             batch_size_per_im: int = 128,
                             fg_fraction: float = 0.25,
                             fg_thresh: float = 0.5,
                             bg_thresh_hi: float = 0.5,
                             bg_thresh_lo: float = 0.0):
    """Sample RoIs and assign the second stage's targets. rois [R, 4];
    gt_boxes [G, 4]; gt_classes [G]; gt_valid [G] bool. Returns
    fixed-size (rois [S, 4], labels [S] int64 (0 bg, -1 pad), bbox
    targets [S, 4], fg mask [S]) with S = batch_size_per_im, ranked by
    a uniform draw from `rng`."""
    u = torch.rand(rois.shape[0], generator=rng, device=rois.device)
    return generate_proposal_labels_by_uniform(
        rois, gt_boxes, gt_classes, gt_valid, u, batch_size_per_im,
        fg_fraction, fg_thresh, bg_thresh_hi, bg_thresh_lo)


def generate_mask_labels(rois, fg_mask, roi_gt_index, gt_masks,
                         resolution: int = 14):
    """Each fg RoI's matched instance mask cropped and resized to
    [resolution, resolution] (float32 0/1). rois [S, 4]; fg_mask [S];
    roi_gt_index [S]; gt_masks [G, Hm, Wm]. -> [S, res, res]."""
    hm, wm = gt_masks.shape[1:]
    x1, y1, x2, y2 = rois.to(torch.float32).unbind(-1)
    frac = (torch.arange(resolution, dtype=torch.float32,
                         device=rois.device) + 0.5) / resolution
    gy = y1[:, None] + frac[None] * torch.clamp(y2 - y1, min=1.0)[:, None]
    gx = x1[:, None] + frac[None] * torch.clamp(x2 - x1, min=1.0)[:, None]
    yi = torch.clamp(torch.round(gy), 0, hm - 1).long()
    xi = torch.clamp(torch.round(gx), 0, wm - 1).long()
    gi = roi_gt_index.long()
    patch = gt_masks[gi[:, None, None], yi[:, :, None], xi[:, None, :]]
    on = (patch > 0.5).to(torch.float32)
    return torch.where((fg_mask > 0)[:, None, None], on, torch.zeros_like(on))


# ------------------------------------------------------- RoI (tail variants)

def psroi_pool(features, rois, output_size: Tuple[int, int],
               spatial_scale: float = 1.0, sampling_ratio: int = 2):
    """Position-sensitive RoI pooling: channels C = ph * pw * out_c, and
    bin (i, j) averages only its own channel group. features [H, W, C];
    rois [R, 4] -> [R, ph, pw, out_c]."""
    hh, ww, c = features.shape
    ph, pw = output_size
    out_c = c // (ph * pw)
    sr = max(sampling_ratio, 1)
    grouped = features.reshape(hh, ww, ph * pw, out_c)
    x1, y1, x2, y2 = (rois.to(torch.float32) * spatial_scale).unbind(-1)
    r = rois.shape[0]
    gy = _bin_samples(y1, torch.clamp(y2 - y1, min=1.0) / ph, ph, sr)
    gx = _bin_samples(x1, torch.clamp(x2 - x1, min=1.0) / pw, pw, sr)
    y0i, y1i, wy = (t.reshape(r, ph, sr) for t in _bilinear_corners(gy, hh))
    x0i, x1i, wx = (t.reshape(r, pw, sr) for t in _bilinear_corners(gx, ww))
    wy = wy[:, :, None, :, None, None]
    wx = wx[:, None, :, None, :, None]
    dev = features.device
    bin_g = (torch.arange(ph, device=dev)[:, None] * pw
             + torch.arange(pw, device=dev)[None, :])[None, :, :, None, None]

    def g(yi, xi):                          # [R, ph, pw, sr, sr, out_c]
        return grouped[yi[:, :, None, :, None], xi[:, None, :, None, :],
                       bin_g]
    top = g(y0i, x0i) * (1 - wx) + g(y0i, x1i) * wx
    bot = g(y1i, x0i) * (1 - wx) + g(y1i, x1i) * wx
    return (top * (1 - wy) + bot * wy).mean(dim=(3, 4))


def roi_perspective_transform(features, quads, out_size: Tuple[int, int],
                              spatial_scale: float = 1.0):
    """Warp quadrilateral RoIs to a rectangle by the homography taking
    the output corners (0, 0), (ow-1, 0), (ow-1, oh-1), (0, oh-1) to
    each quad's, bilinear-sampled; outside the map reads zero.
    features [H, W, C]; quads [R, 8] clockwise from top-left ->
    [R, oh, ow, C]."""
    hh, ww, _ = features.shape
    oh, ow = out_size
    dev = features.device
    r = quads.shape[0]
    dst = quads.to(torch.float32).reshape(r, 4, 2) * spatial_scale
    src = ((0.0, 0.0), (ow - 1.0, 0.0), (ow - 1.0, oh - 1.0), (0.0, oh - 1.0))
    zero = torch.zeros(r, dtype=torch.float32, device=dev)
    one = torch.ones(r, dtype=torch.float32, device=dev)
    rows = []
    for i, (u, v) in enumerate(src):
        x, y = dst[:, i, 0], dst[:, i, 1]
        rows.append(torch.stack([one * u, one * v, one, zero, zero, zero,
                                 -u * x, -v * x], dim=-1))
        rows.append(torch.stack([zero, zero, zero, one * u, one * v, one,
                                 -u * y, -v * y], dim=-1))
    h8 = torch.linalg.solve(torch.stack(rows, dim=1), dst.reshape(r, 8))
    hmat = torch.cat([h8, one[:, None]], dim=1).reshape(r, 3, 3)
    vv, uu = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=dev),
                            torch.arange(ow, dtype=torch.float32, device=dev),
                            indexing="ij")
    base = torch.stack([uu, vv, torch.ones_like(uu)], dim=-1)   # [oh, ow, 3]
    pts = base[None] @ hmat.transpose(1, 2)[:, None]            # [R,oh,ow,3]
    gx = pts[..., 0] / torch.clamp(pts[..., 2], min=1e-8)
    gy = pts[..., 1] / torch.clamp(pts[..., 2], min=1e-8)
    x0i, x1i, wx = _bilinear_corners(gx, ww)
    y0i, y1i, wy = _bilinear_corners(gy, hh)
    wx, wy = wx[..., None], wy[..., None]
    val = ((features[y0i, x0i] * (1 - wx) + features[y0i, x1i] * wx)
           * (1 - wy)
           + (features[y1i, x0i] * (1 - wx) + features[y1i, x1i] * wx) * wy)
    inside = ((gx >= 0) & (gx <= ww - 1) & (gy >= 0) & (gy <= hh - 1))
    return torch.where(inside[..., None], val, torch.zeros_like(val))


# ---------------------------------------------------------------- YOLO loss

def _bce(logit, t):
    return torch.clamp(logit, min=0) - logit * t + \
        torch.log1p(torch.exp(-torch.abs(logit)))


def yolov3_loss(preds, gt_boxes, gt_labels, gt_valid, anchors,
                num_classes: int, downsample: int = 32,
                ignore_thresh: float = 0.7):
    """YOLOv3 training loss, one scale: preds [H, W, A * (5 + classes)]
    raw head output (NHWC); anchors [A, 2] (w, h) in pixels; gt_boxes
    [G, 4] (cx, cy, w, h) normalized; gt_labels [G]; gt_valid [G] bool.
    A scalar: objectness BCE (non-responsible predictions over
    ignore_thresh IoU ignored) + class BCE + scaled L1 box loss of the
    responsible cells."""
    h, w, _ = preds.shape
    a = anchors.shape[0]
    dev, dt = preds.device, preds.dtype
    p = preds.reshape(h, w, a, 5 + num_classes)
    tx, ty, tw, th, tobj = p.unbind(-1)[:5]
    tcls = p[..., 5:]
    img_w, img_h = w * downsample, h * downsample
    anchors = anchors.to(torch.float32)

    gx = (torch.sigmoid(tx) + torch.arange(w, device=dev)[None, :, None]) / w
    gy = (torch.sigmoid(ty) + torch.arange(h, device=dev)[:, None, None]) / h
    anc_w, anc_h = anchors[None, None, :, 0], anchors[None, None, :, 1]
    gw = torch.exp(torch.clamp(tw, -10, 10)) * anc_w / img_w
    gh = torch.exp(torch.clamp(th, -10, 10)) * anc_h / img_h
    pred_boxes = torch.stack([gx - gw / 2, gy - gh / 2,
                              gx + gw / 2, gy + gh / 2], dim=-1)
    cx, cy, bw, bh = gt_boxes.unbind(-1)
    gxyxy = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                        dim=-1)
    iou_all = iou_similarity(gxyxy, pred_boxes.reshape(-1, 4))
    iou_all = torch.where(gt_valid[:, None], iou_all,
                          torch.zeros_like(iou_all))
    ignore = torch.amax(iou_all, dim=0).reshape(h, w, a) > ignore_thresh

    # responsibility: each gt's anchor of best shape-only IoU, at its cell
    ci = torch.clamp((cx * w).long(), 0, w - 1)
    cj = torch.clamp((cy * h).long(), 0, h - 1)
    aw, ah = anchors[:, 0] / img_w, anchors[:, 1] / img_h
    inter = torch.minimum(bw[:, None], aw[None]) * \
        torch.minimum(bh[:, None], ah[None])
    union = (bw * bh)[:, None] + (aw * ah)[None] - inter
    ba = torch.argmax(inter / torch.clamp(union, min=1e-9), dim=1)
    tgt = torch.stack([cx * w - ci, cy * h - cj,
                       torch.log(torch.clamp(bw * img_w, min=1e-9)
                                 / anchors[ba, 0]),
                       torch.log(torch.clamp(bh * img_h, min=1e-9)
                                 / anchors[ba, 1])], dim=-1)
    onehot = one_hot(gt_labels, num_classes, dtype=dt)
    scale = 2.0 - bw * bh

    cell = (cj * w + ci) * a + ba
    obj_target = torch.zeros(h * w * a, dtype=dt, device=dev).scatter_reduce(
        0, cell, gt_valid.to(dt), reduce="amax",
        include_self=True).reshape(h, w, a)
    noobj_w = torch.where(ignore & (obj_target < 0.5), 0.0, 1.0).to(dt)
    obj_loss = torch.sum(_bce(tobj, obj_target) * noobj_w)

    px = torch.stack([torch.sigmoid(tx[cj, ci, ba]),
                      torch.sigmoid(ty[cj, ci, ba]),
                      tw[cj, ci, ba], th[cj, ci, ba]], dim=-1)
    box_l = torch.sum(torch.abs(px - tgt), dim=-1) * scale
    cls_l = torch.sum(_bce(tcls[cj, ci, ba], onehot), dim=-1)
    per_gt = torch.where(gt_valid, box_l + cls_l, torch.zeros_like(box_l))
    return obj_loss + torch.sum(per_gt)
