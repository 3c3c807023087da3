"""SSD-lite detection (port of paddle_tpu/models/detection.py): the
`SSDLite` model, and `ssd_match`, `ssd_loss` and `ssd_detect` over the
port's `ops.detection`.

Static shapes throughout, as in JAX: gt boxes padded to a fixed count
with a valid count per image, NMS output as fixed-size rows padded with
label -1. JAX vmaps the per-image work; `ssd_match` and the detection
ops it calls (`mine_hard_examples`, `box_coder`'s decode,
`multiclass_nms`) take one image, so `ssd_loss` and `ssd_detect` loop
over the batch in Python. No step of either loop reads a value back to
the host.

`ssd_match`'s forced matches are JAX's `.at[].max`:
`scatter_reduce(reduce="amax", include_self=True)`; its argmaxes take
the first maximum, as `jnp.argmax` does. `SSDLite.forward` takes a
`generator` and ignores it, as every model of the zoo does.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from paddle_tpu_torch.device import DeviceLike, resolve_device
from paddle_tpu_torch.nn.layers import BatchNorm, Conv2D
from paddle_tpu_torch.ops import detection as D
from paddle_tpu_torch.ops import functional as F


class _ConvBNRelu(nn.Module):
    def __init__(self, in_features: int, features: int, kernel, stride=1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.conv = Conv2D(in_features, features, kernel, stride=stride,
                           padding="SAME", use_bias=False, dtype=dtype,
                           device=device)
        self.bn = BatchNorm(features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class SSDLite(nn.Module):
    """Small single-shot detector: a four-conv stride-2 backbone, heads
    on the S/8 and S/16 maps. forward(x [B, S, S, 3]) -> (cls_logits
    [B, P, num_classes + 1], loc [B, P, 4]); class 0 is background.
    `priors()` gives the matching [P, 4] prior boxes (normalized xyxy)
    and the [4] variances."""

    ASPECTS = (1.0, 2.0, 0.5, 3.0)

    @classmethod
    def _priors_per_cell(cls) -> int:
        # prior_box's dedupe + flip expansion, +1 for the max_size box
        ars = [1.0]
        for ar in cls.ASPECTS:
            if all(abs(ar - a) > 1e-6 for a in ars):
                ars.append(ar)
                if all(abs(1.0 / ar - a) > 1e-6 for a in ars):
                    ars.append(1.0 / ar)
        return len(ars) + 1

    def __init__(self, num_classes: int = 20, image_size: int = 96,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.device = device
        self.num_classes = num_classes
        self.image_size = image_size
        a = self._priors_per_cell()
        c = num_classes + 1
        kw = dict(dtype=dtype, device=device)
        self.stem = _ConvBNRelu(in_channels, 32, 3, stride=2, **kw)
        self.b1 = _ConvBNRelu(32, 64, 3, stride=2, **kw)
        self.b2 = _ConvBNRelu(64, 128, 3, stride=2, **kw)
        self.b3 = _ConvBNRelu(128, 128, 3, stride=2, **kw)
        self.cls1 = Conv2D(128, a * c, 3, padding="SAME", **kw)
        self.loc1 = Conv2D(128, a * 4, 3, padding="SAME", **kw)
        self.cls2 = Conv2D(128, a * c, 3, padding="SAME", **kw)
        self.loc2 = Conv2D(128, a * 4, 3, padding="SAME", **kw)
        self.eval()

    def _maps(self) -> List[Tuple[int, float, float]]:
        s = self.image_size
        return [(s // 8, 0.2, 0.37), (s // 16, 0.37, 0.54)]

    def priors(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """[P, 4] normalized priors (prior_box, clipped) and the [4]
        variances, on the model's device."""
        boxes = []
        for fs, mn, mx in self._maps():
            b, _ = D.prior_box(
                (fs, fs), (self.image_size, self.image_size),
                min_sizes=[mn * self.image_size],
                max_sizes=[mx * self.image_size],
                aspect_ratios=list(self.ASPECTS), clip=True,
                device=self.device)
            boxes.append(b.reshape(-1, 4))
        return torch.cat(boxes, dim=0), torch.tensor(
            [0.1, 0.1, 0.2, 0.2], dtype=torch.float32, device=self.device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        b = x.shape[0]
        c = self.num_classes + 1
        f1 = self.b2(self.b1(self.stem(x)))
        f2 = self.b3(f1)
        cls = torch.cat([self.cls1(f1).reshape(b, -1, c),
                         self.cls2(f2).reshape(b, -1, c)], dim=1)
        loc = torch.cat([self.loc1(f1).reshape(b, -1, 4),
                         self.loc2(f2).reshape(b, -1, 4)], dim=1)
        return cls, loc


def ssd_match(priors, gt_boxes, gt_labels, num_boxes,
              overlap_threshold: float = 0.5,
              prior_var=(0.1, 0.1, 0.2, 0.2)):
    """One image's prior <-> gt matching. priors [P, 4]; gt_boxes [G, 4]
    (padded); gt_labels [G]; num_boxes (scalar) valid rows. Returns
    (conf_target [P] int64: 0 background, else label + 1; loc_target
    [P, 4] encoded deltas over the variances, 0 off the positives;
    pos_mask [P]). Each valid gt's best prior is forced positive."""
    dev = priors.device
    g = gt_boxes.shape[0]
    p = priors.shape[0]
    valid = torch.arange(g, device=dev) < torch.as_tensor(num_boxes,
                                                          device=dev)
    iou = D.iou_similarity(gt_boxes, priors)
    iou = torch.where(valid[:, None], iou, torch.zeros_like(iou))
    best_iou = torch.amax(iou, dim=0)
    best_gt = torch.argmax(iou, dim=0)
    best_prior = torch.argmax(iou, dim=1)
    zeros = torch.zeros(p, dtype=torch.int64, device=dev)
    forced = zeros.scatter_reduce(0, best_prior, valid.long(), "amax",
                                  include_self=True) > 0
    gt_ids = torch.where(valid, torch.arange(g, device=dev),
                         torch.zeros(g, dtype=torch.int64, device=dev))
    forced_gt = zeros.scatter_reduce(0, best_prior, gt_ids, "amax",
                                     include_self=True)
    pos = forced | (best_iou >= overlap_threshold)
    gt_idx = torch.where(forced, forced_gt, best_gt)
    matched_box = gt_boxes[gt_idx]
    matched_lbl = torch.as_tensor(gt_labels, device=dev).long()[gt_idx]
    conf_target = torch.where(pos, matched_lbl + 1, torch.zeros_like(
        matched_lbl))
    loc_target = D.encode_boxes_paired(priors, matched_box,
                                       box_normalized=True)
    loc_target = loc_target / torch.as_tensor(prior_var, dtype=torch.float32,
                                              device=dev)
    loc_target = torch.where(pos[:, None], loc_target,
                             torch.zeros_like(loc_target))
    return conf_target, loc_target, pos


def ssd_loss(cls_logits, loc, priors, gt_boxes, gt_labels, num_boxes,
             neg_pos_ratio: float = 3.0):
    """Batch SSD loss: softmax confidence loss over the positives and the
    OHEM-mined negatives, plus smooth-L1 on the positives' boxes, each
    over max(positives, 1); the mean over images."""
    losses = []
    for i in range(cls_logits.shape[0]):
        conf_t, loc_t, pos = ssd_match(priors, gt_boxes[i], gt_labels[i],
                                       num_boxes[i])
        ce = F.softmax_with_cross_entropy(cls_logits[i].float(), conf_t)
        neg = D.mine_hard_examples(ce, torch.where(pos, 0, -1),
                                   neg_pos_ratio)
        keep = pos | neg
        n_pos = torch.clamp(torch.sum(pos), min=1)
        conf_loss = torch.sum(torch.where(keep, ce, torch.zeros_like(ce)))
        l1 = F.smooth_l1(loc[i].float(), loc_t)
        loc_loss = torch.sum(torch.where(pos[:, None], l1,
                                         torch.zeros_like(l1)))
        losses.append(conf_loss / n_pos + loc_loss / n_pos)
    return torch.stack(losses).mean()


def ssd_detect(cls_logits, loc, priors, prior_var,
               score_threshold: float = 0.3, nms_threshold: float = 0.45,
               keep_top_k: int = 20):
    """Decode + multiclass NMS per image: ([B, keep_top_k, 6] rows
    (label, score, x1, y1, x2, y2), label -1 padding; [B] valid counts).
    Labels are dataset ids (the background slot removed)."""
    outs, counts = [], []
    for i in range(cls_logits.shape[0]):
        probs = torch.softmax(cls_logits[i].float(), dim=-1)
        boxes = D.box_coder(priors, prior_var, loc[i], code_type="decode")
        out, count = D.multiclass_nms(
            boxes, probs.T, score_threshold=score_threshold,
            nms_threshold=nms_threshold, keep_top_k=keep_top_k,
            background_label=0)
        lbl = out[:, 0]
        out = torch.cat([torch.where(lbl > 0, lbl - 1,
                                     torch.full_like(lbl, -1))[:, None],
                         out[:, 1:]], dim=1)
        outs.append(out)
        counts.append(count)
    return torch.stack(outs), torch.stack(counts)
